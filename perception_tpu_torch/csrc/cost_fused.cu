// Fused 1-NN + depth-only cost counts.
//
// Replaces nn_cost_fused_pallas (perception_tpu/ops/pallas_cost.py:221,
// kernel _cost_kernel at :38-97). Per pose: the minimum squared distance
// from each cloud point to the S observed targets (difference form), the
// lowest-index winner, and three counts: real points, unexplained real points
// (d^2 > res^2), and distinct targets won by a close real-or-explain-only
// point.
//
// What bounds it on the H100: the dense problem is the P x S distance sweep
// (1280 x 256 per pose at the scoring shapes, ~12 non-FMA instructions per
// pair; --fmad=false keeps every product rounded as in the twin); the inputs
// are ~25 MB and the output 24 KB (0.0075 ms at 3.35 TB/s). But the results
// are integer counts, and a point only needs the targets within res of it: a
// point farther than res from every target is unexplained whatever its
// winner. On the bench ~36% of the points are valid (cadd <= 0) and a target
// lies within res of a small box of consecutive valid points in a few
// percent of the dense pairs. So the design skips pairs instead of making
// each pair cheaper:
//   * one block per pose; the valid targets (tadd == 0) are compacted into
//     shared memory in ascending index order, each with its original index,
//     and the valid points (cadd <= 0) with their flags, in order, by warp
//     ballots and a prefix over the warps (point_num counts cadd == 0 over
//     all P on the way; each round's points load a round ahead). The points
//     stage in chunks of up to kChunk = 2048 (fewer when S leaves less
//     shared memory), each culled and scanned before the next, so any P
//     fits;
//   * a warp takes 32 consecutive compacted points, one per lane, as
//     32 / kGroup groups of kGroup lanes; each group's bounding box comes
//     from xor shuffles;
//   * per slice of 32 compacted targets, each lane tests its target against
//     every group box of the warp, and a ballot per group gives that group's
//     list of surviving targets for the slice as a bit mask; each lane then
//     scans its group's survivors, lowest bit first, with the difference form
//     and a strict '<', kScan survivors per step (their loads and distances
//     are independent; the updates keep their order). Slices ascend and bits
//     ascend, so every point sees its survivors in ascending index order, as
//     the dense scan does;
//   * a close point sets its winner's bit in a shared bit set of S bits
//     (atomicOr); all three results are integer counts.
//
// The cull is exact. Box test: g_a = max(lo_a - t_a, t_a - hi_a, 0) per axis
// and pass iff g_x*g_x + g_y*g_y + g_z*g_z <= res^2, in that float32 order.
// Its margin is zero, because the test is conservative by itself: for a point
// c of the box, lo_a <= c_a <= hi_a, so fl(lo_a - t_a) <= fl(c_a - t_a) =
// |fl(t_a - c_a)| when t_a < lo_a (round-to-nearest is monotone and odd), and
// likewise above hi_a; so g_a <= |dx_a| with dx_a the kernel's difference,
// and by monotone rounding every square and sum of the test is <= the
// kernel's own d = dx*dx + dy*dy + dz*dz. Any target with d <= res^2 passes.
// A point with dmin <= res^2 therefore keeps its lowest-index winner, and the
// scan of an ascending subset that holds the winner gives the same (dmin,
// winner); a point with dmin > res^2 has a subset minimum > res^2 as well: it
// stays unexplained and marks nothing. An invalid target (+inf additive)
// never wins the dense scan, so dropping it changes nothing.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                 // points per cull box
constexpr int kBoxes = 32 / kGroup;        // boxes per warp
constexpr int kScan = 4;                   // survivors per scan step
constexpr int kChunk = 8 * kThreads;       // points staged at a time, at most
constexpr size_t kMaxShared = 227 * 1024;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// Ordered block-wide compaction, one round of kThreads items: item
// base + tid is kept if `keep`. Returns its slot in the list (or -1) and adds
// the round's kept count to `total` in every thread. s_cnt holds 2 x kWarps
// ints, alternating by round, so one barrier per round suffices.
__device__ __forceinline__ int compact_slot(bool keep, int round, int& total,
                                            int* s_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = s_cnt + (round & 1) * kWarps;
  const unsigned m = __ballot_sync(kFull, keep);
  if (lane == 0) cnt[warp] = __popc(m);
  __syncthreads();
  int off = total, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? cnt[w] : 0;
    all += cnt[w];
  }
  total += all;
  return keep ? off + __popc(m & ((1u << lane) - 1u)) : -1;
}

__global__ void __launch_bounds__(kThreads) cost_fused_kernel(
    const float* __restrict__ cloud,   // [N, P, 3]
    const float* __restrict__ cadd,    // [N, P]: 0 real, -1 explain-only, inf invalid
    const float4* __restrict__ tgt,    // [N, S] (x, y, z, 0 or +inf)
    int P, int S, int chunk, float max_dist_sq,
    float* __restrict__ out) {         // [N, 3]
  extern __shared__ float4 s_tgt[];    // [S] compacted targets, w = index bits
  float4* s_pts = s_tgt + S;           // [chunk] compacted points, w = cadd
  unsigned* s_expl = reinterpret_cast<unsigned*>(s_pts + chunk);  // S bits
  __shared__ int s_cnt[2 * kWarps];
  __shared__ int s_red[3][kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* cp = cloud + (size_t)n * P * 3;
  const float* ca = cadd + (size_t)n * P;
  const int words = (S + 31) / 32;

  for (int w = tid; w < words; w += kThreads) s_expl[w] = 0u;
  int nt = 0, round = 0;
  for (int base = 0; base < S; base += kThreads, ++round) {
    const int s = base + tid;
    const float4 t = s < S ? tgt[(size_t)n * S + s]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int slot = compact_slot(s < S && t.w == 0.0f, round, nt, s_cnt);
    if (slot >= 0) s_tgt[slot] = make_float4(t.x, t.y, t.z, __int_as_float(s));
  }
  // Each round's points are loaded a round ahead, so the loads overlap the
  // compaction's barrier.
  auto load_point = [&](int p) {
    return p < P ? make_float4(cp[3 * p], cp[3 * p + 1], cp[3 * p + 2], ca[p])
                 : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  };
  const float inf = __int_as_float(0x7f800000);
  const int box = lane / kGroup;
  int point_num = 0, unexplained = 0;
  float4 next = load_point(tid);
  for (int c0 = 0; c0 < P; c0 += chunk) {
    // Stage the chunk's valid points, in order.
    int nv = 0;
    for (int base = c0; base < c0 + chunk && base < P;
         base += kThreads, ++round) {
      const float4 pt = next;
      next = load_point(base + kThreads + tid);
      point_num += pt.w == 0.0f;
      const int slot = compact_slot(pt.w <= 0.0f, round, nv, s_cnt);
      if (slot >= 0) s_pts[slot] = pt;
    }
    __syncthreads();

    for (int g0 = warp * 32; g0 < nv; g0 += kThreads) {
      const int i = g0 + lane;
      const bool have = i < nv;
      const float4 pt = have ? s_pts[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float cx = pt.x, cy = pt.y, cz = pt.z, flag = pt.w;
      // The group's box (fminf / fmaxf skip a NaN coordinate; an empty group
      // keeps +-inf and passes nothing).
      float lo[3] = {have ? cx : inf, have ? cy : inf, have ? cz : inf};
      float hi[3] = {have ? cx : -inf, have ? cy : -inf, have ? cz : -inf};
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
          hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
        }
      }
      float blo[kBoxes][3], bhi[kBoxes][3];
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          blo[b][a] = __shfl_sync(kFull, lo[a], b * kGroup);
          bhi[b][a] = __shfl_sync(kFull, hi[a], b * kGroup);
        }
      }

      float dmin = inf;
      int win = 0;
      for (int t0 = 0; t0 < nt; t0 += 32) {
        const bool in = t0 + lane < nt;
        const float4 t =
            in ? s_tgt[t0 + lane] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        unsigned mine = 0;
#pragma unroll
        for (int b = 0; b < kBoxes; ++b) {
          const float gx = fmaxf(fmaxf(blo[b][0] - t.x, t.x - bhi[b][0]), 0.0f);
          const float gy = fmaxf(fmaxf(blo[b][1] - t.y, t.y - bhi[b][1]), 0.0f);
          const float gz = fmaxf(fmaxf(blo[b][2] - t.z, t.z - bhi[b][2]), 0.0f);
          const bool pass = in && gx * gx + gy * gy + gz * gz <= max_dist_sq;
          const unsigned m = __ballot_sync(kFull, pass);
          if (b == box) mine = m;
        }
        // kScan survivors per step, lowest bits first: their distances are
        // independent, and the updates run in ascending order. A step past
        // the last survivor repeats it, which cannot pass the strict '<'.
        while (mine != 0u) {
          float4 u[kScan];
          int j = 0;
#pragma unroll
          for (int k = 0; k < kScan; ++k) {
            j = mine != 0u ? __ffs(mine) - 1 : j;
            mine &= mine - 1u;
            u[k] = s_tgt[t0 + j];
          }
#pragma unroll
          for (int k = 0; k < kScan; ++k) {
            const float dx = u[k].x - cx, dy = u[k].y - cy, dz = u[k].z - cz;
            // + 0 (a valid target's additive) would change no bit: d >= +0.
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < dmin) {
              dmin = d;
              win = __float_as_int(u[k].w);
            }
          }
        }
      }
      if (have) {
        if (flag == 0.0f && dmin > max_dist_sq) ++unexplained;
        if (dmin <= max_dist_sq) atomicOr(&s_expl[win >> 5], 1u << (win & 31));
      }
    }
    __syncthreads();   // the next chunk overwrites s_pts
  }

  int explained = 0;
  for (int w = tid; w < words; w += kThreads) explained += __popc(s_expl[w]);

  point_num = warp_sum(point_num);
  unexplained = warp_sum(unexplained);
  explained = warp_sum(explained);
  if (lane == 0) {
    s_red[0][warp] = point_num;
    s_red[1][warp] = unexplained;
    s_red[2][warp] = explained;
  }
  __syncthreads();
  if (tid < 3) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += s_red[tid][w];
    out[(size_t)n * 3 + tid] = (float)v;
  }
}

}  // namespace

// Dynamic shared memory: S compacted targets and `chunk` compacted points
// (16 B each) and S explained bits. The points stage in chunks of up to
// kChunk, fewer when the targets leave less room (at least one round of
// kThreads); any P fits.
extern "C" int pt_cost_fused(const float* cloud, const float* cadd,
                             const float* tgt4, int N, int P, int S,
                             float max_dist_sq, float* out, void* stream) {
  if (N == 0) return 0;
  const size_t fixed = (size_t)S * 16 + (size_t)(S + 31) / 32 * 4;
  const size_t room = fixed < kMaxShared ? (kMaxShared - fixed) / 16 : 0;
  const int rounds = (P + kThreads - 1) / kThreads;
  const int chunk = (int)std::min<size_t>(
      {(size_t)std::max(rounds, 1) * kThreads, (size_t)kChunk,
       room / kThreads * kThreads});
  if (chunk < kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)chunk * 16;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cost_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cost_fused_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      cloud, cadd, reinterpret_cast<const float4*>(tgt4), P, S, chunk,
      max_dist_sq, out);
  return (int)cudaGetLastError();
}
