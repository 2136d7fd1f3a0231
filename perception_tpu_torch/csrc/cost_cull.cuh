// The compacted, group-box-culled nearest-target sweep shared by the two cost
// kernels (cost_fused.cu, cost_fused_color.cu): per pose, for every valid
// cloud point, the minimum squared distance to the valid observed targets
// (difference form) and the lowest-index winner, where a point needs them
// only if that minimum is <= res^2. Each kernel hands the sweep its own
// per-point epilogue.
//
// The design (one block of kThreads per pose):
//   * the valid targets (w == 0) are compacted into shared memory in
//     ascending index order, each with its original index, and the valid
//     points (cadd <= 0) in order, by warp ballots and a prefix over the
//     warps; a staged point carries its original index p in w, as p for a
//     real point (cadd == 0) and ~p for an explain-only one (cadd == -1).
//     point_num counts cadd == 0 over all P on the way; each round's points
//     load a round ahead. The points stage in chunks of up to kChunk (fewer
//     when the kernel's other shared memory leaves less room, at least one
//     round of kThreads), each culled and scanned before the next, so any P
//     runs;
//   * a warp takes 32 consecutive compacted points, one per lane, as
//     32 / kGroup groups of kGroup lanes; each group's bounding box comes
//     from xor shuffles;
//   * per slice of 32 compacted targets, each lane tests its target against
//     every group box of the warp, and a ballot per group gives that group's
//     surviving targets for the slice as a bit mask; each lane then scans its
//     group's survivors, lowest bit first, with the difference form and a
//     strict '<', kScan survivors per step (their loads and distances are
//     independent; the updates keep their order). Slices ascend and bits
//     ascend, so every point sees its survivors in ascending index order, as
//     the dense scan does;
//   * then the epilogue, epi(w, dmin, winner), once per staged point.
//
// The cull is exact. Box test: g_a = max(lo_a - t_a, t_a - hi_a, 0) per axis
// and pass iff g_x*g_x + g_y*g_y + g_z*g_z <= res^2, in that float32 order.
// Its margin is zero, because the test is conservative by itself: for a point
// c of the box, lo_a <= c_a <= hi_a, so fl(lo_a - t_a) <= fl(c_a - t_a) =
// |fl(t_a - c_a)| when t_a < lo_a (round-to-nearest is monotone and odd), and
// likewise above hi_a; so g_a <= |dx_a| with dx_a the kernel's difference,
// and by monotone rounding every square and sum of the test is <= the
// kernel's own d = dx*dx + dy*dy + dz*dz. Any target with d <= res^2 passes.
// A point with dmin <= res^2 therefore keeps every target that attains its
// dense minimum, the lowest-index one among them, and the scan of an
// ascending subset that holds it gives the same (dmin, winner) as the dense
// scan; a point with dmin > res^2 has a subset minimum > res^2 as well (its
// winner is then meaningless and the epilogues do not read it). An invalid
// target (+inf additive) never wins the dense scan, so dropping it changes
// nothing.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace cost_cull {

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

// The pose's valid targets of tgt [S] (x, y, z, 0 or +inf), compacted in
// order into s_tgt with w = their original index bits. Returns their count.
__device__ __forceinline__ int stage_targets(const float4* __restrict__ tgt,
                                             int S, float4* s_tgt, int* s_cnt,
                                             int& round) {
  int nt = 0;
  for (int base = 0; base < S; base += kThreads, ++round) {
    const int s = base + threadIdx.x;
    const float4 t = s < S ? tgt[s] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int slot = compact_slot(s < S && t.w == 0.0f, round, nt, s_cnt);
    if (slot >= 0) s_tgt[slot] = make_float4(t.x, t.y, t.z, __int_as_float(s));
  }
  return nt;
}

// The sweep over the pose's P points (cloud cp [P, 3], flags ca [P]: 0 real,
// -1 explain-only, inf invalid) against its nt compacted targets, staged
// `chunk` points at a time in s_pts; epi(w, dmin, winner) per valid point
// (w = p real, ~p explain-only; winner = original target index). Returns
// this thread's share of point_num. Ends with a barrier.
template <class Epilogue>
__device__ __forceinline__ int sweep(const float* __restrict__ cp,
                                     const float* __restrict__ ca, int P,
                                     int chunk, float max_dist_sq,
                                     const float4* s_tgt, int nt,
                                     float4* s_pts, int* s_cnt, int round,
                                     Epilogue&& epi) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // Each round's points are loaded a round ahead, so the loads overlap the
  // compaction's barrier.
  auto load_point = [&](int p) {
    return p < P ? make_float4(cp[3 * p], cp[3 * p + 1], cp[3 * p + 2], ca[p])
                 : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  };
  const float inf = __int_as_float(0x7f800000);
  const int box = lane / kGroup;
  int point_num = 0;
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
      const int p = base + tid;
      if (slot >= 0) {
        s_pts[slot] = make_float4(pt.x, pt.y, pt.z,
                                  __int_as_float(pt.w == 0.0f ? p : ~p));
      }
    }
    __syncthreads();

    for (int g0 = warp * 32; g0 < nv; g0 += kThreads) {
      const int i = g0 + lane;
      const bool have = i < nv;
      const float4 pt = have ? s_pts[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float cx = pt.x, cy = pt.y, cz = pt.z;
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
      if (have) epi(__float_as_int(pt.w), dmin, win);
    }
    __syncthreads();   // the next chunk overwrites s_pts
  }
  return point_num;
}

// The three counts of the block into out[0..2]: point_num and unexplained
// summed over the threads, explained = the set bits of the S-bit set s_expl.
// Call after the sweep's final barrier.
__device__ __forceinline__ void write_counts(int point_num, int unexplained,
                                             const unsigned* s_expl, int S,
                                             float* __restrict__ out) {
  __shared__ int s_red[3][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int explained = 0;
  for (int w = tid; w < (S + 31) / 32; w += kThreads) {
    explained += __popc(s_expl[w]);
  }
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
    out[tid] = (float)v;
  }
}

// Points staged per chunk when `fixed` bytes of dynamic shared memory are
// taken by the rest: up to kChunk and no more than P needs, a whole number
// of rounds of kThreads; 0 if not even one round fits.
inline int chunk_points(size_t fixed, int P) {
  const size_t room = fixed < kMaxShared ? (kMaxShared - fixed) / 16 : 0;
  const int rounds = (P + kThreads - 1) / kThreads;
  const size_t chunk = std::min<size_t>(
      {(size_t)std::max(rounds, 1) * kThreads, (size_t)kChunk,
       room / kThreads * kThreads});
  return (int)chunk;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it exceeds the default 48 KB.
template <class Kernel, class... Args>
int launch(Kernel kernel, int N, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace cost_cull
