// Fused ICP: the whole Gauss-Newton refinement of one pose in one block, in
// four cost modes and with fixed-period or adaptive association.
//
// Replaces icp_fused_pallas (perception_tpu/ops/pallas_icp.py:632, kernel
// _icp_kernel at :69-553) in all its modes:
//   p2p    point-to-plane (d2d_epsilon = 0);
//   d2d    plane + tangential split of the GICP weighting: 9 point-to-point
//          sums beside the plane terms, weight wpp = eps / (1 - eps), the
//          rotation centred on the correspondence centroid (:248-262, :347-381);
//   sym    d2d plus the plane of the source normal rotated by the current
//          estimate, wpp doubled (:382-400);
//   exact  the full 3x3 Mahalanobis Gauss-Newton of icp_gicp_batch: per point
//          W = inv(2I - (1-eps)(nt nt^T + ns' ns'^T)) by adjugate, H = J^T W J,
//          Marquardt damping (:263-330, :413-424).
// Per association sweep: the expanded-form squared distance
// max(|t|^2 + tadd - 2 t.c + |c|^2, 0) from each source point to the cropped
// targets and a packed (bits(d) & ~idx_mask) | index min, whose winner and
// quantised distance are cached for the iterations that do not
// re-associate. Then the normal-equation sums, damping, an unrolled 6x6
// Cholesky, the Rodrigues step and compose, best-RMSE tracking, and the
// step-norm and stagnation exits.
//
// Adaptive association (nn_every = 0) re-associates when some active pose of
// the pose's group of 8 (poses 8*floor(i/8) ... +7, as the TPU kernel's
// _GROUP) has moved more than assoc_trigger since the group's last sweep. The
// group is a thread-block cluster of 8: each block publishes its masked motion
// bound and done flag in shared memory, and every block reads the 8 values
// through distributed shared memory between two cluster barriers per
// iteration. Done blocks skip the work but keep joining the barriers until
// the whole group is done; the blocks past N (the grid is rounded up to 8)
// count as done from the start.
//
// What bounds it on the H100. The dense work is the association sweep, P x S
// distance evaluations of ~10 non-FMA instructions per pose and sweep (5.3
// sweeps per pose in p2p, 10.3 in exact on the bench), then per iteration
// the per-point terms (~120 flops in p2p, ~330 in exact), a reduction of 29
// to 71 sums and a serial solve (Cholesky, float64 sin / cos, compose) of a
// few thousand cycles of latency, ~10 iterations per pose and up to 20. On
// the bench a third of the poses has no valid source and about half of the
// sources of the others are valid, so only ~35% of the dense pairs can
// matter. The design:
//   * the valid sources (sadd finite) are compacted once per pose into an
//     index list, and the valid targets (tadd below the pack's invalid
//     additive 1e30) into rows j < nt of association (-2t, |t|^2 + tadd)
//     and plane (n, n.t) values, both in order, by warp ballots. The key
//     packs the row j instead of the target index: rows keep the targets'
//     order, so the min key names the same target as the dense key, whose
//     min over any subset that holds the winner is the dense min (a valid
//     target always beats an invalid one, d ~ 1e30). The d2d modes take
//     the winner's point as -0.5 * (-2t), which is t exactly, so no point
//     rows are kept: 32 (S + 1) + 8 P bytes of shared memory per pose;
//   * a sweep runs only valid x valid pairs, register-blocked: each thread
//     holds KQ = ceil(nv / threads) <= 4 compacted sources, so one
//     shared-memory read of a target row feeds KQ independent distance
//     chains and the sources take one pass for nv <= 4 x threads (256);
//   * the cache holds the winner's row and quantised distance per source,
//     in the source's own slot; invalid sources, and valid ones without a
//     valid target, keep the placeholder set at block start: the zero row
//     nt and distance +inf. Their weight is 0 as the dense association's
//     (an invalid winner has d ~ 1e30), and every term is a product with
//     the weight, so each adds a signed zero to a sum that starts at +0:
//     no bit of any sum changes;
//   * the per-point stages read each source a round ahead of its use;
//   * two warps per pose (kWarps = 2, 64 threads instead of 256): the
//     terms stage keeps one point per thread and round (p = tid, tid + 64,
//     ...), the sums reduce by warp shuffles and one add of the two warp
//     sums, and thread 0 solves. 6 to 12 poses are resident per SM (their
//     registers bound it), so a 2048-pose batch runs in two to three waves
//     instead of eight.
// Measured on the H100 (PERF.md): the dense sweep at the same two warps per
// pose (the previous kernel at 64 threads) takes 1.3-1.7x this design's
// time in every mode; the block shape alone does not give the gain. With
// only valid pairs swept, the kernel is bound by the latency of its longest
// poses, not by its instruction rate.
// Per pose an iteration is mostly the sweep, then the serial solve of thread
// 0, then the terms and their reduction; the poses that run all 20
// iterations finish long after the mean pose while the SMs idle. One warp
// per pose fits every pose in one wave but leaves a long pose a single warp;
// four warps cut the poses resident per SM; two warps were the fastest in
// the served modes (exact, p2p) and within a few percent in d2d and sym.
// The twin (ops/icp_fused.py, _kernel_order_sum) sums in this order: each of
// the 32 * kWarps threads adds its points in turn, the warp's lanes combine
// by shuffles at offsets 16, 8, 4, 2, 1, then the warp sums in order.
// Built with --fmad=false so every sum rounds as in the PyTorch twin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;   // warps per pose (the twin's _THREADS / 32)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxKQ = 4;   // sources per thread in a sweep, at most
constexpr int kGroup = 8;   // poses per adaptive-association group
constexpr float kInvalidAdd = 1e30f;   // pack_targets' additive of invalid targets

enum Mode { kP2P = 0, kD2D = 1, kSym = 2, kExact = 3 };

// Per-point sums: 0-20 upper-triangle H, 21-26 g (negated by the solve),
// 27 count, 28 sum w res^2; d2d adds 29-37 the point-to-point moments
// (ax^2, ay^2, az^2, ax ay, ax az, ay az, ax, ay, az) and 38-43 the
// (a x r, r) gradient terms; sym adds 44-64 its plane H and 65-70 its g.
template <int M>
struct Sums {
  static constexpr int value = M == kSym ? 71 : (M == kD2D ? 44 : 29);
};

struct Job {
  const float* src;    // [N, P, 3]
  const float* snrm;   // [N, P, 3] source normals (sym, exact) or null
  const float* sadd;   // [N, P]: 0 valid, +inf invalid
  const float* tgt;    // [N, S, 8] pack_targets rows
  float* out;          // [N, 4, 4]
  int N, P, S, max_iterations, nn_every, idx_mask;
  float max_corr_sq, damping, rot_eps_sq, trn_eps_sq, stagnation_streak;
  float wpp;           // tangential weight (doubled in sym)
  float ome;           // 1 - eps
  float damp1;         // 1 + damping (Marquardt)
  float assoc_trigger;
};

struct PoseState {
  float cur[12];    // current transform: rotation row-major, then t
  float best[12];   // best-so-far transform (the output)
  float best_rmse;
  float streak;
  float done;
  float accum;      // adaptive: motion bound since the group's last sweep
  float cen[3];     // d2d: correspondence centroid of this iteration
  float ext;        // adaptive: max |a| over the points
  int need;         // adaptive: the group re-associates this iteration
  int stop;         // adaptive: the whole group is done
  int nv;           // valid (compacted) sources
  int nt;           // valid (compacted) targets
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// Block sum of K per-thread values in the twin's order: a warp-shuffle tree,
// then the warp sums in order. Thread 0 writes the K totals to s_out; s_red
// holds kWarps * K floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&acc)[K], float* s_red,
                                          float* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = warp_sum(acc[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) s_red[warp * K + q] = acc[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < K; ++q) {
      float v = s_red[q];
      for (int w = 1; w < kWarps; ++w) v += s_red[w * K + q];
      s_out[q] = v;
    }
  }
}

// Ordered compaction by warp 0: the indices i < n with keep(i), ascending,
// through emit(slot, i). Returns the count (in warp 0's lanes).
template <class Keep, class Emit>
__device__ __forceinline__ int compact(int n, Keep keep, Emit emit) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool k = i < n && keep(i);
    const unsigned m = __ballot_sync(kFull, k);
    if (k) emit(count + __popc(m & ((1u << lane) - 1u)), i);
    count += __popc(m);
  }
  return count;
}

// One source point's inputs (and normal, with NORMALS), loaded a round
// ahead of its use so the global-memory latency hides behind the round
// before it.
template <bool NORMALS>
struct SourceStream {
  const float *sp, *sn, *sa;
  int P;
  float x = 0.0f, y = 0.0f, z = 0.0f, a = 0.0f;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  __device__ SourceStream(const float* sp_, const float* sn_, const float* sa_,
                          int P_)
      : sp(sp_), sn(sn_), sa(sa_), P(P_) {
    load(threadIdx.x);
  }
  __device__ __forceinline__ void load(int p) {
    if (p < P) {
      x = sp[3 * p];
      y = sp[3 * p + 1];
      z = sp[3 * p + 2];
      a = sa[p];
      if (NORMALS) {
        nx = sn[3 * p];
        ny = sn[3 * p + 1];
        nz = sn[3 * p + 2];
      }
    }
  }
};

// One association pass over the compacted sources base + k * kThreads + tid
// (k < KQ) against every compacted target row j: the packed min of
// (bits(d) & ~idx_mask) | j per source, then its winner's row and quantised
// distance into the cache. The rows keep the targets' order, so the
// compacted index breaks ties as the original one does.
template <int KQ>
__device__ __forceinline__ void sweep(int base, int nv, int nt,
                                      const unsigned short* s_src,
                                      const float* sp, const float (&r)[12],
                                      const float4* s_tab, int idx_mask,
                                      unsigned short* s_win, float* s_dmin) {
  float cx[KQ], cy[KQ], cz[KQ], cc[KQ];
  int p[KQ], pmin[KQ];
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int i = base + k * kThreads + (int)threadIdx.x;
    p[k] = i < nv ? s_src[i] : -1;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (p[k] >= 0) {
      sx = sp[3 * p[k]];
      sy = sp[3 * p[k] + 1];
      sz = sp[3 * p[k] + 2];
    }
    cx[k] = r[0] * sx + r[1] * sy + r[2] * sz + r[9];
    cy[k] = r[3] * sx + r[4] * sy + r[5] * sz + r[10];
    cz[k] = r[6] * sx + r[7] * sy + r[8] * sz + r[11];
    cc[k] = cx[k] * cx[k] + cy[k] * cy[k] + cz[k] * cz[k];
    pmin[k] = 0x7fffffff;
  }
#pragma unroll 4
  for (int j = 0; j < nt; ++j) {
    const float4 tb = s_tab[j];
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const float d = fmaxf(
          tb.w + tb.x * cx[k] + tb.y * cy[k] + tb.z * cz[k] + cc[k], 0.0f);
      pmin[k] = min(pmin[k], (__float_as_int(d) & ~idx_mask) | j);
    }
  }
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    if (p[k] >= 0) {
      s_win[p[k]] = (unsigned short)(pmin[k] & idx_mask);
      s_dmin[p[k]] = __int_as_float(pmin[k] & ~idx_mask);
    }
  }
}

// One Gauss-Newton update of the pose state from the reduced sums, as the
// TPU kernel's per-iteration tail (pallas_icp.py:401-531) for one pose.
template <int M, bool ADAPTIVE>
__device__ void solve_and_update(const float* sums, PoseState& st,
                                 const Job& jb) {
  float h[6][6];
  float g[6];
  int q = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) h[i][j] = sums[q++];
  }
  for (int i = 0; i < 6; ++i) g[i] = -sums[21 + i];
  const float count = sums[27];
  const float res2 = sums[28];
  if (M == kD2D || M == kSym) {
    // Tangential half of the D2D cost (pallas_icp.py:361-380).
    const float wpp = jb.wpp;
    const float cxs = sums[29], cys = sums[30], czs = sums[31];
    const float cxy = sums[32], cxz = sums[33], cyz = sums[34];
    const float sx = sums[35], sy = sums[36], sz = sums[37];
    h[0][0] = h[0][0] + wpp * (cys + czs);
    h[0][1] = h[0][1] + wpp * (-cxy);
    h[0][2] = h[0][2] + wpp * (-cxz);
    h[0][4] = h[0][4] + wpp * (-sz);
    h[0][5] = h[0][5] + wpp * sy;
    h[1][1] = h[1][1] + wpp * (cxs + czs);
    h[1][2] = h[1][2] + wpp * (-cyz);
    h[1][3] = h[1][3] + wpp * sz;
    h[1][5] = h[1][5] + wpp * (-sx);
    h[2][2] = h[2][2] + wpp * (cxs + cys);
    h[2][3] = h[2][3] + wpp * (-sy);
    h[2][4] = h[2][4] + wpp * sx;
    h[3][3] = h[3][3] + wpp * count;
    h[4][4] = h[4][4] + wpp * count;
    h[5][5] = h[5][5] + wpp * count;
    for (int i = 0; i < 6; ++i) g[i] = g[i] + (-wpp) * sums[38 + i];
    if (M == kSym) {
      q = 44;
      for (int i = 0; i < 6; ++i) {
        for (int j = i; j < 6; ++j) h[i][j] = h[i][j] + sums[q++];
      }
      for (int i = 0; i < 6; ++i) g[i] = g[i] + (-sums[65 + i]);
    }
  }

  const bool ok = count >= 6.0f;
  const bool active = st.done < 0.5f;
  const float rmse = sqrtf(res2 / fmaxf(count, 1.0f));
  const float old_best = st.best_rmse;
  if (ok && rmse < old_best && active) {
    st.best_rmse = rmse;
    for (int i = 0; i < 12; ++i) st.best[i] = st.cur[i];
  }

  if (M == kExact) {
    // Marquardt diagonal scaling (pallas_icp.py:413-418).
    for (int i = 0; i < 6; ++i) h[i][i] = h[i][i] * jb.damp1 + 1e-9f;
  } else {
    const float trace =
        h[0][0] + h[1][1] + h[2][2] + h[3][3] + h[4][4] + h[5][5];
    const float lam = jb.damping * trace / 6.0f + 1e-9f;
    for (int i = 0; i < 6; ++i) h[i][i] = h[i][i] + lam;
  }
  if (!ok) {   // identity system: xi = 0
    for (int i = 0; i < 6; ++i) {
      for (int j = i; j < 6; ++j) h[i][j] = i == j ? 1.0f : 0.0f;
      g[i] = 0.0f;
    }
  }

  // Unrolled Cholesky; the upper triangle holds the symmetric entries.
  float l[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = h[j][j];
    for (int k = 0; k < j; ++k) s = s - l[j][k] * l[j][k];
    l[j][j] = sqrtf(fmaxf(s, 1e-20f));
    const float inv = 1.0f / l[j][j];
    for (int i = j + 1; i < 6; ++i) {
      s = h[j][i];
      for (int k = 0; k < j; ++k) s = s - l[i][k] * l[j][k];
      l[i][j] = s * inv;
    }
  }
  float y[6], xi[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - l[k][i] * xi[k];
    xi[i] = s / l[i][i];
  }

  // SO(3) exp of (xi0, xi1, xi2) by Rodrigues, small-angle branch below
  // theta^2 = 1e-12. sin and cos are taken in double and rounded to float,
  // so they round alike on every device (the twin does the same).
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(fmaxf(theta2, 1e-24f));
  const float sin_t = (float)sin((double)theta);
  const float cos_t = (float)cos((double)theta);
  float a = sin_t / theta;
  float b = (1.0f - cos_t) / fmaxf(theta2, 1e-24f);
  if (theta2 < 1e-12f) {
    a = 1.0f;
    b = 0.5f;
  }
  float e[9];
  e[0] = 1.0f - b * (wy * wy + wz * wz);
  e[1] = -a * wz + b * wx * wy;
  e[2] = a * wy + b * wx * wz;
  e[3] = a * wz + b * wx * wy;
  e[4] = 1.0f - b * (wx * wx + wz * wz);
  e[5] = -a * wx + b * wy * wz;
  e[6] = -a * wy + b * wx * wz;
  e[7] = a * wx + b * wy * wz;
  e[8] = 1.0f - b * (wx * wx + wy * wy);

  // Compose R' = E R, t' = E t + u (+ cen - E cen about the centroid);
  // frozen once done.
  if (active) {
    float nxt[12];
    const float* c = st.cur;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        nxt[3 * i + j] = e[3 * i] * c[j] + e[3 * i + 1] * c[3 + j] +
                         e[3 * i + 2] * c[6 + j];
      }
      nxt[9 + i] = e[3 * i] * c[9] + e[3 * i + 1] * c[10] +
                   e[3 * i + 2] * c[11] + xi[3 + i];
      if (M != kP2P) {
        nxt[9 + i] = nxt[9 + i] + st.cen[i] -
                     (e[3 * i] * st.cen[0] + e[3 * i + 1] * st.cen[1] +
                      e[3 * i + 2] * st.cen[2]);
      }
    }
    for (int i = 0; i < 12; ++i) st.cur[i] = nxt[i];
  }

  const float rot_n2 = wx * wx + wy * wy + wz * wz;
  const float trn_n2 = xi[3] * xi[3] + xi[4] * xi[4] + xi[5] * xi[5];
  if (ADAPTIVE && active) {
    // Point-motion bound of this step: rotation about the frame of a times
    // the lever arm, plus the translation (pallas_icp.py:511-520).
    st.accum = st.accum + (theta * st.ext + sqrtf(trn_n2));
  }
  const bool step_small = rot_n2 < jb.rot_eps_sq && trn_n2 < jb.trn_eps_sq;
  const bool improved_sig = rmse < old_best - 1e-6f;
  float streak = improved_sig ? 0.0f : st.streak + 1.0f;
  if (!active) streak = st.streak;
  st.streak = streak;
  const bool done_now = step_small || streak >= jb.stagnation_streak || !ok;
  if (active && done_now) st.done = 1.0f;
}

template <int M, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads) icp_fused_kernel(const Job jb) {
  constexpr int NS = Sums<M>::value;
  constexpr bool kPoint = M != kP2P;   // the d2d modes read the winner's point
  const int P = jb.P, S = jb.S;
  // Compacted target rows j < nt, in the targets' order, and a zero row nt
  // (the placeholder): association (-2t, |t|^2 + tadd) and plane (n, n.t).
  // The d2d modes take the winner's point t as -0.5 * (-2t), exactly.
  extern __shared__ float4 smem4[];
  float4* s_tab = smem4;                              // [S + 1]
  float4* s_plane = smem4 + (S + 1);                  // [S + 1]
  float* s_dmin = reinterpret_cast<float*>(s_plane + (S + 1));   // [P]
  unsigned short* s_win =                             // [P] cached row
      reinterpret_cast<unsigned short*>(s_dmin + P);
  unsigned short* s_src = s_win + P;                  // [P] valid sources
  __shared__ float s_red[kWarps * NS];
  __shared__ float s_sums[NS];
  __shared__ float s_ext[kWarps];
  __shared__ float s_pub[2];                      // adaptive: (bound, done)
  __shared__ PoseState st;

  const int n = blockIdx.x;
  const bool real = n < jb.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const float* sp = jb.src + (size_t)n * P * 3;
  const float* sn = jb.snrm + (size_t)n * P * 3;   // read in sym / exact only
  const float* sa = jb.sadd + (size_t)n * P;
  const float* tg = jb.tgt + (size_t)n * S * 8;
  if (warp == 0) {
    int nt = 0, nv = 0;
    if (real) {
      nt = compact(
          S, [&](int s) { return tg[8 * s + 7] < kInvalidAdd; },
          [&](int slot, int s) {
            const float tx = tg[8 * s], ty = tg[8 * s + 1], tz = tg[8 * s + 2];
            s_tab[slot] = make_float4(-2.0f * tx, -2.0f * ty, -2.0f * tz,
                                      tx * tx + ty * ty + tz * tz + tg[8 * s + 7]);
            s_plane[slot] = make_float4(tg[8 * s + 3], tg[8 * s + 4],
                                        tg[8 * s + 5], tg[8 * s + 6]);
          });
      nv = compact(
          P, [&](int p) { return sa[p] < inf; },
          [&](int slot, int p) { s_src[slot] = (unsigned short)p; });
    }
    if (lane == 0) {
      s_tab[nt] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s_plane[nt] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = 0; i < 12; ++i) {
        const float v = (i == 0 || i == 4 || i == 8) ? 1.0f : 0.0f;
        st.cur[i] = v;
        st.best[i] = v;
      }
      st.best_rmse = inf;
      st.streak = 0.0f;
      st.done = real ? 0.0f : 1.0f;
      st.accum = 0.0f;
      st.cen[0] = st.cen[1] = st.cen[2] = 0.0f;
      st.ext = 0.0f;
      st.nt = nt;
      st.nv = nv;
    }
  }
  __syncthreads();
  const int nv = st.nv, nt = st.nt;
  for (int p = tid; p < P; p += kThreads) {
    s_win[p] = (unsigned short)nt;
    s_dmin[p] = inf;
  }
  __syncthreads();

  const int idx_mask = jb.idx_mask;
  for (int k = 0;; ++k) {
    bool assoc_now;
    if constexpr (ADAPTIVE) {
      cg::cluster_group cluster = cg::this_cluster();
      if (tid == 0) {
        s_pub[0] = st.accum * (1.0f - st.done);
        s_pub[1] = st.done;
      }
      cluster.sync();
      if (tid == 0) {
        float mx = 0.0f;
        bool all_done = true;
        for (int r = 0; r < kGroup; ++r) {
          const float* pub = cluster.map_shared_rank(s_pub, r);
          mx = r == 0 ? pub[0] : fmaxf(mx, pub[0]);
          all_done = all_done && pub[1] > 0.5f;
        }
        st.stop = all_done || k >= jb.max_iterations;
        st.need = k == 0 || mx > jb.assoc_trigger;
        if (st.need) st.accum = 0.0f;
      }
      cluster.sync();
      if (st.stop) break;
      if (st.done > 0.5f) continue;
      assoc_now = st.need;
    } else {
      if (st.done > 0.5f || k >= jb.max_iterations) break;
      assoc_now = jb.nn_every <= 1 || (k % jb.nn_every) == 0;
    }
    float c[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) c[i] = st.cur[i];
    const float r00 = c[0], r01 = c[1], r02 = c[2];
    const float r10 = c[3], r11 = c[4], r12 = c[5];
    const float r20 = c[6], r21 = c[7], r22 = c[8];
    const float t0 = c[9], t1 = c[10], t2 = c[11];

    // Association: valid sources x valid targets, KQ <= 4 sources per
    // thread, the fewest passes and then the fewest idle slots.
    if (assoc_now && nt > 0) {
      for (int base = 0; base < nv;) {
        const int kq = min(kMaxKQ, (nv - base + kThreads - 1) / kThreads);
        switch (kq) {
#define PT_SWEEP(KQ)                                                      \
  case KQ:                                                                \
    sweep<KQ>(base, nv, nt, s_src, sp, c, s_tab, idx_mask, s_win, s_dmin); \
    break;
          PT_SWEEP(1) PT_SWEEP(2) PT_SWEEP(3) PT_SWEEP(4)
#undef PT_SWEEP
        }
        base += kq * kThreads;
      }
    }
    __syncthreads();

    // d2d modes, pass 1: weights and the correspondence centroid
    // (pallas_icp.py:248-262).
    float cenx = 0.0f, ceny = 0.0f, cenz = 0.0f;
    if constexpr (kPoint) {
      float acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      SourceStream<false> next(sp, sn, sa, P);
      for (int p = tid; p < P; p += kThreads) {
        const SourceStream<false> cur = next;
        next.load(p + kThreads);
        const float sx = cur.x, sy = cur.y, sz = cur.z;
        const float cx = r00 * sx + r01 * sy + r02 * sz + t0;
        const float cy = r10 * sx + r11 * sy + r12 * sz + t1;
        const float cz = r20 * sx + r21 * sy + r22 * sz + t2;
        const float w = (s_dmin[p] + cur.a) <= jb.max_corr_sq ? 1.0f : 0.0f;
        acc4[0] += w;
        acc4[1] += cx * w;
        acc4[2] += cy * w;
        acc4[3] += cz * w;
      }
      block_sum<4>(acc4, s_red, s_sums);
      if (tid == 0) {
        const float inv_cnt = 1.0f / fmaxf(s_sums[0], 1.0f);
        st.cen[0] = s_sums[1] * inv_cnt;
        st.cen[1] = s_sums[2] * inv_cnt;
        st.cen[2] = s_sums[3] * inv_cnt;
      }
      __syncthreads();
      cenx = st.cen[0];
      ceny = st.cen[1];
      cenz = st.cen[2];
    }

    float acc[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) acc[q] = 0.0f;
    float ext2 = 0.0f;
    SourceStream<M == kSym || M == kExact> next(sp, sn, sa, P);
    for (int p = tid; p < P; p += kThreads) {
      const auto cur = next;
      next.load(p + kThreads);
      const float sx = cur.x, sy = cur.y, sz = cur.z;
      const float cx = r00 * sx + r01 * sy + r02 * sz + t0;
      const float cy = r10 * sx + r11 * sy + r12 * sz + t1;
      const float cz = r20 * sx + r21 * sy + r22 * sz + t2;
      const int win = s_win[p];
      const float4 pl = s_plane[win];
      const float nx = pl.x, ny = pl.y, nz = pl.z, nq = pl.w;
      const float w = (s_dmin[p] + cur.a) <= jb.max_corr_sq ? 1.0f : 0.0f;
      const float ax = cx - cenx, ay = cy - ceny, az = cz - cenz;
      if (ADAPTIVE) ext2 = fmaxf(ext2, ax * ax + ay * ay + az * az);
      float rx = 0.0f, ry = 0.0f, rz = 0.0f;
      float nsx = 0.0f, nsy = 0.0f, nsz = 0.0f;
      if constexpr (kPoint) {
        const float4 tb = s_tab[win];
        rx = cx - tb.x * -0.5f;
        ry = cy - tb.y * -0.5f;
        rz = cz - tb.z * -0.5f;
      }
      if (M == kSym || M == kExact) {
        const float snx = cur.nx, sny = cur.ny, snz = cur.nz;
        nsx = r00 * snx + r01 * sny + r02 * snz;
        nsy = r10 * snx + r11 * sny + r12 * snz;
        nsz = r20 * snx + r21 * sny + r22 * snz;
      }
      if constexpr (M == kExact) {
        // Full-covariance weight M = w inv(C), C = 2I - (1-eps)(nt nt^T +
        // ns' ns'^T), by the symmetric adjugate (pallas_icp.py:268-330).
        const float ome = jb.ome;
        const float c00 = 2.0f - ome * (nx * nx + nsx * nsx);
        const float c01 = -ome * (nx * ny + nsx * nsy);
        const float c02 = -ome * (nx * nz + nsx * nsz);
        const float c11 = 2.0f - ome * (ny * ny + nsy * nsy);
        const float c12 = -ome * (ny * nz + nsy * nsz);
        const float c22 = 2.0f - ome * (nz * nz + nsz * nsz);
        const float co00 = c11 * c22 - c12 * c12;
        const float co01 = c02 * c12 - c01 * c22;
        const float co02 = c01 * c12 - c02 * c11;
        const float co11 = c00 * c22 - c02 * c02;
        const float co12 = c01 * c02 - c00 * c12;
        const float co22 = c00 * c11 - c01 * c01;
        const float det = c00 * co00 + c01 * co01 + c02 * co02;
        const float invd = w / fmaxf(det, 1e-20f);
        const float m00 = co00 * invd, m01 = co01 * invd, m02 = co02 * invd;
        const float m11 = co11 * invd, m12 = co12 * invd, m22 = co22 * invd;
        // u_j = M col_j for the jacobian columns J = [-[a]x | I].
        const float us[6][3] = {
            {-az * m01 + ay * m02, -az * m11 + ay * m12, -az * m12 + ay * m22},
            {az * m00 - ax * m02, az * m01 - ax * m12, az * m02 - ax * m22},
            {-ay * m00 + ax * m01, -ay * m01 + ax * m11, -ay * m02 + ax * m12},
            {m00, m01, m02},
            {m01, m11, m12},
            {m02, m12, m22}};
        auto dot_col = [&](int i, float vx, float vy, float vz) {
          if (i == 0) return -az * vy + ay * vz;
          if (i == 1) return az * vx - ax * vz;
          if (i == 2) return -ay * vx + ax * vy;
          return i == 3 ? vx : (i == 4 ? vy : vz);
        };
        int q = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) {
            acc[q++] += dot_col(i, us[j][0], us[j][1], us[j][2]);
          }
        }
        const float wrx = m00 * rx + m01 * ry + m02 * rz;
        const float wry = m01 * rx + m11 * ry + m12 * rz;
        const float wrz = m02 * rx + m12 * ry + m22 * rz;
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += dot_col(i, wrx, wry, wrz);
        acc[27] += w;
        const float res2 = rx * wrx + ry * wry + rz * wrz;
        acc[28] += res2 * w;
      } else {
        const float e = nx * cx + ny * cy + nz * cz - nq;
        const float js[6] = {ay * nz - az * ny, az * nx - ax * nz,
                             ax * ny - ay * nx, nx, ny, nz};
        int q = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) acc[q++] += js[i] * js[j] * w;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += js[i] * e * w;
        acc[27] += w;
        float res2 = e * e;
        if constexpr (M == kD2D || M == kSym) {
          acc[29] += ax * ax * w;
          acc[30] += ay * ay * w;
          acc[31] += az * az * w;
          acc[32] += ax * ay * w;
          acc[33] += ax * az * w;
          acc[34] += ay * az * w;
          acc[35] += ax * w;
          acc[36] += ay * w;
          acc[37] += az * w;
          acc[38] += (ay * rz - az * ry) * w;
          acc[39] += (az * rx - ax * rz) * w;
          acc[40] += (ax * ry - ay * rx) * w;
          acc[41] += rx * w;
          acc[42] += ry * w;
          acc[43] += rz * w;
          res2 = res2 + jb.wpp * (rx * rx + ry * ry + rz * rz);
          if constexpr (M == kSym) {
            const float e2 = nsx * rx + nsy * ry + nsz * rz;
            const float ks[6] = {ay * nsz - az * nsy, az * nsx - ax * nsz,
                                 ax * nsy - ay * nsx, nsx, nsy, nsz};
            int qs = 44;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
#pragma unroll
              for (int j = i; j < 6; ++j) acc[qs++] += ks[i] * ks[j] * w;
            }
#pragma unroll
            for (int i = 0; i < 6; ++i) acc[65 + i] += ks[i] * e2 * w;
            res2 = res2 + e2 * e2;
          }
        }
        acc[28] += res2 * w;
      }
    }
    block_sum<NS>(acc, s_red, s_sums);
    if (ADAPTIVE) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ext2 = fmaxf(ext2, __shfl_down_sync(kFull, ext2, off));
      }
      if (lane == 0) s_ext[warp] = ext2;
      __syncthreads();
    }
    if (tid == 0) {
      if (ADAPTIVE) {
        float m = s_ext[0];
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_ext[w]);
        st.ext = sqrtf(m);
      }
      st.cen[0] = cenx;
      st.cen[1] = ceny;
      st.cen[2] = cenz;
      solve_and_update<M, ADAPTIVE>(s_sums, st, jb);
    }
    __syncthreads();
  }

  if (real && tid < 16) {
    const int r = tid / 4, col = tid % 4;
    float v;
    if (r == 3) {
      v = col == 3 ? 1.0f : 0.0f;
    } else {
      v = col == 3 ? st.best[9 + r] : st.best[3 * r + col];
    }
    jb.out[(size_t)n * 16 + tid] = v;
  }
}

// Dynamic shared memory at (S, P): the compacted association and plane
// rows with their zero row, the per-source cache (distance, row) and the
// valid-source list.
size_t shared_bytes(int S, int P) {
  return (size_t)(S + 1) * 32 + (size_t)P * 8;
}

template <int M, bool ADAPTIVE>
int run(const Job& jb, cudaStream_t stream) {
  auto kernel = icp_fused_kernel<M, ADAPTIVE>;
  const size_t smem = shared_bytes(jb.S, jb.P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (!ADAPTIVE) {
    kernel<<<jb.N, kThreads, smem, stream>>>(jb);
    return (int)cudaGetLastError();
  }
  // One cluster of 8 blocks per pose group; the grid rounds N up to 8.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((jb.N + kGroup - 1) / kGroup * kGroup);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kGroup;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, jb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 p2p, 1 d2d, 2 sym, 3 exact; nn_every = 0 selects adaptive
// association. snrm may be null unless mode is 2 or 3.
extern "C" int pt_icp_fused(const float* src, const float* snrm,
                            const float* sadd, const float* tgt, int N, int P,
                            int S, int mode, int max_iterations,
                            float max_corr_sq, float damping, int nn_every,
                            float rot_eps_sq, float trn_eps_sq,
                            float stagnation_streak, int idx_mask, float wpp,
                            float ome, float damp1, float assoc_trigger,
                            float* out, void* stream) {
  if (N == 0) return 0;
  const Job jb = {src, snrm, sadd, tgt, out, N, P, S, max_iterations,
                  nn_every, idx_mask, max_corr_sq, damping, rot_eps_sq,
                  trn_eps_sq, stagnation_streak, wpp, ome, damp1,
                  assoc_trigger};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool adaptive = nn_every == 0;
  switch (mode) {
    case kP2P: return adaptive ? run<kP2P, true>(jb, st) : run<kP2P, false>(jb, st);
    case kD2D: return adaptive ? run<kD2D, true>(jb, st) : run<kD2D, false>(jb, st);
    case kSym: return adaptive ? run<kSym, true>(jb, st) : run<kSym, false>(jb, st);
    case kExact:
      return adaptive ? run<kExact, true>(jb, st) : run<kExact, false>(jb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
