// Fused point-to-plane ICP: the whole Gauss-Newton refinement of one pose in
// one block.
//
// Replaces icp_fused_pallas in point-to-plane mode
// (perception_tpu/ops/pallas_icp.py:632, kernel _icp_kernel at :69-553).
// Per association sweep: the expanded-form squared distance
// max(|t|^2 + tadd - 2 t.c + |c|^2, 0) from each source point to the S
// cropped targets, and a packed (distance, index) min. Then the plane
// (n, n.t) of the winner, the 21 + 6 normal-equation sums, trace-scaled LM
// damping, an unrolled 6x6 Cholesky, the Rodrigues step and compose,
// best-RMSE tracking, and the step-norm and stagnation exits.
//
// What bounds it on the H100: the association sweep, P x S = 64 K distance
// evaluations of ~8 flops per pose and sweep (~11 GFLOP for 2048 poses and
// 10 sweeps), and the serial per-iteration solve. The simple design:
//   * one block per pose, 256 threads (one per source point at P = 256);
//   * the targets (S x 32 bytes, 8 KB at S = 256) sit in shared memory as
//     association rows (-2t, |t|^2 + tadd) and plane rows (n, n.t), so the
//     winner's plane is an exact f32 read from shared memory (the TPU
//     kernel's bf16 hi/lo one-hot recovery is not needed);
//   * the association of each point is cached in shared memory for the
//     iterations that do not re-associate (nn_every > 1);
//   * the 29 sums reduce by warp shuffles, then one thread solves, updates
//     the pose state and broadcasts it through shared memory; the block
//     leaves its loop when its pose is done or at max_iterations.
// Built with --fmad=false so the association rounds as in the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;   // 21 upper-triangle H, 6 g, count, sum w e^2

struct PoseState {
  float cur[12];    // current transform: rotation row-major, then t
  float best[12];   // best-so-far transform (the output)
  float best_rmse;
  float streak;
  float done;
  int k;            // global iteration; max_iterations once done
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// One Gauss-Newton update of the pose state from the reduced sums, as the
// TPU kernel's per-iteration tail (pallas_icp.py:401-531) for one pose.
__device__ void solve_and_update(const float* sums, PoseState& st,
                                 int max_iterations, float damping,
                                 float rot_eps_sq, float trn_eps_sq,
                                 float stagnation_streak) {
  float h[6][6];
  float g[6];
  int q = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) h[i][j] = sums[q++];
  }
  for (int i = 0; i < 6; ++i) g[i] = -sums[21 + i];
  const float count = sums[27];
  const float res2 = sums[28];

  const bool ok = count >= 6.0f;
  const bool active = st.done < 0.5f;
  const float rmse = sqrtf(res2 / fmaxf(count, 1.0f));
  const float old_best = st.best_rmse;
  if (ok && rmse < old_best && active) {
    st.best_rmse = rmse;
    for (int i = 0; i < 12; ++i) st.best[i] = st.cur[i];
  }

  const float trace = h[0][0] + h[1][1] + h[2][2] + h[3][3] + h[4][4] + h[5][5];
  const float lam = damping * trace / 6.0f + 1e-9f;
  for (int i = 0; i < 6; ++i) h[i][i] = h[i][i] + lam;
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

  // Compose R' = E R, t' = E t + u; frozen once done.
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
    }
    for (int i = 0; i < 12; ++i) st.cur[i] = nxt[i];
  }

  const float rot_n2 = wx * wx + wy * wy + wz * wz;
  const float trn_n2 = xi[3] * xi[3] + xi[4] * xi[4] + xi[5] * xi[5];
  const bool step_small = rot_n2 < rot_eps_sq && trn_n2 < trn_eps_sq;
  const bool improved_sig = rmse < old_best - 1e-6f;
  float streak = improved_sig ? 0.0f : st.streak + 1.0f;
  if (!active) streak = st.streak;
  st.streak = streak;
  const bool done_now = step_small || streak >= stagnation_streak || !ok;
  if (active && done_now) st.done = 1.0f;
  st.k = st.done > 0.5f ? max_iterations : st.k + 1;
}

__global__ void __launch_bounds__(kThreads) icp_fused_kernel(
    const float* __restrict__ src,    // [N, P, 3]
    const float* __restrict__ sadd,   // [N, P]: 0 valid, +inf invalid
    const float* __restrict__ tgt,    // [N, S, 8] pack_targets rows
    int P, int S, int max_iterations, float max_corr_sq, float damping,
    int nn_every, float rot_eps_sq, float trn_eps_sq, float stagnation_streak,
    int idx_mask, float* __restrict__ out) {   // [N, 4, 4]
  extern __shared__ float4 smem4[];
  float4* s_tab = smem4;                          // (-2t, |t|^2 + tadd)
  float4* s_plane = smem4 + S;                    // (n, n.t)
  float* s_assoc = reinterpret_cast<float*>(smem4 + 2 * S);   // [5][P]
  __shared__ float s_red[kWarps][kSums];
  __shared__ float s_sums[kSums];
  __shared__ PoseState st;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* tg = tgt + (size_t)n * S * 8;
  for (int s = tid; s < S; s += kThreads) {
    const float tx = tg[8 * s], ty = tg[8 * s + 1], tz = tg[8 * s + 2];
    s_tab[s] = make_float4(-2.0f * tx, -2.0f * ty, -2.0f * tz,
                           tx * tx + ty * ty + tz * tz + tg[8 * s + 7]);
    s_plane[s] = make_float4(tg[8 * s + 3], tg[8 * s + 4], tg[8 * s + 5],
                             tg[8 * s + 6]);
  }
  if (tid == 0) {
    for (int i = 0; i < 12; ++i) {
      const float v = (i == 0 || i == 4 || i == 8) ? 1.0f : 0.0f;
      st.cur[i] = v;
      st.best[i] = v;
    }
    st.best_rmse = __int_as_float(0x7f800000);
    st.streak = 0.0f;
    st.done = 0.0f;
    st.k = 0;
  }
  __syncthreads();

  const float* sp = src + (size_t)n * P * 3;
  const float* sa = sadd + (size_t)n * P;
  while (true) {
    const int k = st.k;
    if (k >= max_iterations) break;
    const float* c = st.cur;
    const float r00 = c[0], r01 = c[1], r02 = c[2];
    const float r10 = c[3], r11 = c[4], r12 = c[5];
    const float r20 = c[6], r21 = c[7], r22 = c[8];
    const float t0 = c[9], t1 = c[10], t2 = c[11];
    const bool assoc_now = nn_every <= 1 || (k % nn_every) == 0;

    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
    for (int p = tid; p < P; p += kThreads) {
      const float sx = sp[3 * p], sy = sp[3 * p + 1], sz = sp[3 * p + 2];
      const float cx = r00 * sx + r01 * sy + r02 * sz + t0;
      const float cy = r10 * sx + r11 * sy + r12 * sz + t1;
      const float cz = r20 * sx + r21 * sy + r22 * sz + t2;
      float nx, ny, nz, nq, dmin;
      if (assoc_now) {
        const float cc = cx * cx + cy * cy + cz * cz;
        int pmin = 0x7fffffff;
        for (int s = 0; s < S; ++s) {
          const float4 tb = s_tab[s];
          const float d = fmaxf(tb.w + tb.x * cx + tb.y * cy + tb.z * cz + cc,
                                0.0f);
          pmin = min(pmin, (__float_as_int(d) & ~idx_mask) | s);
        }
        const float4 pl = s_plane[pmin & idx_mask];
        nx = pl.x;
        ny = pl.y;
        nz = pl.z;
        nq = pl.w;
        dmin = __int_as_float(pmin & ~idx_mask);
        s_assoc[p] = nx;
        s_assoc[P + p] = ny;
        s_assoc[2 * P + p] = nz;
        s_assoc[3 * P + p] = nq;
        s_assoc[4 * P + p] = dmin;
      } else {
        nx = s_assoc[p];
        ny = s_assoc[P + p];
        nz = s_assoc[2 * P + p];
        nq = s_assoc[3 * P + p];
        dmin = s_assoc[4 * P + p];
      }
      const float w = (dmin + sa[p]) <= max_corr_sq ? 1.0f : 0.0f;
      const float e = nx * cx + ny * cy + nz * cz - nq;
      const float js[6] = {cy * nz - cz * ny, cz * nx - cx * nz,
                           cx * ny - cy * nx, nx, ny, nz};
      int q = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) acc[q++] += js[i] * js[j] * w;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += js[i] * e * w;
      acc[27] += w;
      acc[28] += e * e * w;
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      const float v = warp_sum(acc[q]);
      if (lane == 0) s_red[warp][q] = v;
    }
    __syncthreads();
    if (tid < kSums) {
      float v = s_red[0][tid];
      for (int w = 1; w < kWarps; ++w) v += s_red[w][tid];
      s_sums[tid] = v;
    }
    __syncthreads();
    if (tid == 0) {
      solve_and_update(s_sums, st, max_iterations, damping, rot_eps_sq,
                       trn_eps_sq, stagnation_streak);
    }
    __syncthreads();
  }

  if (tid < 16) {
    const int r = tid / 4, col = tid % 4;
    float v;
    if (r == 3) {
      v = col == 3 ? 1.0f : 0.0f;
    } else {
      v = col == 3 ? st.best[9 + r] : st.best[3 * r + col];
    }
    out[(size_t)n * 16 + tid] = v;
  }
}

}  // namespace

extern "C" int pt_icp_fused(const float* src, const float* sadd,
                            const float* tgt, int N, int P, int S,
                            int max_iterations, float max_corr_sq,
                            float damping, int nn_every, float rot_eps_sq,
                            float trn_eps_sq, float stagnation_streak,
                            int idx_mask, float* out, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)S * 2 * sizeof(float4) + (size_t)P * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        icp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  icp_fused_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      src, sadd, tgt, P, S, max_iterations, max_corr_sq, damping, nn_every,
      rot_eps_sq, trn_eps_sq, stagnation_streak, idx_mask, out);
  return (int)cudaGetLastError();
}
