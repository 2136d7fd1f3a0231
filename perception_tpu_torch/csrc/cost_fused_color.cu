// Fused 1-NN + cost counts with the CIEDE2000 colour gate (cost types 1 / 3).
//
// Replaces two TPU kernels of perception_tpu/ops/pallas_cost.py, both built
// on _cost_kernel_color (:100-209):
//   * nn_cost_fused_color_pallas (:274): the rendered Lab of each cloud point
//     comes with the cloud ([N, P, 3], full-frame path);
//   * nn_cost_fused_color_tri_pallas (:361): the rendered Lab is looked up
//     from the winning face id, bank_lab[model_ids[n], tri_id[p]] ([M, T, 3],
//     ROI path); an id of -1 (explain-only or invalid point) reads (0, 0, 0).
// Per pose: the minimum squared distance from each cloud point to the S
// observed targets (difference form, +inf additive for invalid targets), the
// lowest-index winner w, and three counts:
//   point_num   = real points (cadd == 0);
//   unexplained = real points with d^2 > res^2, plus close points whose
//                 colour fails the gate (close = d^2 <= res^2 and cadd <= 0);
//   explained   = distinct targets won by a close point that passes the gate
//                 (CIEDE2000(tgt_lab[w], cloud_lab[p]) <= thresh, or the point
//                 is an explain-only sample, cadd == -1).
//
// What bounds it on the H100: the P x S distance sweep (1280 x 256 per pose at
// the scoring shapes, ~9 flops a pair, ~6 GFLOP for 2048 poses); one
// CIEDE2000 (~150 flops) per close point adds ~0.4 GFLOP. The design, one
// templated kernel for both entry points:
//   * one block per pose; targets (x, y, z, additive) as float4, their Lab,
//     the S-byte "explained" flags and, for the face-id form, the pose's
//     model Lab row (T x 3 floats: the block loads it itself, in place of the
//     TPU's scalar prefetch) sit in shared memory;
//   * each point keeps a running minimum with a strict '<' (the lowest index
//     attaining it, as the TPU kernel's pass 2), then evaluates the gate
//     against its winner's exact float32 Lab (the TPU recovers it from a bf16
//     hi/lo one-hot product, exact to ~2^-16);
//   * CIEDE2000 follows ops/color.py ciede2000_components operation by
//     operation (polynomial atan2, conditional mod 2pi, integer powers as
//     square-and-multiply products); sin / cos / exp are taken in double and
//     rounded once, sqrt and division are IEEE. Built with --fmad=false, the
//     PyTorch twin in ops/cost_fused_color.py rounds at the same places.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr float kPi = 3.141592653589793f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPiEps = 3.1416026535897933f;   // pi + 1e-5
constexpr float kPow25_7 = 6103515625.0f;
constexpr float kDeg30 = 0.5235987755982988f;
constexpr float kDeg6 = 0.10471975511965977f;
constexpr float kDeg63 = 1.0995574287564276f;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float sin_r(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos_r(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float exp_r(float x) { return (float)exp((double)x); }
__device__ __forceinline__ float pow2(float x) { return x * x; }
__device__ __forceinline__ float pow7(float x) {
  const float x2 = x * x;
  return (x * x2) * (x2 * x2);
}

__device__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float z = mn / fmaxf(mx, 1e-30f);
  const float z2 = z * z;
  float acc = z2 * -0.01172120f;
  acc = z2 * (0.05265332f + acc);
  acc = z2 * (-0.11643287f + acc);
  acc = z2 * (0.19354346f + acc);
  acc = z2 * (-0.33262347f + acc);
  float a = z * (0.99997726f + acc);
  if (ay > ax) a = kHalfPi - a;
  if (x < 0.0f) a = kPi - a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float mod2pi(float v) {
  return v >= kTwoPi ? v - kTwoPi : v;
}

// CIEDE2000 of (l1, a1, b1) (the observed winner) and (l2, a2, b2) (the
// rendered point), in the operation order of ciede2000_components.
__device__ float ciede2000(float l1, float a1, float b1,
                           float l2, float a2, float b2) {
  float c1 = sqrtf(pow2(a1) + pow2(b1));
  float c2 = sqrtf(pow2(a2) + pow2(b2));
  float mean_c7 = pow7((c1 + c2) / 2.0f);
  const float g = 0.5f * (1.0f - sqrtf(mean_c7 / (mean_c7 + kPow25_7)));
  const float a1p = a1 * (1.0f + g);
  const float a2p = a2 * (1.0f + g);
  c1 = sqrtf(pow2(a1p) + pow2(b1));
  c2 = sqrtf(pow2(a2p) + pow2(b2));
  const float h1 = mod2pi(atan2_poly(b1, a1p) + kTwoPi);
  const float h2 = mod2pi(atan2_poly(b2, a2p) + kTwoPi);

  const float delta_l = l2 - l1;
  const float delta_c = c2 - c1;
  const float dh = h2 - h1;
  const float delta_h_angle =
      fabsf(dh) <= kPi ? dh : (h2 > h1 ? dh - kTwoPi : dh + kTwoPi);
  const float delta_hh = (2.0f * sqrtf(c1 * c2)) * sin_r(delta_h_angle / 2.0f);

  const float mean_l = (l1 + l2) / 2.0f;
  const float mean_c = (c1 + c2) / 2.0f;
  mean_c7 = pow7(mean_c);
  const float hs = h1 + h2;
  const float mean_h = fabsf(h1 - h2) <= kPiEps
                           ? hs / 2.0f
                           : (hs < kTwoPi ? (hs + kTwoPi) / 2.0f
                                          : (hs - kTwoPi) / 2.0f);

  const float t = 1.0f - 0.17f * cos_r(mean_h - kDeg30) +
                  0.24f * cos_r(2.0f * mean_h) +
                  0.32f * cos_r(3.0f * mean_h + kDeg6) -
                  0.2f * cos_r(4.0f * mean_h - kDeg63);
  const float ml2 = pow2(mean_l - 50.0f);
  const float sl = 1.0f + (0.015f * ml2) / sqrtf(20.0f + ml2);
  const float sc = 1.0f + 0.045f * mean_c;
  const float sh = 1.0f + (0.015f * mean_c) * t;
  const float rc = 2.0f * sqrtf(mean_c7 / (mean_c7 + kPow25_7));
  const float hdeg = ((mean_h / kPi) * 180.0f - 275.0f) / 25.0f;
  const float theta = ((60.0f * exp_r(-pow2(hdeg))) * kPi) / 180.0f;
  const float rt = -sin_r(theta) * rc;

  const float dl = delta_l / sl;
  const float dc = delta_c / sc;
  const float dhh = delta_hh / sh;
  return sqrtf(pow2(dl) + pow2(dc) + pow2(dhh) + (rt * dc) * dhh);
}

// kTri = false: cloud_lab [N, P, 3]. kTri = true: tri_id [N, P] int32,
// model_ids [N] int32 and bank_lab [M, T, 3].
template <bool kTri>
__global__ void __launch_bounds__(kThreads) cost_fused_color_kernel(
    const float* __restrict__ cloud,      // [N, P, 3]
    const float* __restrict__ cadd,       // [N, P]: 0 real, -1 explain-only, inf invalid
    const float* __restrict__ cloud_lab,  // [N, P, 3] (Lab form)
    const int* __restrict__ tri_id,       // [N, P] (face-id form)
    const int* __restrict__ model_ids,    // [N] (face-id form)
    const float* __restrict__ bank_lab,   // [M, T, 3] (face-id form)
    const float4* __restrict__ tgt,       // [N, S] (x, y, z, 0 or +inf)
    const float* __restrict__ tgt_lab,    // [N, S, 3]
    int P, int S, int T, float max_dist_sq, float thresh,
    float* __restrict__ out) {            // [N, 3]
  extern __shared__ float4 s_tgt[];
  float* s_tlab = reinterpret_cast<float*>(s_tgt + S);       // [S, 3]
  float* s_blab = s_tlab + 3 * S;                            // [T, 3]
  unsigned char* s_expl =
      reinterpret_cast<unsigned char*>(s_blab + (kTri ? 3 * T : 0));
  __shared__ int s_red[3][kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += kThreads) {
    s_tgt[s] = tgt[(size_t)n * S + s];
    s_expl[s] = 0;
  }
  for (int i = tid; i < 3 * S; i += kThreads) {
    s_tlab[i] = tgt_lab[(size_t)n * S * 3 + i];
  }
  if (kTri) {
    const float* row = bank_lab + (size_t)model_ids[n] * T * 3;
    for (int i = tid; i < 3 * T; i += kThreads) s_blab[i] = row[i];
  }
  __syncthreads();

  int point_num = 0, unexplained = 0;
  const float* cp = cloud + (size_t)n * P * 3;
  const float* ca = cadd + (size_t)n * P;
  for (int p = tid; p < P; p += kThreads) {
    const float cx = cp[3 * p], cy = cp[3 * p + 1], cz = cp[3 * p + 2];
    float dmin = __int_as_float(0x7f800000);
    int win = 0;
    for (int s = 0; s < S; ++s) {
      const float4 t = s_tgt[s];
      const float dx = t.x - cx, dy = t.y - cy, dz = t.z - cz;
      const float d = dx * dx + dy * dy + dz * dz + t.w;
      if (d < dmin) {
        dmin = d;
        win = s;
      }
    }
    const float flag = ca[p];
    if (flag == 0.0f) {
      ++point_num;
      if (dmin > max_dist_sq) ++unexplained;
    }
    if (flag <= 0.0f && dmin <= max_dist_sq) {
      bool ok = flag == -1.0f;
      if (!ok) {
        float l2 = 0.0f, a2 = 0.0f, b2 = 0.0f;
        if (kTri) {
          const int f = tri_id[(size_t)n * P + p];
          if (f >= 0 && f < T) {
            l2 = s_blab[3 * f];
            a2 = s_blab[3 * f + 1];
            b2 = s_blab[3 * f + 2];
          }
        } else {
          const float* lab = cloud_lab + ((size_t)n * P + p) * 3;
          l2 = lab[0];
          a2 = lab[1];
          b2 = lab[2];
        }
        const float de = ciede2000(s_tlab[3 * win], s_tlab[3 * win + 1],
                                   s_tlab[3 * win + 2], l2, a2, b2);
        ok = de <= thresh;
      }
      if (ok) {
        s_expl[win] = 1;
      } else {
        ++unexplained;
      }
    }
  }
  __syncthreads();

  int explained = 0;
  for (int s = tid; s < S; s += kThreads) explained += s_expl[s];

  const int lane = tid & 31, warp = tid >> 5;
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

template <bool kTri>
int launch(const float* cloud, const float* cadd, const float* cloud_lab,
           const int* tri_id, const int* model_ids, const float* bank_lab,
           const float* tgt4, const float* tgt_lab, int N, int P, int S, int T,
           float max_dist_sq, float thresh, float* out, void* stream) {
  if (N == 0) return 0;
  const size_t smem = (size_t)S * (sizeof(float4) + 3 * sizeof(float)) +
                      (kTri ? (size_t)T * 3 * sizeof(float) : 0) + (size_t)S;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cost_fused_color_kernel<kTri>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cost_fused_color_kernel<kTri><<<N, kThreads, smem, (cudaStream_t)stream>>>(
      cloud, cadd, cloud_lab, tri_id, model_ids, bank_lab,
      reinterpret_cast<const float4*>(tgt4), tgt_lab, P, S, T, max_dist_sq,
      thresh, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pt_cost_fused_color(const float* cloud, const float* cadd,
                                   const float* cloud_lab, const float* tgt4,
                                   const float* tgt_lab, int N, int P, int S,
                                   float max_dist_sq, float thresh, float* out,
                                   void* stream) {
  return launch<false>(cloud, cadd, cloud_lab, nullptr, nullptr, nullptr, tgt4,
                       tgt_lab, N, P, S, 0, max_dist_sq, thresh, out, stream);
}

extern "C" int pt_cost_fused_color_tri(const float* cloud, const float* cadd,
                                       const int* tri_id, const int* model_ids,
                                       const float* bank_lab, const float* tgt4,
                                       const float* tgt_lab, int N, int P,
                                       int S, int T, float max_dist_sq,
                                       float thresh, float* out,
                                       void* stream) {
  return launch<true>(cloud, cadd, nullptr, tri_id, model_ids, bank_lab, tgt4,
                      tgt_lab, N, P, S, T, max_dist_sq, thresh, out, stream);
}
