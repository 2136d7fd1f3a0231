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
// What bounds it on the H100: the dense problem is the P x S distance sweep
// (1280 x 256 per pose at the scoring shapes, ~9 flops a pair, ~6 GFLOP for
// 2048 poses) plus one CIEDE2000 (~160 flops, seven of them float64 sin /
// cos / exp) per close real point, ~245 per pose; the inputs are ~25 MB. As
// in cost_fused.cu, a point needs its winner only when it lies within res of
// a target, so the design runs the compacted, group-box-culled sweep of
// cost_cull.cuh (valid targets and points compacted in order, 16-point group
// boxes culled per 32-target slice by ballots, survivors scanned 4 per step)
// and gates each close real point on its winner in the sweep's epilogue:
//   * one block per pose; the compacted targets, the staged points, the
//     targets' Lab at their original index (S x 12 B), for the face-id form
//     the pose's model Lab row (T x 12 B: the block loads it itself, in place
//     of the TPU's scalar prefetch), and the explained targets as an S-bit
//     set sit in shared memory; the points stage in chunks sized from the
//     room these leave, so any P runs;
//   * a staged point carries its original index p (w = p real, ~p
//     explain-only). After the scan, a real point with dmin > res^2 is
//     unexplained; a close explain-only point sets its winner's bit; a close
//     real point reads its rendered Lab, cloud_lab[n, p] or
//     s_blab[tri_id[n, p]] (zeros for an id outside [0, T)), and evaluates
//     CIEDE2000 against its winner's exact float32 Lab (the TPU recovers it
//     from a bf16 hi/lo one-hot product, exact to ~2^-16): a pass sets the
//     winner's bit (atomicOr), a fail counts the point as unexplained;
//   * CIEDE2000 follows ops/color.py ciede2000_components operation by
//     operation (polynomial atan2, conditional mod 2pi, integer powers as
//     square-and-multiply products); sin / cos / exp are taken in double and
//     rounded once, sqrt and division are IEEE. Built with --fmad=false, the
//     PyTorch twin in ops/cost_fused_color.py rounds at the same places.
//
// The counts equal the dense kernel's. The cull keeps, for a close point
// (dmin <= res^2), every target at distance <= res^2 (cost_cull.cuh's
// argument), so every target that ties its dense minimum survives, and the
// ascending scan with a strict '<' keeps the lowest-index one: the dense
// winner. The gate therefore sees the dense (winner Lab, rendered Lab) pair
// and gives the dense verdict. A far point is unexplained whatever its
// winner, and an explain-only point passes without a colour, so neither
// needs the gate.

#include "cost_cull.cuh"

namespace {

using namespace cost_cull;

constexpr float kPi = 3.141592653589793f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPiEps = 3.1416026535897933f;   // pi + 1e-5
constexpr float kPow25_7 = 6103515625.0f;
constexpr float kDeg30 = 0.5235987755982988f;
constexpr float kDeg6 = 0.10471975511965977f;
constexpr float kDeg63 = 1.0995574287564276f;

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
    int P, int S, int T, int chunk, float max_dist_sq, float thresh,
    float* __restrict__ out) {            // [N, 3]
  extern __shared__ float4 s_tgt[];       // [S] compacted targets, w = index bits
  float4* s_pts = s_tgt + S;              // [chunk] compacted points, w = p / ~p
  float* s_tlab = reinterpret_cast<float*>(s_pts + chunk);   // [S, 3]
  float* s_blab = s_tlab + 3 * S;                            // [T, 3]
  unsigned* s_expl =                                         // S bits
      reinterpret_cast<unsigned*>(s_blab + (kTri ? 3 * T : 0));
  __shared__ int s_cnt[2 * kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  for (int w = tid; w < (S + 31) / 32; w += kThreads) s_expl[w] = 0u;
  for (int i = tid; i < 3 * S; i += kThreads) {
    s_tlab[i] = tgt_lab[(size_t)n * S * 3 + i];
  }
  if (kTri) {
    const float* row = bank_lab + (size_t)model_ids[n] * T * 3;
    for (int i = tid; i < 3 * T; i += kThreads) s_blab[i] = row[i];
  }
  // The sweep's barriers order these stores before the epilogue's reads.
  int round = 0;
  const int nt = stage_targets(tgt + (size_t)n * S, S, s_tgt, s_cnt, round);
  int unexplained = 0;
  const int point_num = sweep(
      cloud + (size_t)n * P * 3, cadd + (size_t)n * P, P, chunk, max_dist_sq,
      s_tgt, nt, s_pts, s_cnt, round, [&](int w, float dmin, int win) {
        if (dmin > max_dist_sq) {
          if (w >= 0) ++unexplained;
          return;
        }
        bool ok = w < 0;   // an explain-only point passes without a colour
        if (!ok) {
          float l2 = 0.0f, a2 = 0.0f, b2 = 0.0f;
          if (kTri) {
            const int f = tri_id[(size_t)n * P + w];
            if (f >= 0 && f < T) {
              l2 = s_blab[3 * f];
              a2 = s_blab[3 * f + 1];
              b2 = s_blab[3 * f + 2];
            }
          } else {
            const float* lab = cloud_lab + ((size_t)n * P + w) * 3;
            l2 = lab[0];
            a2 = lab[1];
            b2 = lab[2];
          }
          const float de = ciede2000(s_tlab[3 * win], s_tlab[3 * win + 1],
                                     s_tlab[3 * win + 2], l2, a2, b2);
          ok = de <= thresh;
        }
        if (ok) {
          atomicOr(&s_expl[win >> 5], 1u << (win & 31));
        } else {
          ++unexplained;
        }
      });
  write_counts(point_num, unexplained, s_expl, S, out + (size_t)n * 3);
}

// Dynamic shared memory: S compacted targets (16 B each), `chunk` staged
// points (16 B each), the targets' Lab (12 B each), the model Lab row in the
// face-id form (12 B per face) and S explained bits. The points stage in
// chunks of up to kChunk, fewer when the rest leaves less room (at least one
// round of kThreads); any P fits.
template <bool kTri>
int launch_color(const float* cloud, const float* cadd, const float* cloud_lab,
                 const int* tri_id, const int* model_ids, const float* bank_lab,
                 const float* tgt4, const float* tgt_lab, int N, int P, int S,
                 int T, float max_dist_sq, float thresh, float* out,
                 void* stream) {
  if (N == 0) return 0;
  const size_t fixed = (size_t)S * (16 + 12) + (kTri ? (size_t)T * 12 : 0) +
                       (size_t)(S + 31) / 32 * 4;
  const int chunk = chunk_points(fixed, P);
  if (chunk < kThreads) return (int)cudaErrorInvalidValue;
  return launch(cost_fused_color_kernel<kTri>, N, fixed + (size_t)chunk * 16,
                stream, cloud, cadd, cloud_lab, tri_id, model_ids, bank_lab,
                reinterpret_cast<const float4*>(tgt4), tgt_lab, P, S, T, chunk,
                max_dist_sq, thresh, out);
}

}  // namespace

extern "C" int pt_cost_fused_color(const float* cloud, const float* cadd,
                                   const float* cloud_lab, const float* tgt4,
                                   const float* tgt_lab, int N, int P, int S,
                                   float max_dist_sq, float thresh, float* out,
                                   void* stream) {
  return launch_color<false>(cloud, cadd, cloud_lab, nullptr, nullptr,
                             nullptr, tgt4, tgt_lab, N, P, S, 0, max_dist_sq,
                             thresh, out, stream);
}

extern "C" int pt_cost_fused_color_tri(const float* cloud, const float* cadd,
                                       const int* tri_id, const int* model_ids,
                                       const float* bank_lab, const float* tgt4,
                                       const float* tgt_lab, int N, int P,
                                       int S, int T, float max_dist_sq,
                                       float thresh, float* out,
                                       void* stream) {
  return launch_color<true>(cloud, cadd, nullptr, tri_id, model_ids, bank_lab,
                            tgt4, tgt_lab, N, P, S, T, max_dist_sq, thresh,
                            out, stream);
}
