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
// each pair cheaper: the compacted, group-box-culled sweep of cost_cull.cuh
// (its note gives the design and why the cull is exact), whose epilogue here
// counts a real point with dmin > res^2 as unexplained and sets a close
// point's winner in a shared bit set of S bits (atomicOr); all three results
// are integer counts.

#include "cost_cull.cuh"

namespace {

using namespace cost_cull;

__global__ void __launch_bounds__(kThreads) cost_fused_kernel(
    const float* __restrict__ cloud,   // [N, P, 3]
    const float* __restrict__ cadd,    // [N, P]: 0 real, -1 explain-only, inf invalid
    const float4* __restrict__ tgt,    // [N, S] (x, y, z, 0 or +inf)
    int P, int S, int chunk, float max_dist_sq,
    float* __restrict__ out) {         // [N, 3]
  extern __shared__ float4 s_tgt[];    // [S] compacted targets, w = index bits
  float4* s_pts = s_tgt + S;           // [chunk] compacted points, w = p / ~p
  unsigned* s_expl = reinterpret_cast<unsigned*>(s_pts + chunk);  // S bits
  __shared__ int s_cnt[2 * kWarps];

  const int n = blockIdx.x;
  for (int w = threadIdx.x; w < (S + 31) / 32; w += kThreads) s_expl[w] = 0u;
  int round = 0;
  const int nt = stage_targets(tgt + (size_t)n * S, S, s_tgt, s_cnt, round);
  int unexplained = 0;
  const int point_num = sweep(
      cloud + (size_t)n * P * 3, cadd + (size_t)n * P, P, chunk, max_dist_sq,
      s_tgt, nt, s_pts, s_cnt, round, [&](int w, float dmin, int win) {
        if (w >= 0 && dmin > max_dist_sq) ++unexplained;
        if (dmin <= max_dist_sq) atomicOr(&s_expl[win >> 5], 1u << (win & 31));
      });
  write_counts(point_num, unexplained, s_expl, S, out + (size_t)n * 3);
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
  const int chunk = chunk_points(fixed, P);
  if (chunk < kThreads) return (int)cudaErrorInvalidValue;
  return launch(cost_fused_kernel, N, fixed + (size_t)chunk * 16, stream,
                cloud, cadd, reinterpret_cast<const float4*>(tgt4), P, S,
                chunk, max_dist_sq, out);
}
