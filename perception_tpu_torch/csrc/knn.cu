// Masked batched 1-NN: for each query point of a pose, the minimum squared
// distance to the pose's valid references and the lowest index attaining it.
//
// Replaces nn1_batch_pallas (perception_tpu/ops/pallas_knn.py:71, kernel
// _knn_kernel at :33-67). The distance is in exact difference form,
// dx^2 + dy^2 + dz^2 + add with add = 0 for a valid reference and +inf for an
// invalid one, summed in that order. A strict < over ascending reference
// indices keeps the lowest index among equal distances, as the TPU kernel's
// per-tile argmin and strict cross-tile update do; a pose with no valid
// reference gives (inf, 0).
//
// What bounds it on the H100: 9 float32 operations per (query, reference)
// pair, 2048 x 256 x 256 pairs per ICP iteration on the composed refiners'
// path, against ~17 MB of inputs and outputs: operations. The simple design:
// one block per (pose, 256-query tile), one thread per query, reference
// tiles of 256 staged through shared memory as float4 (x, y, z, add), so a
// thread's inner loop is one broadcast shared-memory read and 9 operations.
// Built with --fmad=false so the distances round as in the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRefTile = 256;

__global__ void __launch_bounds__(kThreads) nn1_kernel(
    const float* __restrict__ query,   // [N, P, 3]
    const float* __restrict__ ref4,    // [N, S, 4] (x, y, z, add)
    int P, int S, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 s_ref[kRefTile];
  const int n = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (live) {
    const float* q = query + ((size_t)n * P + p) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float4* r = reinterpret_cast<const float4*>(ref4) + (size_t)n * S;
  float best = __int_as_float(0x7f800000);
  int best_i = 0;
  for (int base = 0; base < S; base += kRefTile) {
    const int len = min(kRefTile, S - base);
    __syncthreads();
    if ((int)threadIdx.x < len) s_ref[threadIdx.x] = r[base + threadIdx.x];
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float4 t = s_ref[j];
      const float dx = qx - t.x, dy = qy - t.y, dz = qz - t.z;
      const float d = dx * dx + dy * dy + dz * dz + t.w;
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (live) {
    dist[(size_t)n * P + p] = best;
    idx[(size_t)n * P + p] = best_i;
  }
}

}  // namespace

extern "C" int pt_nn1_batch(const float* query, const float* ref4, int N,
                            int P, int S, float* dist, int* idx,
                            void* stream) {
  if (N == 0 || P == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, N);
  nn1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(query, ref4, P, S,
                                                          dist, idx);
  return (int)cudaGetLastError();
}
