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
// What bounds it on the H100: instruction issue. A (query, reference) pair
// is 3 sub, 3 mul, 3 add, one compare and two selects: 12 FP32/ALU
// instructions, none of them fusable (--fmad=false keeps every product
// rounded as in the PyTorch twin, so the 67 TFLOP/s FMA peak does not
// apply). At the composed refiners' shape (2048 poses x 256 queries x 256
// references, 1.34e8 pairs) that is ~1.6e9 thread instructions: ~0.05 ms at
// 132 SMs x 128 lanes x ~1.8 GHz, against ~19 MB of inputs and outputs
// (0.006 ms at 3.35 TB/s).
//
// The design keeps the issue slots on that arithmetic:
//   * register blocking: each thread owns kQ = 4 queries (p, p + 64,
//     p + 128, p + 192), so one broadcast shared-memory read of a reference
//     feeds 4 independent distance chains (a quarter of a load per pair, and
//     4-way instruction-level parallelism behind the running minimum);
//   * one block of 64 threads per (pose, 256-query tile): 2048 blocks of 2
//     warps at the refiners' shape, all resident in one wave (at most 16 per
//     SM), no tail;
//   * the pose's references stream through two 256-reference shared-memory
//     buffers with cp.async: the first tile is in flight while the queries
//     load, and tile i + 1 is in flight while tile i is searched.
// Per thread and query the scan is the sequential one (ascending indices,
// strict <), so no merge is needed. Block 64 threads, 8 KB of static shared
// memory, 64 registers and no spills (`-Xptxas -v`, in
// kernels/build.build_log): 16 blocks fill an SM's register file, enough
// for the 15.5 blocks per SM of the refiners' shape. Measured on the H100
// against 2 queries x 128 threads and 8 x 32, 4 x 64 was the fastest, and
// the reference loop unrolled by 16 beat 4 and 8 (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 4;                       // queries per thread
constexpr int kThreads = 64;
constexpr int kQueries = kQ * kThreads;     // queries per block
constexpr int kRefTile = 256;               // references per stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copy len references into dst; one commit group per stage.
__device__ __forceinline__ void stage(float4* dst, const float4* src, int len) {
  for (int j = threadIdx.x; j < len; j += kThreads) cp_async16(dst + j, src + j);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__global__ void __launch_bounds__(kThreads) nn1_kernel(
    const float* __restrict__ query,   // [N, P, 3]
    const float* __restrict__ ref4,    // [N, S, 4] (x, y, z, add), 16-B rows
    int P, int S, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ __align__(16) float4 s_ref[2][kRefTile];
  const int n = blockIdx.y;
  const float4* r = reinterpret_cast<const float4*>(ref4) + (size_t)n * S;
  stage(s_ref[0], r, min(kRefTile, S));

  const int p0 = blockIdx.x * kQueries + threadIdx.x;
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_i[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int p = p0 + k * kThreads;
    qx[k] = qy[k] = qz[k] = 0.0f;
    if (p < P) {
      const float* q = query + ((size_t)n * P + p) * 3;
      qx[k] = q[0];
      qy[k] = q[1];
      qz[k] = q[2];
    }
    best[k] = __int_as_float(0x7f800000);
    best_i[k] = 0;
  }

  const int n_tiles = (S + kRefTile - 1) / kRefTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int base = i * kRefTile;
    if (i + 1 < n_tiles) {
      // Buffer (i + 1) & 1 was last read in iteration i - 1, which ended
      // with a barrier.
      stage(s_ref[(i + 1) & 1], r + base + kRefTile,
            min(kRefTile, S - base - kRefTile));
      wait_stages<1>();
    } else {
      wait_stages<0>();
    }
    __syncthreads();
    const float4* tile = s_ref[i & 1];
    const int len = min(kRefTile, S - base);
#pragma unroll 16
    for (int j = 0; j < len; ++j) {
      const float4 t = tile[j];
      const int id = base + j;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float dx = qx[k] - t.x, dy = qy[k] - t.y, dz = qz[k] - t.z;
        const float d = dx * dx + dy * dy + dz * dz + t.w;
        if (d < best[k]) {
          best[k] = d;
          best_i[k] = id;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int p = p0 + k * kThreads;
    if (p < P) {
      dist[(size_t)n * P + p] = best[k];
      idx[(size_t)n * P + p] = best_i[k];
    }
  }
}

}  // namespace

// ref4 must be 16-byte aligned (cp.async copies whole float4 rows).
extern "C" int pt_nn1_batch(const float* query, const float* ref4, int N,
                            int P, int S, float* dist, int* idx,
                            void* stream) {
  if (N == 0 || P == 0) return 0;
  const dim3 grid((P + kQueries - 1) / kQueries, N);
  nn1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(query, ref4, P, S,
                                                          dist, idx);
  return (int)cudaGetLastError();
}
