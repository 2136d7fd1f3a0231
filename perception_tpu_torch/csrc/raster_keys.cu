// Coefficient-table rasteriser: per-pose packed triangle coefficients in,
// packed depth/triangle keys out.
//
// Replaces rasterize_keys_pallas (perception_tpu/ops/pallas_raster.py:115,
// kernel _raster_kernel at :43-110). The triangle setup ran before the
// kernel (in PyTorch) into one row per triangle,
// (bx, by, bc, gx, gy, gc, ax, ay, ac, wx, wy, wc); culled triangles have
// ac = -inf. Per strided pixel the kernel takes the max over covered
// triangles (min(alpha, beta, gamma) >= 0; no test on w, as the TPU kernel)
// of (bits(w) & ~2047) | (2047 - tri_id), then the epilogue
// (rint(1/w) << 11) | tri_id.
//
// What bounds it on the H100: at the scoring shapes (2048 poses, 256
// triangles, a 32x32 ROI) the table in is 25 MB and the keys out 8 MB, a
// ~0.01 ms byte bound; the arithmetic on the pairs a chunk cull lets through
// is larger. The simple design:
//   * one block per (pose, 256-pixel tile), one thread per pixel; each
//     thread owns its running max, so there are no atomics and the result
//     is deterministic;
//   * per 256-triangle chunk the block tests the chunk's screen bbox
//     (precomputed, 1 px margin) against the tile's screen rectangle, a
//     block-uniform branch; on a hit it copies the chunk's rows into shared
//     memory with coalesced 16-byte loads, and every thread walks them
//     (broadcast reads);
//   * the cull is exact (a covered sample lies in its triangle's bbox), so
//     the tile size changes no key: the TPU's 512-pixel tiles are not kept.
// Built with --fmad=false so every product rounds as in the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;   // pixels per block, one per thread
constexpr int kChunk = 256;  // triangles per culled chunk
constexpr int kTriIdBits = 11;
constexpr int kIdMask = (1 << kTriIdBits) - 1;
constexpr float kMaxDepth = float((1 << 20) - 2);
constexpr int kInvalidKey = 0x7fffffff;

__global__ void __launch_bounds__(kTile) raster_keys_kernel(
    const float* __restrict__ coefs,        // [N, T, 12]
    const float* __restrict__ chunk_bbox,   // [N, n_chunks, 4]
    const int* __restrict__ anchors,        // [N, 2] strided ROI origin
    int T, int n_chunks, int height, int stride, int roi_w, int npix,
    int* __restrict__ keys) {               // [N, npix]
  __shared__ float4 coef4[kChunk * 3];      // 12 floats per triangle

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = blockIdx.y * kTile + tid;
  const int x0 = anchors[2 * n];
  const int y0 = anchors[2 * n + 1];
  const float px = (float)((x0 + pix % roi_w) * stride);
  const float py = (float)(height - 1 - (y0 + pix / roi_w) * stride);
  // The tile's screen rectangle: it spans whole ROI rows.
  const int r0 = (blockIdx.y * kTile) / roi_w;
  const int r1 = (blockIdx.y * kTile + kTile - 1) / roi_w;
  const float tx_min = (float)(x0 * stride);
  const float tx_max = (float)((x0 + roi_w - 1) * stride);
  const float ty_max = (float)(height - 1 - (y0 + r0) * stride);
  const float ty_min = (float)(height - 1 - (y0 + r1) * stride);

  int best = 0;
  for (int k = 0; k < n_chunks; ++k) {
    const float* cb = chunk_bbox + ((size_t)n * n_chunks + k) * 4;
    // NaN fails every comparison and skips the chunk, as on the TPU.
    if (!(cb[0] <= tx_max && cb[1] >= tx_min && cb[2] <= ty_max &&
          cb[3] >= ty_min)) {
      continue;   // uniform across the block
    }
    const int base = k * kChunk;
    const int count = min(kChunk, T - base);
    const float4* src =
        reinterpret_cast<const float4*>(coefs + ((size_t)n * T + base) * 12);
    for (int i = tid; i < count * 3; i += kTile) coef4[i] = src[i];
    __syncthreads();

    for (int j = 0; j < count; ++j) {
      const float4 c0 = coef4[3 * j];       // bx by bc gx
      const float4 c1 = coef4[3 * j + 1];   // gy gc ax ay
      const float4 c2 = coef4[3 * j + 2];   // ac wx wy wc
      const float beta = c0.x * px + c0.y * py + c0.z;
      const float gamma = c0.w * px + c1.x * py + c1.y;
      const float alpha = c1.z * px + c1.w * py + c2.x;
      const float w = c2.y * px + c2.z * py + c2.w;
      // min(alpha, beta, gamma) >= 0 with NaN failing, as jnp.minimum does.
      if (alpha >= 0.0f && beta >= 0.0f && gamma >= 0.0f) {
        const int wkey = (__float_as_int(w) & ~kIdMask) | (kIdMask - (base + j));
        best = max(best, wkey);
      }
    }
    __syncthreads();
  }

  if (pix < npix) {
    int key = kInvalidKey;
    if (best > 0) {
      // Half-step de-bias of the cleared mantissa bits, then round half to
      // even (jnp.round) and clip to the key's depth range.
      const float w_win =
          __int_as_float((best & ~kIdMask) | (1 << (kTriIdBits - 1)));
      const int tri = kIdMask - (best & kIdMask);
      const float depth = fminf(fmaxf(rintf(1.0f / w_win), 1.0f), kMaxDepth);
      key = ((int)depth << kTriIdBits) | tri;
    }
    keys[(size_t)n * npix + pix] = key;
  }
}

}  // namespace

extern "C" int pt_raster_keys(const float* coefs, const float* chunk_bbox,
                              const int* anchors, int N, int T, int height,
                              int stride, int roi_h, int roi_w, int* keys,
                              void* stream) {
  const int npix = roi_h * roi_w;
  if (N == 0 || npix == 0) return 0;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  dim3 grid(N, (npix + kTile - 1) / kTile);
  raster_keys_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      coefs, chunk_bbox, anchors, T, n_chunks, height, stride, roi_w, npix,
      keys);
  return (int)cudaGetLastError();
}
