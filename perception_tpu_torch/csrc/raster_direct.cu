// Direct rasteriser: model bank + poses in, packed depth/triangle keys out.
//
// Replaces rasterize_direct_pallas (perception_tpu/ops/pallas_raster_direct.py:320,
// kernel _kernel at :94-299). Per pose: camera transform of the model's
// triangles, backface cull, projection, edge and inverse-depth coefficients;
// then per strided pixel the max over triangles of the key
// (bits(w) & ~2047) | (2047 - tri_id), and an epilogue to
// (rint(1/w) << 11) | tri_id.
//
// What bounds it on the H100: arithmetic. At the scoring shapes (2048 poses,
// a 32x32 ROI, 256 triangles) the coverage test is ~0.5 G (pixel, triangle)
// pairs of ~12 flops each, while the inputs are a few hundred KB and the
// output 8 MB. The simple design keeps that work on-chip and branch-cheap:
//   * one block per (pose, 256-pixel tile), one thread per pixel; each thread
//     owns its running max, so there are no atomics and the result is
//     deterministic;
//   * the pose's triangles are set up cooperatively, 256 at a time, into
//     shared memory (12 coefficients and a screen bbox each); every thread
//     then walks the same triangle list, so the bbox-versus-tile cull is a
//     warp-uniform branch;
//   * the same kernel serves the ROI (1024 pixels) and the full frame
//     (640x480 at stride 1), and any T up to 2048 triangles.
// Built with --fmad=false so every product rounds as in the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;   // pixels per block, one per thread
constexpr int kChunk = 256;  // triangles per shared-memory setup pass
constexpr int kTriIdBits = 11;
constexpr int kIdMask = (1 << kTriIdBits) - 1;
constexpr float kMaxDepth = float((1 << 20) - 2);
constexpr int kInvalidKey = 0x7fffffff;

__global__ void __launch_bounds__(kTile) raster_direct_kernel(
    const float* __restrict__ verts16,   // [M, 16, T]
    int T,
    const float* __restrict__ pose12,    // [N, 12] model->camera 3x4 (m)
    const int* __restrict__ model_ids,   // [N]
    const int* __restrict__ anchors,     // [N, 2] strided ROI origin (x0, y0)
    const float* __restrict__ proj12,    // [12] projection rows 0..2
    int width, int height, int stride, int roi_w, int npix,
    int* __restrict__ keys) {            // [N, npix]
  __shared__ float coef[12][kChunk];
  __shared__ float bbox[4][kChunk];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = blockIdx.y * kTile + tid;
  const int x0 = anchors[2 * n];
  const int y0 = anchors[2 * n + 1];
  const float* vb = verts16 + (size_t)model_ids[n] * 16 * T;

  float p[12], pr[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    p[i] = pose12[n * 12 + i];
    pr[i] = proj12[i];
  }
  const float hw = 0.5f * (float)width;
  const float hh = 0.5f * (float)height;

  const float px = (float)((x0 + pix % roi_w) * stride);
  const float py = (float)(height - 1 - (y0 + pix / roi_w) * stride);
  // The tile's screen extent, for the per-triangle cull.
  const int r0 = (blockIdx.y * kTile) / roi_w;
  const int r1 = (blockIdx.y * kTile + kTile - 1) / roi_w;
  const float tx_min = (float)(x0 * stride);
  const float tx_max = (float)((x0 + roi_w - 1) * stride);
  const float ty_max = (float)(height - 1 - (y0 + r0) * stride);
  const float ty_min = (float)(height - 1 - (y0 + r1) * stride);

  int best = 0;
  for (int base_t = 0; base_t < T; base_t += kChunk) {
    const int t = base_t + tid;
    if (t < T) {
      float cx[3], cy[3], cz[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float vx = vb[(3 * v) * T + t];
        const float vy = vb[(3 * v + 1) * T + t];
        const float vz = vb[(3 * v + 2) * T + t];
        cx[v] = p[0] * vx + p[1] * vy + p[2] * vz + p[3];
        cy[v] = p[4] * vx + p[5] * vy + p[6] * vz + p[7];
        cz[v] = p[8] * vx + p[9] * vy + p[10] * vz + p[11];
      }
      const bool valid = vb[9 * T + t] > 0.5f;
      const bool cullable = vb[10 * T + t] > 0.5f;
      // Backface (camera at the origin): facing iff normal . v0 < 0.
      const float e1x = cx[1] - cx[0], e1y = cy[1] - cy[0], e1z = cz[1] - cz[0];
      const float e2x = cx[2] - cx[0], e2y = cy[2] - cy[0], e2z = cz[2] - cz[0];
      const float nx = e1y * e2z - e1z * e2y;
      const float ny = e1z * e2x - e1x * e2z;
      const float nz = e1x * e2y - e1y * e2x;
      const bool facing = (nx * cx[0] + ny * cy[0] + nz * cz[0]) < 0.0f;
      bool ok = valid && (facing || !cullable);

      float sx[3], sy[3], zc[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        zc[v] = cz[v] * 100.0f;
        ok = ok && (zc[v] > 1e-3f);
        const float xc = cx[v] * 100.0f, yc = cy[v] * 100.0f;
        const float clip_x = xc * pr[0] + yc * pr[1] + zc[v] * pr[2] + pr[3];
        const float clip_y = yc * pr[5] + zc[v] * pr[6] + pr[7];
        const float zdiv = zc[v] > 1e-3f ? zc[v] : 1.0f;
        sx[v] = clip_x / zdiv * hw + hw;
        sy[v] = clip_y / zdiv * hh + hh;
      }
      const float e20x = sx[2] - sx[0], e20y = sy[2] - sy[0];
      const float e10x = sx[1] - sx[0], e10y = sy[1] - sy[0];
      const float base = 0.5f * (e20x * e10y - e10x * e20y);
      ok = ok && (fabsf(base) > 1e-2f);
      const float sign = base >= 0.0f ? 1.0f : -1.0f;
      const float inv_base = ok ? 1.0f / base : 0.0f;

      const float beta_x = -0.5f * e20y * sign;
      const float beta_y = 0.5f * e20x * sign;
      const float beta_c = 0.5f * (sx[0] * e20y - sy[0] * e20x) * sign;
      const float gamma_x = 0.5f * e10y * sign;
      const float gamma_y = -0.5f * e10x * sign;
      const float gamma_c = 0.5f * (sy[0] * e10x - sx[0] * e10y) * sign;

      const float iz0 = ok ? 1.0f / zc[0] : 0.0f;
      const float iz1 = ok ? 1.0f / zc[1] : 0.0f;
      const float iz2 = ok ? 1.0f / zc[2] : 0.0f;
      const float d1 = iz1 - iz0, d2 = iz2 - iz0;
      const float abs_base = ok ? fabsf(base) : -__int_as_float(0x7f800000);

      coef[0][tid] = beta_x;
      coef[1][tid] = beta_y;
      coef[2][tid] = beta_c;
      coef[3][tid] = gamma_x;
      coef[4][tid] = gamma_y;
      coef[5][tid] = gamma_c;
      coef[6][tid] = -beta_x - gamma_x;
      coef[7][tid] = -beta_y - gamma_y;
      coef[8][tid] = abs_base - beta_c - gamma_c;
      coef[9][tid] = (beta_x * sign * d1 + gamma_x * sign * d2) * inv_base;
      coef[10][tid] = (beta_y * sign * d1 + gamma_y * sign * d2) * inv_base;
      coef[11][tid] = iz0 + (beta_c * sign * d1 + gamma_c * sign * d2) * inv_base;
      // Screen bbox with a 1 px margin; invalid triangles never overlap.
      bbox[0][tid] = ok ? fminf(sx[0], fminf(sx[1], sx[2])) - 1.0f : 3e38f;
      bbox[1][tid] = ok ? fmaxf(sx[0], fmaxf(sx[1], sx[2])) + 1.0f : -3e38f;
      bbox[2][tid] = ok ? fminf(sy[0], fminf(sy[1], sy[2])) - 1.0f : 3e38f;
      bbox[3][tid] = ok ? fmaxf(sy[0], fmaxf(sy[1], sy[2])) + 1.0f : -3e38f;
    }
    __syncthreads();

    const int count = min(kChunk, T - base_t);
    for (int j = 0; j < count; ++j) {
      if (bbox[0][j] > tx_max || bbox[1][j] < tx_min ||
          bbox[2][j] > ty_max || bbox[3][j] < ty_min) {
        continue;   // uniform across the block
      }
      const float beta = coef[0][j] * px + coef[1][j] * py + coef[2][j];
      const float gamma = coef[3][j] * px + coef[4][j] * py + coef[5][j];
      const float alpha = coef[6][j] * px + coef[7][j] * py + coef[8][j];
      const float w = coef[9][j] * px + coef[10][j] * py + coef[11][j];
      // min(alpha, beta, gamma) >= 0 with NaN failing, as jnp.minimum does.
      const bool covered = alpha >= 0.0f && beta >= 0.0f && gamma >= 0.0f &&
                           isfinite(w) && w > 0.0f;
      if (covered) {
        const int wkey = (__float_as_int(w) & ~kIdMask) | (kIdMask - (base_t + j));
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

extern "C" int pt_raster_direct(const float* verts16, int T,
                                const float* pose12, const int* model_ids,
                                const int* anchors, const float* proj12, int N,
                                int width, int height, int stride, int roi_h,
                                int roi_w, int* keys, void* stream) {
  const int npix = roi_h * roi_w;
  if (N == 0 || npix == 0) return 0;
  dim3 grid(N, (npix + kTile - 1) / kTile);
  raster_direct_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      verts16, T, pose12, model_ids, anchors, proj12, width, height, stride,
      roi_w, npix, keys);
  return (int)cudaGetLastError();
}
