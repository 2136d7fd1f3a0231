// Scatter-bin rasteriser: model bank + poses in, packed depth/triangle keys
// out, each pixel tile rasterised over its own list of triangle groups.
//
// Replaces rasterize_bin_pallas (perception_tpu/ops/pallas_raster_bin.py:306,
// kernel _kernel at :63-290). One block per pose, four phases:
//   (a) per-triangle setup into shared memory: camera transform, backface
//       cull, projection, edge / inverse-depth coefficients, in the direct
//       kernel's order of operations, plus the TPU kernel's per-triangle
//       guard (a triangle with a non-finite w, beta_c or gamma_c
//       coefficient is culled);
//   (b) screen bboxes of 16-triangle groups (xor shuffles within 16 lanes),
//       widened by 1 px and turned into inclusive ranges of 8x16-pixel tiles
//       in the TPU kernel's float order (:179-200);
//   (c) per-tile counts and group lists in shared memory, filled with
//       atomicAdd: the order of a list does not change a max, so the keys
//       are deterministic;
//   (d) threads walk (tile, pixel) pairs, 128 threads per tile, over their
//       tile's list: coverage min(alpha, beta, gamma) >= 0 (no per-pixel test
//       on w, as the TPU kernel), key (bits(w) & ~2047) | (2047 - tri_id),
//       epilogue (rint(1/w) << 11) | tri_id; pixels of partial edge tiles
//       are masked, and keys are written row-major (the TPU kernel's
//       tile-major output and its caller's permutation are not needed).
//
// What bounds it on the H100: the bank is read once per pose (a few hundred
// KB for all poses) and the keys written once (8 MB at 2048 poses and a
// 32x32 ROI); the work is the setup (~130 flops per triangle and pose) and
// the coverage tests of the (pixel, triangle) pairs whose group bbox touches
// the pixel's tile, which binning keeps close to the pairs inside the
// triangles' own bboxes. Shared memory per block: 48 B per triangle plus the
// lists (T = 256: ~13 KB; T = 2048 over an 80x60 frame: ~121 KB, opted in
// above 48 KB).
// Built with --fmad=false so every product rounds as in the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSubG = 16;                    // triangles per binned group
constexpr int kTileH = 8, kTileW = 16;       // pixel tile (ROI rows x cols)
constexpr int kTilePix = kTileH * kTileW;
constexpr int kTriIdBits = 11;
constexpr int kIdMask = (1 << kTriIdBits) - 1;
constexpr float kMaxDepth = float((1 << 20) - 2);
constexpr int kInvalidKey = 0x7fffffff;
constexpr float kBig = 3e38f;

__global__ void __launch_bounds__(kThreads) raster_bin_kernel(
    const float* __restrict__ verts16,   // [M, 16, T], T a multiple of 16
    int T,
    const float* __restrict__ pose12,    // [N, 12] model->camera 3x4 (m)
    const int* __restrict__ model_ids,   // [N]
    const int* __restrict__ anchors,     // [N, 2] strided ROI origin (x0, y0)
    const float* __restrict__ proj12,    // [12] projection rows 0..2
    int width, int height, int stride, int roi_h, int roi_w, int ntx,
    int nty, int* __restrict__ keys) {   // [N, roi_h * roi_w]
  extern __shared__ float4 smem[];
  const int n_sub = T / kSubG;
  const int n_tiles = ntx * nty;
  float4* coef4 = smem;                                    // [T][3]
  int4* ranges = reinterpret_cast<int4*>(coef4 + 3 * T);   // [n_sub]
  int* counts = reinterpret_cast<int*>(ranges + n_sub);    // [n_tiles]
  int* lists = counts + n_tiles;                           // [n_tiles][n_sub]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
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
  for (int i = tid; i < n_tiles; i += kThreads) counts[i] = 0;

  // (a) + (b): setup and group tile ranges. Every thread takes part in the
  // shuffles; groups of 16 lanes lie wholly inside or outside [0, T).
  for (int base = 0; base < T; base += kThreads) {
    const int t = base + tid;
    const bool active = t < T;
    float mnx = kBig, mxx = -kBig, mny = kBig, mxy = -kBig;
    if (active) {
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
      const float base_area = 0.5f * (e20x * e10y - e10x * e20y);
      ok = ok && (fabsf(base_area) > 1e-2f);
      const float sign = base_area >= 0.0f ? 1.0f : -1.0f;
      const float inv_base = ok ? 1.0f / base_area : 0.0f;

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
      const float w_x = (beta_x * sign * d1 + gamma_x * sign * d2) * inv_base;
      const float w_y = (beta_y * sign * d1 + gamma_y * sign * d2) * inv_base;
      const float w_c =
          iz0 + (beta_c * sign * d1 + gamma_c * sign * d2) * inv_base;
      ok = ok && isfinite(w_x) && isfinite(w_y) && isfinite(w_c) &&
           isfinite(beta_c) && isfinite(gamma_c);
      const float abs_base = ok ? fabsf(base_area) : -__int_as_float(0x7f800000);

      coef4[3 * t] = make_float4(beta_x, beta_y, beta_c, gamma_x);
      coef4[3 * t + 1] = make_float4(gamma_y, gamma_c, -beta_x - gamma_x,
                                     -beta_y - gamma_y);
      coef4[3 * t + 2] =
          make_float4(abs_base - beta_c - gamma_c, w_x, w_y, w_c);
      if (ok) {
        mnx = fminf(sx[0], fminf(sx[1], sx[2]));
        mxx = fmaxf(sx[0], fmaxf(sx[1], sx[2]));
        mny = fminf(sy[0], fminf(sy[1], sy[2]));
        mxy = fmaxf(sy[0], fmaxf(sy[1], sy[2]));
      }
    }
#pragma unroll
    for (int off = kSubG / 2; off > 0; off >>= 1) {
      mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, off, kSubG));
      mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, off, kSubG));
      mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, off, kSubG));
      mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, off, kSubG));
    }
    if (active && t % kSubG == 0) {
      const float sxmin = mnx - 1.0f, sxmax = mxx + 1.0f;
      const float symin = mny - 1.0f, symax = mxy + 1.0f;
      // ROI col = px / stride - x0; ROI row = (H - 1 - py) / stride - y0.
      const float fs = (float)stride;
      const float cx0 = sxmin / fs - (float)x0;
      const float cx1 = sxmax / fs - (float)x0;
      const float ry0 = ((float)(height - 1) - symax) / fs - (float)y0;
      const float ry1 = ((float)(height - 1) - symin) / fs - (float)y0;
      const bool off = sxmin > sxmax || cx1 < 0.0f ||
                       cx0 > (float)(roi_w - 1) || ry1 < 0.0f ||
                       ry0 > (float)(roi_h - 1);
      const float ltx = (float)(ntx - 1), lty = (float)(nty - 1);
      int4 r;
      r.x = (int)fminf(fmaxf(floorf(cx0 / (float)kTileW), 0.0f), ltx);
      r.y = (int)fminf(fmaxf(floorf(cx1 / (float)kTileW), 0.0f), ltx);
      r.z = (int)fminf(fmaxf(floorf(ry0 / (float)kTileH), 0.0f), lty);
      r.w = (int)fminf(fmaxf(floorf(ry1 / (float)kTileH), 0.0f), lty);
      if (off) {
        r.x = 1;   // an empty column range
        r.y = 0;
      }
      ranges[t / kSubG] = r;
    }
  }
  __syncthreads();

  // (c) Scatter each group into the list of every tile in its range.
  for (int s = tid; s < n_sub; s += kThreads) {
    const int4 r = ranges[s];
    for (int ty = r.z; ty <= r.w; ++ty) {
      for (int tx = r.x; tx <= r.y; ++tx) {
        const int tile = ty * ntx + tx;
        lists[tile * n_sub + atomicAdd(&counts[tile], 1)] = s;
      }
    }
  }
  __syncthreads();

  // (d) Raster: kThreads / 128 tiles at a time, one pixel per thread.
  const int npix = roi_h * roi_w;
  const int q = tid % kTilePix;
  for (int j0 = 0; j0 < n_tiles; j0 += kThreads / kTilePix) {
    const int j = j0 + tid / kTilePix;
    if (j >= n_tiles) break;
    const int col = (j % ntx) * kTileW + q % kTileW;
    const int row = (j / ntx) * kTileH + q / kTileW;
    const float px = (float)((x0 + col) * stride);
    const float py = (float)(height - 1 - (y0 + row) * stride);
    int best = 0;
    const int count = counts[j];
    for (int i = 0; i < count; ++i) {
      const int s = lists[j * n_sub + i];
#pragma unroll 4
      for (int g = 0; g < kSubG; ++g) {
        const int tri = s * kSubG + g;
        const float4 c0 = coef4[3 * tri];       // bx by bc gx
        const float4 c1 = coef4[3 * tri + 1];   // gy gc ax ay
        const float4 c2 = coef4[3 * tri + 2];   // ac wx wy wc
        const float beta = c0.x * px + c0.y * py + c0.z;
        const float gamma = c0.w * px + c1.x * py + c1.y;
        const float alpha = c1.z * px + c1.w * py + c2.x;
        const float w = c2.y * px + c2.z * py + c2.w;
        if (alpha >= 0.0f && beta >= 0.0f && gamma >= 0.0f) {
          best = max(best, (__float_as_int(w) & ~kIdMask) | (kIdMask - tri));
        }
      }
    }
    if (col < roi_w && row < roi_h) {
      int key = kInvalidKey;
      if (best > 0) {
        const float w_win =
            __int_as_float((best & ~kIdMask) | (1 << (kTriIdBits - 1)));
        const float depth = fminf(fmaxf(rintf(1.0f / w_win), 1.0f), kMaxDepth);
        key = ((int)depth << kTriIdBits) | (kIdMask - (best & kIdMask));
      }
      keys[(size_t)n * npix + row * roi_w + col] = key;
    }
  }
}

}  // namespace

extern "C" int pt_raster_bin(const float* verts16, int T, const float* pose12,
                             const int* model_ids, const int* anchors,
                             const float* proj12, int N, int width, int height,
                             int stride, int roi_h, int roi_w, int smem_bytes,
                             int* keys, void* stream) {
  if (N == 0 || roi_h * roi_w == 0) return 0;
  const int ntx = (roi_w + kTileW - 1) / kTileW;
  const int nty = (roi_h + kTileH - 1) / kTileH;
  cudaError_t err = cudaFuncSetAttribute(
      raster_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  raster_bin_kernel<<<N, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      verts16, T, pose12, model_ids, anchors, proj12, width, height, stride,
      roi_h, roi_w, ntx, nty, keys);
  return (int)cudaGetLastError();
}
