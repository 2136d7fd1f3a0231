// Scatter-bin rasteriser: model bank + poses in, packed depth/triangle keys
// out, each warp patch rasterised over its own list of triangles.
//
// Replaces rasterize_bin_pallas (perception_tpu/ops/pallas_raster_bin.py:306,
// kernel _kernel at :63-290). The TPU kernel bins 16-triangle groups,
// since it cannot scatter single triangles (:10-14); a CUDA block can, with
// shared-memory atomics. One block of 256 threads per pose:
//   (a) per-triangle setup into shared memory (raster_setup.cuh with the
//       TPU kernel's finite guard: a triangle with a non-finite w, beta_c or
//       gamma_c coefficient is culled), and each drawable triangle's bin
//       range: its screen box widened by 1 px, turned into inclusive ranges
//       of 8x4-pixel patches of the strided ROI in the TPU kernel's float
//       order (:179-200);
//   (b) per window of patches (the whole ROI unless its counts outgrow the
//       shared memory), the patch lists in three steps: a count pass (a
//       shared atomicAdd per (triangle, patch), every thread busy), a block
//       exclusive scan of the counts, and a fill pass of 16-bit triangle
//       ids. A triangle whose range spans more than kMaxBins patches of the
//       window goes to one "wide" list instead, so the lists hold at most
//       T * kMaxBins ids at any T and ROI;
//   (c) warp w rasterises patches w, w + 8, ...: each lane owns one pixel
//       and walks its patch's list, then the wide list, skipping (as a
//       whole warp) the wide triangles whose range misses the patch; three
//       broadcast float4 loads per triangle. Coverage is
//       min(alpha, beta, gamma) >= 0 (no per-pixel test on w, as the TPU
//       kernel), the key (bits(w) & ~2047) | (2047 - tri_id), the epilogue
//       (rint(1/w) << 11) | tri_id; pixels of partial edge patches are
//       masked, and keys are written row-major (the TPU kernel's tile-major
//       output and its caller's permutation are not needed).
// The binning never drops a covering triangle: a covered pixel lies inside
// its triangle's widened box (the premise of every box cull of this
// repository's rasters, held on bench poses by
// tests/test_torch_raster_keys_bin_cull.py), and every step from the box to
// a patch index (divide, subtract, floor, clamp) is monotone in float32, so
// the pixel's patch lies inside the triangle's range; the wide list's test
// is that same range. A max does not depend on the order of its terms, so
// the keys are those of the twin, which neither bins nor culls, and do not
// depend on the order in which the atomics fill a list.
//
// What bounds it on the H100: the bank is read once per pose (a few hundred
// KB for all poses) and the keys written once (8.4 MB at 2048 poses and a
// 32x32 ROI); the work is the setup (~130 flops per triangle and pose) and
// the coverage tests of the (pixel, triangle) pairs of the patches each
// triangle's box spans: 3 patches per drawn triangle on average at the
// bench, about 3% of the dense pairs at the ROI and 0.7% at the 80x60 full
// frame. Shared memory per block, all of it dynamic (so the window can use
// every byte the block may opt in to): 82 B per triangle, 36 B for the scan's
// warp sums and the wide list's count, and 4 B per patch of the window
// (T = 256 at the ROI: 21 KB; T = 2048 over 640x480 at stride 1: 206 KB,
// opted in above 48 KB).
// Built with --fmad=false so every product rounds as in the PyTorch twin.

#include <cuda_runtime.h>

#include "raster_setup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPatchW = 8, kPatchH = 4;      // a warp's pixels (cols x rows)
constexpr int kMaxBins = 8;                  // patches a binned triangle spans
constexpr int kTriIdBits = 11;
constexpr int kIdMask = (1 << kTriIdBits) - 1;
constexpr float kMaxDepth = float((1 << 20) - 2);
constexpr int kInvalidKey = 0x7fffffff;

// A triangle's patch range clipped to the window [wx0, wx0 + ww) x
// [wy0, wy0 + wh); empty when r.x > r.y or r.z > r.w.
__device__ __forceinline__ int4 clip(int4 r, int wx0, int wy0, int ww,
                                     int wh) {
  return make_int4(max(r.x, wx0), min(r.y, wx0 + ww - 1), max(r.z, wy0),
                   min(r.w, wy0 + wh - 1));
}

__global__ void __launch_bounds__(kThreads) raster_bin_kernel(
    const float* __restrict__ verts16,   // [M, 16, T]
    int T,
    const float* __restrict__ pose12,    // [N, 12] model->camera 3x4 (m)
    const int* __restrict__ model_ids,   // [N]
    const int* __restrict__ anchors,     // [N, 2] strided ROI origin (x0, y0)
    const float* __restrict__ proj12,    // [12] projection rows 0..2
    int width, int height, int stride, int roi_h, int roi_w, int ntx,
    int nty, int win_w, int win_h,
    int* __restrict__ keys) {            // [N, roi_h * roi_w]
  extern __shared__ float4 smem[];
  float4* coef4 = smem;                                    // [T][3]
  int4* range = reinterpret_cast<int4*>(coef4 + 3 * T);    // [T]
  int* warp_sum = reinterpret_cast<int*>(range + T);       // [kWarps]
  int& wide_n = warp_sum[kWarps];
  int* ends = warp_sum + kWarps + 1;                       // [win_w * win_h]
  // [T * kMaxBins] list slots, then [T] wide-list slots
  unsigned short* list =
      reinterpret_cast<unsigned short*>(ends + win_w * win_h);
  unsigned short* wide = list + T * kMaxBins;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x0 = anchors[2 * n];
  const int y0 = anchors[2 * n + 1];

  // (a) Setup and patch ranges.
  {
    const raster_setup::Pose ps =
        raster_setup::load_pose(pose12, proj12, n, width, height);
    const float* vb = verts16 + (size_t)model_ids[n] * 16 * T;
    const float fs = (float)stride;
    const float ltx = (float)(ntx - 1), lty = (float)(nty - 1);
    for (int t = tid; t < T; t += kThreads) {
      const raster_setup::Triangle tri =
          raster_setup::setup<true>(vb, T, t, ps);
      coef4[3 * t] = tri.c0;
      coef4[3 * t + 1] = tri.c1;
      coef4[3 * t + 2] = tri.c2;
      int4 r = make_int4(1, 0, 1, 0);   // empty
      if (tri.ok) {
        const float sxmin = tri.xmin - 1.0f, sxmax = tri.xmax + 1.0f;
        const float symin = tri.ymin - 1.0f, symax = tri.ymax + 1.0f;
        // ROI col = px / stride - x0; ROI row = (H - 1 - py) / stride - y0.
        const float cx0 = sxmin / fs - (float)x0;
        const float cx1 = sxmax / fs - (float)x0;
        const float ry0 = ((float)(height - 1) - symax) / fs - (float)y0;
        const float ry1 = ((float)(height - 1) - symin) / fs - (float)y0;
        const bool off = cx1 < 0.0f || cx0 > (float)(roi_w - 1) ||
                         ry1 < 0.0f || ry0 > (float)(roi_h - 1);
        if (!off) {
          r.x = (int)fminf(fmaxf(floorf(cx0 / (float)kPatchW), 0.0f), ltx);
          r.y = (int)fminf(fmaxf(floorf(cx1 / (float)kPatchW), 0.0f), ltx);
          r.z = (int)fminf(fmaxf(floorf(ry0 / (float)kPatchH), 0.0f), lty);
          r.w = (int)fminf(fmaxf(floorf(ry1 / (float)kPatchH), 0.0f), lty);
        }
      }
      range[t] = r;
    }
  }

  const int npix = roi_h * roi_w;
  for (int wy0 = 0; wy0 < nty; wy0 += win_h) {
    for (int wx0 = 0; wx0 < ntx; wx0 += win_w) {
      const int ww = min(win_w, ntx - wx0), wh = min(win_h, nty - wy0);
      const int nb = ww * wh;
      for (int b = tid; b < nb; b += kThreads) ends[b] = 0;
      if (tid == 0) wide_n = 0;
      __syncthreads();   // also publishes (a) to the first window

      // (b) Count pass.
      for (int t = tid; t < T; t += kThreads) {
        const int4 c = clip(range[t], wx0, wy0, ww, wh);
        if (c.x > c.y || c.z > c.w ||
            (c.y - c.x + 1) * (c.w - c.z + 1) > kMaxBins) {
          continue;
        }
        for (int by = c.z; by <= c.w; ++by) {
          for (int bx = c.x; bx <= c.y; ++bx) {
            atomicAdd(&ends[(by - wy0) * ww + bx - wx0], 1);
          }
        }
      }
      __syncthreads();

      // Exclusive scan of the counts: thread i takes the i-th run of `per`
      // patches; warp shuffles and the warps' sums give its offset.
      {
        const int per = (nb + kThreads - 1) / kThreads;
        const int b0 = min(tid * per, nb), b1 = min(b0 + per, nb);
        int sum = 0;
        for (int b = b0; b < b1; ++b) sum += ends[b];
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        if (lane == 31) warp_sum[warp] = incl;
        __syncthreads();
        int run = incl - sum;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) run += w < warp ? warp_sum[w] : 0;
        for (int b = b0; b < b1; ++b) {
          const int c = ends[b];
          ends[b] = run;
          run += c;
        }
      }
      __syncthreads();

      // Fill pass: ends[b] runs from patch b's start to its end.
      for (int t = tid; t < T; t += kThreads) {
        const int4 c = clip(range[t], wx0, wy0, ww, wh);
        if (c.x > c.y || c.z > c.w) continue;
        if ((c.y - c.x + 1) * (c.w - c.z + 1) > kMaxBins) {
          wide[atomicAdd(&wide_n, 1)] = (unsigned short)t;
          continue;
        }
        for (int by = c.z; by <= c.w; ++by) {
          for (int bx = c.x; bx <= c.y; ++bx) {
            list[atomicAdd(&ends[(by - wy0) * ww + bx - wx0], 1)] =
                (unsigned short)t;
          }
        }
      }
      __syncthreads();

      // (c) Raster: warp w takes patches w, w + 8, ...
      const int n_wide = wide_n;
      for (int b = warp; b < nb; b += kWarps) {
        const int bx = wx0 + b % ww, by = wy0 + b / ww;
        const int col = bx * kPatchW + lane % kPatchW;
        const int row = by * kPatchH + lane / kPatchW;
        const float px = (float)((x0 + col) * stride);
        const float py = (float)(height - 1 - (y0 + row) * stride);
        int best = 0;
        const int first = b > 0 ? ends[b - 1] : 0;
        const int last = ends[b];
        for (int i = first; i < last + n_wide; ++i) {
          int t;
          if (i < last) {
            t = list[i];
          } else {
            t = wide[i - last];
            const int4 r = range[t];
            if (bx < r.x || bx > r.y || by < r.z || by > r.w) {
              continue;   // uniform across the warp
            }
          }
          const float4 c0 = coef4[3 * t];       // bx by bc gx
          const float4 c1 = coef4[3 * t + 1];   // gy gc ax ay
          const float4 c2 = coef4[3 * t + 2];   // ac wx wy wc
          const float beta = c0.x * px + c0.y * py + c0.z;
          const float gamma = c0.w * px + c1.x * py + c1.y;
          const float alpha = c1.z * px + c1.w * py + c2.x;
          const float w = c2.y * px + c2.z * py + c2.w;
          if (alpha >= 0.0f && beta >= 0.0f && gamma >= 0.0f) {
            best = max(best, (__float_as_int(w) & ~kIdMask) | (kIdMask - t));
          }
        }
        if (col < roi_w && row < roi_h) {
          int key = kInvalidKey;
          if (best > 0) {
            const float w_win =
                __int_as_float((best & ~kIdMask) | (1 << (kTriIdBits - 1)));
            const float depth =
                fminf(fmaxf(rintf(1.0f / w_win), 1.0f), kMaxDepth);
            key = ((int)depth << kTriIdBits) | (kIdMask - (best & kIdMask));
          }
          keys[(size_t)n * npix + row * roi_w + col] = key;
        }
      }
      __syncthreads();   // the window's lists are rebuilt by the next window
    }
  }
}

}  // namespace

extern "C" int pt_raster_bin(const float* verts16, int T, const float* pose12,
                             const int* model_ids, const int* anchors,
                             const float* proj12, int N, int width, int height,
                             int stride, int roi_h, int roi_w, int win_w,
                             int win_h, int smem_bytes, int* keys,
                             void* stream) {
  if (N == 0 || roi_h * roi_w == 0) return 0;
  const int ntx = (roi_w + kPatchW - 1) / kPatchW;
  const int nty = (roi_h + kPatchH - 1) / kPatchH;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  raster_bin_kernel<<<N, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      verts16, T, pose12, model_ids, anchors, proj12, width, height, stride,
      roi_h, roi_w, ntx, nty, win_w, win_h, keys);
  return (int)cudaGetLastError();
}
