// Coefficient-table rasteriser: per-pose packed triangle coefficients and
// screen boxes in, packed depth/triangle keys out; and the table's setup.
//
// pt_raster_keys replaces rasterize_keys_pallas
// (perception_tpu/ops/pallas_raster.py:115, kernel _raster_kernel at
// :43-110). The table has one row per triangle,
// (bx, by, bc, gx, gy, gc, ax, ay, ac, wx, wy, wc); culled triangles have
// ac = -inf and a box of (+inf, -inf, +inf, -inf). Per strided pixel the
// kernel takes the max over covered triangles (min(alpha, beta, gamma) >= 0;
// no test on w, as the TPU kernel) of (bits(w) & ~2047) | (2047 - tri_id),
// then the epilogue (rint(1/w) << 11) | tri_id.
//
// pt_keys_setup writes that table and the boxes from the bank, the poses and
// the model ids, one thread per (pose, triangle), in the order of
// rasterizer.keys_setup and raster_keys.pack_coefficients (the JAX package
// computes it outside any kernel, as XLA element-wise code,
// perception_tpu/ops/rasterizer.py:375-399): the shared setup of
// raster_setup.cuh without the bin raster's finite guard. It is bound by the
// 33.6 MB it writes at the bench (0.010 ms); a block stages its 256 rows in
// shared memory and stores them as consecutive float4s (24% less device
// time than each thread storing its own 48-byte row, PERF.md).
//
// What bounds the raster on the H100: at the scoring shapes (2048 poses,
// 256 triangles) the bytes are the table (25.2 MB), the boxes (8.4 MB) and
// the keys (8.4 MB at a 32x32 ROI), ~0.013 ms; the pairs that a triangle's
// screen box lets through are 0.75% (ROI) and 0.18% (80x60 full frame) of
// the dense (pixel, triangle) pairs, so the time is the cull, the staging
// and each block's fixed latency. The design is the direct raster's
// (raster_direct.cu) without its setup:
//   * square tiles of 16x16 strided pixels, one thread per pixel with its
//     own running max: no atomics, so the keys are deterministic. Edge tiles
//     of a ragged ROI are masked at the store;
//   * a block of 256 threads takes a run of consecutive tiles of one pose,
//     the shortest run that keeps the grid within kWave blocks, and widens
//     the pose's boxes by 1 px into shared memory once for the run. With no
//     setup to share, shorter runs than row 1's pay: at 4096 blocks (runs
//     of 2 tiles at the ROI, 10 at the full frame) the kernel took 5-9% less
//     device time than at row 1's 1024 on the card (PERF.md);
//   * per tile, thread j tests triangle j's widened box against the tile's x
//     and y extents (256 triangles per pass, any T up to 2048), and a warp
//     vote (__ballot_sync, __popc prefix counts, per-warp offsets) compacts
//     the survivors, in ascending order, into a shared id list. A NaN box
//     fails every comparison and is skipped, as in the TPU kernel's chunk
//     test (pallas_raster.py:72-75);
//   * only the survivors' three coefficient float4s are loaded from the
//     table (16-byte loads), 256 per round, so the table is not read whole.
//     Warp w covers an 8x4 pixel patch of the tile and skips, as a whole,
//     every survivor whose box misses the patch.
// The cull never drops a covering triangle: a covered pixel lies inside its
// triangle's widened box (the premise of every box cull of this
// repository's rasters, held on bench poses by
// tests/test_torch_raster_keys_bin_cull.py), and a pixel of a tile or patch
// lies inside its extents. A max does not depend on the order of its terms,
// so the keys are those of the twin, which culls nothing.
// Shared memory: 20 B per triangle and 17 KB of staging (T = 256: 22 KB;
// T = 2048: 58 KB, opted in above 48 KB).
// Built with --fmad=false so every product rounds as in the PyTorch twin.

#include <cuda_runtime.h>

#include <algorithm>

#include "raster_setup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // tile side in strided pixels
constexpr int kRound = 256;        // survivors staged per round
constexpr int kWave = 4096;        // the grid's bound in blocks
constexpr int kTriIdBits = 11;
constexpr int kIdMask = (1 << kTriIdBits) - 1;
constexpr float kMaxDepth = float((1 << 20) - 2);
constexpr int kInvalidKey = 0x7fffffff;

// Dynamic shared memory: widened boxes [T] float4, staged survivors
// [kRound][4] float4, their key ids [kRound] and the survivor list [T].
size_t smem_bytes(int T) {
  return (size_t)T * sizeof(float4) + (size_t)kRound * 4 * sizeof(float4) +
         (size_t)(kRound + T) * sizeof(int);
}

__global__ void __launch_bounds__(kThreads) raster_keys_kernel(
    const float4* __restrict__ coefs,    // [N, T, 3] float4
    const float4* __restrict__ bboxes,   // [N, T] (xmin, xmax, ymin, ymax)
    const int* __restrict__ anchors,     // [N, 2] strided ROI origin
    int T, int height, int stride, int roi_h, int roi_w, int ntx, int ntiles,
    int per_block, int* __restrict__ keys) {   // [N, roi_h * roi_w]
  extern __shared__ float4 smem[];
  float4* box = smem;                                      // [T]
  float4* staged = box + T;                                // [kRound][4]
  int* staged_id = reinterpret_cast<int*>(staged + 4 * kRound);  // [kRound]
  int* ids = staged_id + kRound;                           // [T]
  __shared__ int warp_count[kWarps];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x0 = anchors[2 * n];
  const int y0 = anchors[2 * n + 1];
  const float4* tri = coefs + (size_t)n * T * 3;
  for (int t = tid; t < T; t += kThreads) {
    const float4 b = bboxes[(size_t)n * T + t];
    box[t] = make_float4(b.x - 1.0f, b.y + 1.0f, b.z - 1.0f, b.w + 1.0f);
  }
  __syncthreads();

  const int tile0 = blockIdx.y * per_block;
  const int my_tiles = min(per_block, ntiles - tile0);
  for (int g = 0; g < my_tiles; ++g) {
    const int tile = tile0 + g;
    const int c0 = (tile % ntx) * kTile, r0 = (tile / ntx) * kTile;
    const int c1 = min(c0 + kTile - 1, roi_w - 1);
    const int r1 = min(r0 + kTile - 1, roi_h - 1);
    const float tx_min = (float)((x0 + c0) * stride);
    const float tx_max = (float)((x0 + c1) * stride);
    const float ty_max = (float)(height - 1 - (y0 + r0) * stride);
    const float ty_min = (float)(height - 1 - (y0 + r1) * stride);
    // Cull against the tile and compact the survivors' ids, ascending, into
    // ids[0, total).
    int total = 0;
    for (int base = 0; base < T; base += kThreads) {
      const int t = base + tid;
      bool keep = false;
      if (t < T) {
        const float4 b = box[t];
        keep = b.x <= tx_max && b.y >= tx_min && b.z <= ty_max &&
               b.w >= ty_min;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) warp_count[warp] = __popc(vote);
      __syncthreads();
      int before = total;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_count[w] : 0;
        total += warp_count[w];
      }
      if (keep) ids[before + __popc(vote & ((1u << lane) - 1u))] = t;
      __syncthreads();   // warp_count is rewritten by the next pass
    }

    // Warp w covers the 8x4 pixels at tile column 8 (w % 2), row 4 (w / 2).
    const int wc0 = c0 + (warp % 2) * 8, wr0 = r0 + (warp / 2) * 4;
    const int col = wc0 + lane % 8, row = wr0 + lane / 8;
    const bool warp_live = wc0 < roi_w && wr0 < roi_h;
    const float wx_min = (float)((x0 + wc0) * stride);
    const float wx_max = (float)((x0 + min(wc0 + 7, roi_w - 1)) * stride);
    const float wy_max = (float)(height - 1 - (y0 + wr0) * stride);
    const float wy_min =
        (float)(height - 1 - (y0 + min(wr0 + 3, roi_h - 1)) * stride);
    const float px = (float)((x0 + col) * stride);
    const float py = (float)(height - 1 - (y0 + row) * stride);
    int best = 0;
    for (int first = 0; first < total; first += kRound) {
      const int count = min(kRound, total - first);
      if (tid < count) {
        const int t = ids[first + tid];
        const float4* src = tri + 3 * t;
#pragma unroll
        for (int i = 0; i < 3; ++i) staged[4 * tid + i] = __ldg(src + i);
        staged[4 * tid + 3] = box[t];
        staged_id[tid] = kIdMask - t;
      }
      __syncthreads();
      for (int j = 0; warp_live && j < count; ++j) {
        const float4 b = staged[4 * j + 3];
        if (b.x > wx_max || b.y < wx_min || b.z > wy_max || b.w < wy_min) {
          continue;   // uniform across the warp
        }
        const float4 a = staged[4 * j];       // bx by bc gx
        const float4 bb = staged[4 * j + 1];  // gy gc ax ay
        const float4 c = staged[4 * j + 2];   // ac wx wy wc
        const float beta = a.x * px + a.y * py + a.z;
        const float gamma = a.w * px + bb.x * py + bb.y;
        const float alpha = bb.z * px + bb.w * py + c.x;
        const float w = c.y * px + c.z * py + c.w;
        // min(alpha, beta, gamma) >= 0 with NaN failing, as jnp.minimum
        // does.
        if (alpha >= 0.0f && beta >= 0.0f && gamma >= 0.0f) {
          best = max(best, (__float_as_int(w) & ~kIdMask) | staged_id[j]);
        }
      }
      __syncthreads();   // the staging is rewritten by the next round
    }

    if (col < roi_w && row < roi_h) {
      int key = kInvalidKey;
      if (best > 0) {
        // Half-step de-bias of the cleared mantissa bits, then round half
        // to even (jnp.round) and clip to the key's depth range.
        const float w_win =
            __int_as_float((best & ~kIdMask) | (1 << (kTriIdBits - 1)));
        const int tri_id = kIdMask - (best & kIdMask);
        const float depth =
            fminf(fmaxf(rintf(1.0f / w_win), 1.0f), kMaxDepth);
        key = ((int)depth << kTriIdBits) | tri_id;
      }
      keys[(size_t)n * roi_h * roi_w + row * roi_w + col] = key;
    }
  }
}

__global__ void __launch_bounds__(kThreads) keys_setup_kernel(
    const float* __restrict__ verts16,   // [M, 16, T]
    int T,
    const float* __restrict__ pose12,    // [N, 12] model->camera 3x4 (m)
    const int* __restrict__ model_ids,   // [N]
    const float* __restrict__ proj12,    // [12] projection rows 0..2
    int N, int width, int height,
    float4* __restrict__ table,          // [N, T, 3] float4
    float4* __restrict__ bboxes) {       // [N, T]
  __shared__ float4 rows[3 * kThreads];
  const long long total = (long long)N * T;
  const long long first = (long long)blockIdx.x * kThreads;
  const long long row = first + threadIdx.x;
  if (row < total) {
    const int n = (int)(row / T);
    const int t = (int)(row - (long long)n * T);
    const raster_setup::Pose ps =
        raster_setup::load_pose(pose12, proj12, n, width, height);
    const raster_setup::Triangle tri = raster_setup::setup<false>(
        verts16 + (size_t)model_ids[n] * 16 * T, T, t, ps);
    rows[3 * threadIdx.x] = tri.c0;
    rows[3 * threadIdx.x + 1] = tri.c1;
    rows[3 * threadIdx.x + 2] = tri.c2;
    const float inf = __int_as_float(0x7f800000);
    bboxes[row] = tri.ok ? make_float4(tri.xmin, tri.xmax, tri.ymin, tri.ymax)
                         : make_float4(inf, -inf, inf, -inf);
  }
  __syncthreads();
  // The block's rows as consecutive float4s.
  const int count = 3 * (int)(total - first < kThreads ? total - first
                                                       : kThreads);
  for (int i = threadIdx.x; i < count; i += kThreads) {
    table[3 * first + i] = rows[i];
  }
}

}  // namespace

extern "C" int pt_raster_keys(const float* coefs, const float* bboxes,
                              const int* anchors, int N, int T, int height,
                              int stride, int roi_h, int roi_w, int* keys,
                              void* stream) {
  if (N == 0 || roi_h * roi_w == 0) return 0;
  const int ntx = (roi_w + kTile - 1) / kTile;
  const int ntiles = ntx * ((roi_h + kTile - 1) / kTile);
  // The shortest run of tiles that keeps the grid within kWave blocks.
  const long long want = ((long long)N * ntiles + kWave - 1) / kWave;
  const int g = (int)std::min<long long>(ntiles, want);
  const int runs = (ntiles + g - 1) / g;
  if (runs > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  raster_keys_kernel<<<dim3(N, runs), kThreads, smem,
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(coefs),
      reinterpret_cast<const float4*>(bboxes), anchors, T, height, stride,
      roi_h, roi_w, ntx, ntiles, g, keys);
  return (int)cudaGetLastError();
}

extern "C" int pt_keys_setup(const float* verts16, int T, const float* pose12,
                             const int* model_ids, const float* proj12, int N,
                             int width, int height, float* table,
                             float* bboxes, void* stream) {
  if (N == 0 || T == 0) return 0;
  const long long rows = (long long)N * T;
  keys_setup_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads,
                      0, (cudaStream_t)stream>>>(
      verts16, T, pose12, model_ids, proj12, N, width, height,
      reinterpret_cast<float4*>(table), reinterpret_cast<float4*>(bboxes));
  return (int)cudaGetLastError();
}
