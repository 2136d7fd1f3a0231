// Direct rasteriser: model bank + poses in, packed depth/triangle keys out.
//
// Replaces rasterize_direct_pallas (perception_tpu/ops/pallas_raster_direct.py:320,
// kernel _kernel at :94-299). Per pose: camera transform of the model's
// triangles, backface cull, projection, edge and inverse-depth coefficients;
// then per strided pixel the max over triangles of the key
// (bits(w) & ~2047) | (2047 - tri_id) over the triangles that cover it with
// a finite w > 0, and an epilogue to (rint(1/w) << 11) | tri_id.
//
// What bounds it on the H100: the bytes are tiny (the bank once, the keys
// once: 8.6 MB at 2048 poses x 32x32 pixels, 0.0026 ms at 3.35 TB/s), so
// the time is instructions and latency, and at the bench scene almost all
// of them are overhead: only 0.4% (ROI) and 0.09% (80x60 full frame) of the
// (pixel, triangle) pairs lie in a triangle's screen box. What is left to
// keep small: the cull (a box test per triangle and pixel tile), the setup
// (~400 instructions per triangle with its IEEE divisions, paid again by
// every block that sets a pose up) and each block's fixed latency (loads,
// barriers), which at these shapes outweighs the coverage tests.
//
// The design:
//   * square tiles of 16x16 strided pixels, one thread per pixel with its
//     own running max: no atomics, so the keys are deterministic. Edge
//     tiles of a ragged ROI (80x60: a 12-row last tile row; 24x24: 8-wide
//     tiles) are masked at the store;
//   * a block of 256 threads takes a run of G consecutive tiles of one pose
//     and sets the pose's triangles up once for all of them: G is the
//     shortest run that keeps the grid within kWave = 1024 blocks, at most
//     a pose's tiles. So at the scoring batches (N = 2048) a block takes
//     the whole pose (4 tiles at the ROI, 20 at the 80x60 full frame), and
//     runs of 4 tiles at the 640x480 observation (N = 3, 1200 tiles);
//   * where a pose still spans several blocks and its setup takes more
//     than one pass (T > 256), two blocks form a thread-block cluster and
//     split the setup: block r sets up triangles [r * own, (r + 1) * own),
//     own = ceil(T / C), into its shared memory (three coefficient float4s
//     and the 1-px-widened screen box each), and reads its partner's
//     through distributed shared memory (cluster.map_shared_rank);
//   * the cull is cooperative: per tile, thread j tests triangle j's box
//     against the tile's own x and y extents (256 triangles per pass), and
//     a warp vote (__ballot_sync, __popc prefix counts, per-warp offsets)
//     compacts the survivors, in ascending order, into a shared id list;
//   * survivors' setup is staged in the block's own shared memory, 256 per
//     round; after the block's last copy a cluster barrier releases the
//     owners. Warp w covers an 8x4 pixel patch of the tile and skips, as a
//     whole, every survivor whose box misses the patch; the others cost
//     three broadcast float4 loads and 16 flops per pixel.
// Measured on the H100 at the bench shapes (PERF.md): one tile per block in
// clusters of 4-8 that split the setup lost to per-block setup at the ROI
// and the full frame, where T = 256 is a single setup pass whichever block
// runs it and the cluster barriers and co-scheduling cost more than the
// split saves; runs of tiles per block won at every shape, and a cluster
// of 2 on top of them only at T = 1024 (the observation raster).
// The cull never drops a covering triangle: a pixel of the tile lies inside
// the tile's extents, and a covered pixel lies inside the widened box (the
// premise every box cull of this repository's rasters rests on, held on
// bench poses by tests/test_torch_raster_cull.py). A max does not depend on
// the order of its terms, so the keys are those of the twin, which culls
// nothing. Any T up to 2048: shared memory is 64 B per owned triangle, 4 B
// per triangle id and 17 KB of staging (T = 256, C = 1: 34 KB; T = 2048,
// C = 1: 153 KB, opted in above 48 KB); 62 registers, no spills
// (`-Xptxas -v`).
// Built with --fmad=false so every product rounds as in the PyTorch twin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // tile side in strided pixels
constexpr int kRound = 256;        // survivors staged per round
// About two waves: 62 registers (64 as allocated) x 256 threads leave room
// for 4 resident blocks per SM, 528 on the 132 SMs. Of the run lengths
// tried on the card at the observation shape, this bound's runs of 4 tiles
// were the fastest.
constexpr int kWave = 1024;
constexpr int kTriIdBits = 11;
constexpr int kIdMask = (1 << kTriIdBits) - 1;
constexpr float kMaxDepth = float((1 << 20) - 2);
constexpr int kInvalidKey = 0x7fffffff;

// Dynamic shared memory: owned setup [own][4] float4, staged survivors
// [kRound][4] float4, their key ids [kRound] and the survivor list [T].
size_t smem_bytes(int T, int own) {
  return (size_t)(own + kRound) * 4 * sizeof(float4) +
         (size_t)(kRound + T) * sizeof(int);
}

// Triangle t's setup (four float4s), from this block or through
// distributed shared memory from its owner.
__device__ __forceinline__ const float4* setup_of(
    cg::cluster_group cluster, float4* tri, int t, int own, int rank) {
  const int o = t / own;
  const int slot = 4 * (t - o * own);
  return o == rank ? tri + slot : cluster.map_shared_rank(tri, o) + slot;
}

__global__ void __launch_bounds__(kThreads) raster_direct_kernel(
    const float* __restrict__ verts16,   // [M, 16, T]
    int T,
    const float* __restrict__ pose12,    // [N, 12] model->camera 3x4 (m)
    const int* __restrict__ model_ids,   // [N]
    const int* __restrict__ anchors,     // [N, 2] strided ROI origin (x0, y0)
    const float* __restrict__ proj12,    // [12] projection rows 0..2
    int width, int height, int stride, int roi_h, int roi_w, int ntx,
    int ntiles, int per_block, int own,
    int* __restrict__ keys) {            // [N, roi_h * roi_w]
  extern __shared__ float4 smem[];
  float4* tri = smem;                                      // [own][4]
  float4* staged = tri + 4 * own;                          // [kRound][4]
  int* staged_id = reinterpret_cast<int*>(staged + 4 * kRound);  // [kRound]
  int* ids = staged_id + kRound;                           // [T]
  __shared__ int warp_count[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x0 = anchors[2 * n];
  const int y0 = anchors[2 * n + 1];

  // (1) This block's share of the pose's triangle setup.
  {
    const float* vb = verts16 + (size_t)model_ids[n] * 16 * T;
    float p[12], pr[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      p[i] = pose12[n * 12 + i];
      pr[i] = proj12[i];
    }
    const float hw = 0.5f * (float)width;
    const float hh = 0.5f * (float)height;
    for (int s = tid; s < own; s += kThreads) {
      const int t = rank * own + s;
      if (t >= T) break;
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

      tri[4 * s] = make_float4(beta_x, beta_y, beta_c, gamma_x);
      tri[4 * s + 1] = make_float4(gamma_y, gamma_c, -beta_x - gamma_x,
                                   -beta_y - gamma_y);
      tri[4 * s + 2] = make_float4(
          abs_base - beta_c - gamma_c,
          (beta_x * sign * d1 + gamma_x * sign * d2) * inv_base,
          (beta_y * sign * d1 + gamma_y * sign * d2) * inv_base,
          iz0 + (beta_c * sign * d1 + gamma_c * sign * d2) * inv_base);
      // Screen box with a 1 px margin; invalid triangles never overlap.
      tri[4 * s + 3] =
          ok ? make_float4(fminf(sx[0], fminf(sx[1], sx[2])) - 1.0f,
                           fmaxf(sx[0], fmaxf(sx[1], sx[2])) + 1.0f,
                           fminf(sy[0], fminf(sy[1], sy[2])) - 1.0f,
                           fmaxf(sy[0], fmaxf(sy[1], sy[2])) + 1.0f)
             : make_float4(3e38f, -3e38f, 3e38f, -3e38f);
    }
  }
  cluster.sync();   // every block's setup is visible cluster-wide

  // (2) Per tile of this block's run of `per_block` consecutive tiles: cull
  // the pose's triangles against the tile's extents and compact the
  // survivors' ids, ascending, into ids[0, total); then (3) stage them
  // locally, kRound at a time, and rasterise them.
  const int tile0 = blockIdx.y * per_block;
  const int my_tiles = max(0, min(per_block, ntiles - tile0));
  if (my_tiles == 0) cluster.sync();   // a padding block: setup only
  for (int g = 0; g < my_tiles; ++g) {
    const int tile = tile0 + g;
    const int c0 = (tile % ntx) * kTile, r0 = (tile / ntx) * kTile;
    const int c1 = min(c0 + kTile - 1, roi_w - 1);
    const int r1 = min(r0 + kTile - 1, roi_h - 1);
    const float tx_min = (float)((x0 + c0) * stride);
    const float tx_max = (float)((x0 + c1) * stride);
    const float ty_max = (float)(height - 1 - (y0 + r0) * stride);
    const float ty_min = (float)(height - 1 - (y0 + r1) * stride);
    int total = 0;
    for (int base = 0; base < T; base += kThreads) {
      const int t = base + tid;
      bool keep = false;
      if (t < T) {
        const float4 b = setup_of(cluster, tri, t, own, rank)[3];
        keep = !(b.x > tx_max || b.y < tx_min || b.z > ty_max ||
                 b.w < ty_min);
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

    // Warp w covers the 8x4 pixels at tile column 8 (w % 2), row 4 (w / 2);
    // a survivor whose box misses the warp's pixels is skipped by the whole
    // warp (a triangle of a few pixels meets few of the tile's 8 warps).
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
    const int rounds = max(1, (total + kRound - 1) / kRound);
    for (int r = 0; r < rounds; ++r) {
      const int first = r * kRound;
      const int count = min(kRound, total - first);
      if (tid < count) {
        const int t = ids[first + tid];
        const float4* src = setup_of(cluster, tri, t, own, rank);
#pragma unroll
        for (int i = 0; i < 4; ++i) staged[4 * tid + i] = src[i];
        staged_id[tid] = kIdMask - t;
      }
      // After this block's last copy it reads no other block's shared
      // memory: one cluster barrier lets every block go on (and exit).
      if (g == my_tiles - 1 && r == rounds - 1) {
        cluster.sync();
      } else {
        __syncthreads();
      }
      for (int j = 0; warp_live && j < count; ++j) {
        const float4 box = staged[4 * j + 3];
        if (box.x > wx_max || box.y < wx_min || box.z > wy_max ||
            box.w < wy_min) {
          continue;   // uniform across the warp
        }
        const float4 a = staged[4 * j];       // bx by bc gx
        const float4 b = staged[4 * j + 1];   // gy gc ax ay
        const float4 c = staged[4 * j + 2];   // ac wx wy wc
        const float beta = a.x * px + a.y * py + a.z;
        const float gamma = a.w * px + b.x * py + b.y;
        const float alpha = b.z * px + b.w * py + c.x;
        const float w = c.y * px + c.z * py + c.w;
        // min(alpha, beta, gamma) >= 0 with NaN failing, as jnp.minimum
        // does.
        const bool covered = alpha >= 0.0f && beta >= 0.0f &&
                             gamma >= 0.0f && isfinite(w) && w > 0.0f;
        if (covered) {
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

}  // namespace

extern "C" int pt_raster_direct(const float* verts16, int T,
                                const float* pose12, const int* model_ids,
                                const int* anchors, const float* proj12, int N,
                                int width, int height, int stride, int roi_h,
                                int roi_w, int* keys, void* stream) {
  if (N == 0 || roi_h * roi_w == 0) return 0;
  const int ntx = (roi_w + kTile - 1) / kTile;
  const int ntiles = ntx * ((roi_h + kTile - 1) / kTile);
  // The shortest run of tiles that keeps the grid within kWave blocks; a
  // cluster of 2 where the setup takes more than one pass and a pose spans
  // several blocks.
  const long long want = ((long long)N * ntiles + kWave - 1) / kWave;
  const int g = (int)std::min<long long>(ntiles, want);
  const int runs = (ntiles + g - 1) / g;
  const int c = T > kThreads && runs > 1 ? 2 : 1;
  const int blocks = (runs + c - 1) / c * c;
  if (blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  const int own = (T + c - 1) / c;
  const size_t smem = smem_bytes(T, own);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N, blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = c;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, raster_direct_kernel, verts16, T, pose12, model_ids, anchors,
      proj12, width, height, stride, roi_h, roi_w, ntx, ntiles, g, own, keys);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
