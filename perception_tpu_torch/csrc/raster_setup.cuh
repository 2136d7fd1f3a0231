// Per-triangle raster setup shared by the scatter-bin raster
// (raster_bin.cu) and the coefficient-table setup (raster_keys.cu,
// pt_keys_setup): camera transform, backface cull, x100 to cm, projection,
// edge and inverse-depth coefficients, in the order of operations of
// rasterizer.keys_setup / triangle_coefficients and of
// raster_direct._triangle_setup (the twins), so every product rounds where
// theirs does (the sources are built with --fmad=false and IEEE division).
//
// A triangle is drawable (`ok`) when it is valid, faces the camera or is not
// cullable, lies in front of z = 1e-3 cm and covers more than 0.01 px^2;
// with kFiniteGuard also when its w, beta_c and gamma_c coefficients are
// finite (the bin raster's per-triangle guard, pallas_raster_bin.py:140-144).
// A culled triangle gets alpha_c = -inf, so no coverage test passes; its
// other coefficients are not read by any raster.
#pragma once

#include <cuda_runtime.h>

namespace raster_setup {

// One pose's constants: model->camera rows (m) and projection rows 0..2.
struct Pose {
  float p[12];
  float pr[12];
  float hw, hh;   // half the frame's width and height
};

// Coefficients in the rasters' packed order, (bx by bc gx) (gy gc ax ay)
// (ac wx wy wc), and the screen vertices' extents.
struct Triangle {
  float4 c0, c1, c2;
  float xmin, xmax, ymin, ymax;
  bool ok;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ pose12,
                                          const float* __restrict__ proj12,
                                          int n, int width, int height) {
  Pose ps;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    ps.p[i] = pose12[n * 12 + i];
    ps.pr[i] = proj12[i];
  }
  ps.hw = 0.5f * (float)width;
  ps.hh = 0.5f * (float)height;
  return ps;
}

// Triangle t of a model's component-major vertex pack vb [16, T] (rows v0xyz
// v1xyz v2xyz, valid, cullable).
template <bool kFiniteGuard>
__device__ __forceinline__ Triangle setup(const float* __restrict__ vb,
                                          int T, int t, const Pose& ps) {
  const float* p = ps.p;
  const float* pr = ps.pr;
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
    // The guard changes only triangles that the z test culls.
    const float zdiv = zc[v] > 1e-3f ? zc[v] : 1.0f;
    sx[v] = clip_x / zdiv * ps.hw + ps.hw;
    sy[v] = clip_y / zdiv * ps.hh + ps.hh;
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
  // beta_x * sign is the unsigned coefficient exactly (sign is +-1).
  const float w_x = (beta_x * sign * d1 + gamma_x * sign * d2) * inv_base;
  const float w_y = (beta_y * sign * d1 + gamma_y * sign * d2) * inv_base;
  const float w_c = iz0 + (beta_c * sign * d1 + gamma_c * sign * d2) * inv_base;
  if (kFiniteGuard) {
    ok = ok && isfinite(w_x) && isfinite(w_y) && isfinite(w_c) &&
         isfinite(beta_c) && isfinite(gamma_c);
  }

  Triangle tri;
  tri.ok = ok;
  tri.c0 = make_float4(beta_x, beta_y, beta_c, gamma_x);
  tri.c1 = make_float4(gamma_y, gamma_c, -beta_x - gamma_x, -beta_y - gamma_y);
  tri.c2 = make_float4(
      ok ? fabsf(base) - beta_c - gamma_c : -__int_as_float(0x7f800000), w_x,
      w_y, w_c);
  tri.xmin = fminf(sx[0], fminf(sx[1], sx[2]));
  tri.xmax = fmaxf(sx[0], fmaxf(sx[1], sx[2]));
  tri.ymin = fminf(sy[0], fminf(sy[1], sy[2]));
  tri.ymax = fmaxf(sy[0], fmaxf(sy[1], sy[2]));
  return tri;
}

}  // namespace raster_setup
