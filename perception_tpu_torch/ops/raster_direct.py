"""Direct rasteriser: model bank in, packed (depth, triangle) keys out.

Counterpart of `perception_tpu/ops/pallas_raster_direct.py`. The kernel
(`csrc/raster_direct.cu`) and its PyTorch twin compute the same keys: per
pose, the camera transform, backface cull, projection and coverage/inverse-
depth coefficients of every triangle, then per strided pixel the max over
covered triangles of `(bits(w) & ~2047) | (2047 - tri_id)` and the epilogue
`(rint(1 / w) << 11) | tri_id`. Ties of the truncated w go to the smaller
triangle id; 1/w is de-biased by the half step of the cleared mantissa bits.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops.rasterizer import (
    _INVALID_KEY,
    _MAX_DEPTH,
    MAX_TRIS,
    TRI_ID_BITS,
)

_ID_MASK = MAX_TRIS - 1
# The setup culls a triangle whose screen area is at most this (px^2), as
# the kernel does (pallas_raster_direct.py:155).
AREA_CULL_PX2 = 1e-2
# Elements of one (pose, pixel, triangle) block in the twin: bounds its
# temporaries to ~16 MB each.
_TWIN_BLOCK = 1 << 22


def pack_bank_verts(bank_tri_verts: torch.Tensor, bank_tri_valid: torch.Tensor,
                    bank_backface: torch.Tensor | None) -> torch.Tensor:
    """[M, 16, T] component-major vertex pack: rows v0xyz v1xyz v2xyz, valid,
    cullable, 5 zero rows (the layout of the JAX pack_bank_verts)."""
    m, t = bank_tri_valid.shape
    dev = bank_tri_verts.device
    comp = bank_tri_verts.reshape(m, t, 9).to(torch.float32).transpose(1, 2)
    valid = bank_tri_valid.to(torch.float32)[:, None, :]
    if bank_backface is None:
        cull = torch.zeros((m, 1, t), dtype=torch.float32, device=dev)
    else:
        cull = bank_backface.to(torch.float32)[:, None, None].expand(m, 1, t)
    pad = torch.zeros((m, 5, t), dtype=torch.float32, device=dev)
    return torch.cat([comp, valid, cull, pad], dim=1).contiguous()


def rasterize_direct(verts16: torch.Tensor, pose_mats: torch.Tensor,
                     model_ids: torch.Tensor, anchors: torch.Tensor,
                     proj: torch.Tensor, *, width: int, height: int,
                     stride: int,
                     roi_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Packed keys [N, roi_h * roi_w] int32 (the full strided frame when
    roi_shape is None). CUDA tensors launch the kernel; CPU tensors run the
    twin."""
    args, kw = prepare_inputs(verts16, pose_mats, model_ids, anchors, proj,
                              width=width, height=height, stride=stride,
                              roi_shape=roi_shape)
    if pose_mats.device.type == "cpu":
        build.TWIN_CALLS["raster_direct"] += 1
        return rasterize_direct_twin(*args, **kw)
    return launch_kernel(*args, **kw)


def prepare_inputs(verts16, pose_mats, model_ids, anchors, proj, *, width,
                   height, stride, roi_shape=None) -> tuple[tuple, dict]:
    """The kernel's (and the twin's) arguments: contiguous f32 pose rows
    [N, 12] and projection rows [12], int32 ids and anchors."""
    n = pose_mats.shape[0]
    if roi_shape is None:
        roi_h, roi_w = height // stride, width // stride
        anchors = torch.zeros((n, 2), dtype=torch.int32,
                              device=pose_mats.device)
    else:
        roi_h, roi_w = roi_shape
    args = (verts16.to(torch.float32).contiguous(),
            pose_mats[:, :3, :].reshape(n, 12).to(torch.float32).contiguous(),
            model_ids.to(torch.int32).contiguous(),
            anchors.to(torch.int32).contiguous(),
            proj[:3, :].reshape(12).to(torch.float32).contiguous())
    return args, dict(width=width, height=height, stride=stride, roi_h=roi_h,
                      roi_w=roi_w)


def launch_kernel(verts16, pose12, model_ids, anchors, proj12, *, width,
                  height, stride, roi_h, roi_w) -> torch.Tensor:
    """csrc/raster_direct.cu on CUDA tensors."""
    dev = pose12.device
    if dev.type != "cuda":
        raise ValueError(f"raster_direct kernel: tensors on {dev}")
    n = pose12.shape[0]
    t = verts16.shape[2]
    build.check(verts16, "verts16", torch.float32, (None, 16, None), dev)
    if t > MAX_TRIS:
        raise ValueError(f"raster_direct kernel: {t} triangles > {MAX_TRIS}")
    build.check(pose12, "pose12", torch.float32, (n, 12), dev)
    build.check(model_ids, "model_ids", torch.int32, (n,), dev)
    build.check(anchors, "anchors", torch.int32, (n, 2), dev)
    build.check(proj12, "proj12", torch.float32, (12,), dev)
    keys = torch.empty((n, roi_h * roi_w), dtype=torch.int32, device=dev)
    build.launch("pt_raster_direct", build.ptr(verts16), t, build.ptr(pose12),
                 build.ptr(model_ids), build.ptr(anchors), build.ptr(proj12),
                 n, width, height, stride, roi_h, roi_w, build.ptr(keys))
    return keys


def _triangle_setup(verts16, pose12, model_ids, proj12, width, height,
                    finite_guard: bool = False, areas: bool = False):
    """Per-pose triangle coefficients [N, 12, T], in the kernel's order of
    operations (pallas_raster_direct.py:106-207). finite_guard: also cull
    triangles whose w, beta_c or gamma_c coefficients are not finite, as the
    bin kernel does per triangle (pallas_raster_bin.py:140-144). areas:
    stop at the area cull and return which pairs reach it (valid, facing,
    in front) [N, T] and their screen areas |base| in px^2 [N, T]."""
    v = verts16[model_ids.long()]                    # [N, 16, T]
    p = [pose12[:, i:i + 1] for i in range(12)]      # [N, 1] each
    pr = [float(x) for x in proj12.tolist()]
    hw, hh = width / 2.0, height / 2.0

    def cam(ix):
        vx, vy, vz = v[:, 3 * ix], v[:, 3 * ix + 1], v[:, 3 * ix + 2]
        return (p[0] * vx + p[1] * vy + p[2] * vz + p[3],
                p[4] * vx + p[5] * vy + p[6] * vz + p[7],
                p[8] * vx + p[9] * vy + p[10] * vz + p[11])

    (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = cam(0), cam(1), cam(2)
    valid = v[:, 9] > 0.5
    cullable = v[:, 10] > 0.5
    e1x, e1y, e1z = x1 - x0, y1 - y0, z1 - z0
    e2x, e2y, e2z = x2 - x0, y2 - y0, z2 - z0
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    facing = (nx * x0 + ny * y0 + nz * z0) < 0.0
    ok = valid & (facing | ~cullable)
    z0c, z1c, z2c = z0 * 100.0, z1 * 100.0, z2 * 100.0
    ok = ok & (z0c > 1e-3) & (z1c > 1e-3) & (z2c > 1e-3)

    def screen(xm, ym, zc):
        xc, yc = xm * 100.0, ym * 100.0
        clip_x = xc * pr[0] + yc * pr[1] + zc * pr[2] + pr[3]
        clip_y = yc * pr[5] + zc * pr[6] + pr[7]
        zdiv = torch.where(zc > 1e-3, zc, 1.0)
        return clip_x / zdiv * hw + hw, clip_y / zdiv * hh + hh

    sx0, sy0 = screen(x0, y0, z0c)
    sx1, sy1 = screen(x1, y1, z1c)
    sx2, sy2 = screen(x2, y2, z2c)
    e20x, e20y = sx2 - sx0, sy2 - sy0
    e10x, e10y = sx1 - sx0, sy1 - sy0
    base = 0.5 * (e20x * e10y - e10x * e20y)
    if areas:
        return ok, base.abs()
    ok = ok & (base.abs() > AREA_CULL_PX2)
    sign = torch.where(base >= 0, 1.0, -1.0)
    inv_base = torch.where(ok, 1.0 / torch.where(ok, base, 1.0), 0.0)
    beta_x = -0.5 * e20y * sign
    beta_y = 0.5 * e20x * sign
    beta_c = 0.5 * (sx0 * e20y - sy0 * e20x) * sign
    gamma_x = 0.5 * e10y * sign
    gamma_y = -0.5 * e10x * sign
    gamma_c = 0.5 * (sy0 * e10x - sx0 * e10y) * sign
    iz0 = torch.where(ok, 1.0 / torch.where(ok, z0c, 1.0), 0.0)
    iz1 = torch.where(ok, 1.0 / torch.where(ok, z1c, 1.0), 0.0)
    iz2 = torch.where(ok, 1.0 / torch.where(ok, z2c, 1.0), 0.0)
    d1, d2 = iz1 - iz0, iz2 - iz0
    w_x = (beta_x * sign * d1 + gamma_x * sign * d2) * inv_base
    w_y = (beta_y * sign * d1 + gamma_y * sign * d2) * inv_base
    w_c = iz0 + (beta_c * sign * d1 + gamma_c * sign * d2) * inv_base
    if finite_guard:
        ok = ok & (torch.isfinite(w_x) & torch.isfinite(w_y)
                   & torch.isfinite(w_c) & torch.isfinite(beta_c)
                   & torch.isfinite(gamma_c))
    abs_base = torch.where(ok, base.abs(), float("-inf"))
    coefs = (
        beta_x, beta_y, beta_c, gamma_x, gamma_y, gamma_c,
        -beta_x - gamma_x, -beta_y - gamma_y, abs_base - beta_c - gamma_c,
        w_x, w_y, w_c,
    )
    return torch.stack(coefs, dim=1)                # [N, 12, T]


def rasterize_direct_twin(verts16: torch.Tensor, pose12: torch.Tensor,
                          model_ids: torch.Tensor, anchors: torch.Tensor,
                          proj12: torch.Tensor, *, width: int, height: int,
                          stride: int, roi_h: int, roi_w: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, vectorised over poses, pixels and
    triangles (no bbox cull: the cull never changes a key)."""
    coefs = _triangle_setup(verts16, pose12, model_ids, proj12, width, height)
    return twin_keys(coefs, anchors, height=height, stride=stride,
                     roi_h=roi_h, roi_w=roi_w, w_test=True)


def twin_keys(coefs: torch.Tensor, anchors: torch.Tensor, *, height: int,
              stride: int, roi_h: int, roi_w: int,
              w_test: bool) -> torch.Tensor:
    """The rasters' shared per-pixel pass in plain PyTorch: per strided ROI
    pixel, the max over covered triangles of the packed w key, then the
    epilogue. coefs [N, 12, T] rows (beta, gamma, alpha, w) x (px, py, 1).
    Covered means alpha, beta, gamma >= 0 (NaN fails), and with w_test also
    a finite w > 0 (the direct kernel's test; the coefficient-table and bin
    kernels have none)."""
    n, _, t = coefs.shape
    dev = coefs.device
    npix = roi_h * roi_w
    flat = torch.arange(npix, device=dev)
    px = ((anchors[:, 0:1] + flat % roi_w) * stride).to(torch.float32)
    py = (height - 1 - (anchors[:, 1:2] + flat // roi_w) * stride).to(
        torch.float32)                                # [N, npix]
    ids = _ID_MASK - torch.arange(t, dtype=torch.int32, device=dev)
    best = torch.zeros((n, npix), dtype=torch.int32, device=dev)
    pb = max(1, min(npix, _TWIN_BLOCK // t))
    nb = max(1, _TWIN_BLOCK // (pb * t))
    for i in range(0, n, nb):
        c = coefs[i:i + nb, :, None, :]               # [nb, 12, 1, T]
        for j in range(0, npix, pb):
            x = px[i:i + nb, j:j + pb, None]          # [nb, pb, 1]
            y = py[i:i + nb, j:j + pb, None]

            def affine(r):
                return c[:, r] * x + c[:, r + 1] * y + c[:, r + 2]

            beta, gamma, alpha, w = affine(0), affine(3), affine(6), affine(9)
            covered = (alpha >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
            if w_test:
                covered &= torch.isfinite(w) & (w > 0.0)
            wkey = (w.view(torch.int32) & ~_ID_MASK) | ids
            cand = torch.where(covered, wkey, 0)
            best[i:i + nb, j:j + pb] = cand.amax(dim=-1)
    found = best > 0
    w_win = ((best & ~_ID_MASK) | (1 << (TRI_ID_BITS - 1))).view(torch.float32)
    tri = _ID_MASK - (best & _ID_MASK)
    depth = torch.clamp(torch.round(1.0 / w_win), 1.0, float(_MAX_DEPTH))
    keys = (depth.to(torch.int32) << TRI_ID_BITS) | tri
    return torch.where(found, keys, _INVALID_KEY)
