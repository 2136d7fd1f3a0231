"""Plain PyTorch rasteriser: strided depth per candidate pose, with the
occlusion pass against the observed source.

A frozen copy of the port's direct raster as its plain version computes it
(`ops/rasterizer.py` `render_pose_batch` with the direct backend,
`ops/raster_direct.py` setup and per-pixel pass): per pose the camera
transform, backface cull, projection and coverage / inverse-depth
coefficients of every triangle; per strided pixel the nearest covered
triangle as a packed (w, triangle id) key; then depth in int cm.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.numerics import div

TRI_ID_BITS = 11
MAX_TRIS = 1 << TRI_ID_BITS
_ID_MASK = MAX_TRIS - 1
_MAX_DEPTH = (1 << 20) - 2
INVALID_KEY = 2**31 - 1
AREA_CULL_PX2 = 1e-2
# Elements of one (pose, pixel, triangle) block.
_BLOCK = 1 << 22


@dataclasses.dataclass
class Render:
    depth: torch.Tensor          # [N, h, w] int32 cm, 0 empty
    pose_occluded: torch.Tensor  # [N] int32
    anchors: torch.Tensor        # [N, 2] int32 strided ROI origin
    w: torch.Tensor              # [N, h, w] float32 winning 1/depth (1/cm)


def pack_bank_verts(tri_verts, tri_valid, cullable) -> torch.Tensor:
    """[M, 16, T]: v0xyz v1xyz v2xyz, valid, cullable, five zero rows."""
    m, t = tri_valid.shape
    dev = tri_verts.device
    comp = tri_verts.reshape(m, t, 9).to(torch.float32).transpose(1, 2)
    valid = tri_valid.to(torch.float32)[:, None, :]
    if cullable is None:
        cull = torch.zeros((m, 1, t), dtype=torch.float32, device=dev)
    else:
        cull = cullable.to(torch.float32)[:, None, None].expand(m, 1, t)
    pad = torch.zeros((m, 5, t), dtype=torch.float32, device=dev)
    return torch.cat([comp, valid, cull, pad], dim=1).contiguous()


def model_centers(tri_verts, tri_valid) -> torch.Tensor:
    counts = torch.clamp(tri_valid.sum(dim=1), min=1)[:, None]
    masked = tri_verts.double() * tri_valid[..., None, None]
    return (masked.sum(dim=(1, 2)) / (3.0 * counts)).float()


def roi_anchors(pose_mats, proj, width, height, stride, roi_shape,
                centers) -> torch.Tensor:
    """Strided ROI origins (x0, y0) centred on each pose's projected model
    centre, clamped inside the image."""
    roi_h, roi_w = roi_shape
    w_s, h_s = width // stride, height // stride
    rot, t = pose_mats[:, :3, :3], pose_mats[:, :3, 3]
    mc = centers
    c = (rot[:, :, 0] * mc[:, None, 0] + rot[:, :, 1] * mc[:, None, 1]
         + rot[:, :, 2] * mc[:, None, 2] + t) * 100.0
    pr = [float(x) for x in proj[:2].reshape(-1).tolist()]
    z = torch.clamp(c[:, 2], min=1e-3)
    clip_x = c[:, 0] * pr[0] + c[:, 1] * pr[1] + c[:, 2] * pr[2] + pr[3]
    clip_y = c[:, 1] * pr[5] + c[:, 2] * pr[6] + pr[7]
    sx = clip_x / z * (width / 2.0) + width / 2.0
    sy = clip_y / z * (height / 2.0) + height / 2.0
    y_img = (height - 1) - sy
    x0 = torch.round(div(sx, stride)).to(torch.int32) - roi_w // 2
    y0 = torch.round(div(y_img, stride)).to(torch.int32) - roi_h // 2
    x0 = torch.clamp(x0, 0, max(w_s - roi_w, 0))
    y0 = torch.clamp(y0, 0, max(h_s - roi_h, 0))
    return torch.stack([x0, y0], dim=1)


def triangle_setup(verts16, pose12, model_ids, proj12, width, height):
    """Per-pose triangle coefficients [N, 12, T]."""
    v = verts16[model_ids.long()]
    p = [pose12[:, i:i + 1] for i in range(12)]
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
    abs_base = torch.where(ok, base.abs(), float("-inf"))
    coefs = (beta_x, beta_y, beta_c, gamma_x, gamma_y, gamma_c,
             -beta_x - gamma_x, -beta_y - gamma_y, abs_base - beta_c - gamma_c,
             w_x, w_y, w_c)
    return torch.stack(coefs, dim=1)


def pixel_keys(coefs, anchors, *, height, stride, roi_h, roi_w):
    """Per strided ROI pixel the max over covered triangles of the packed
    (w, 2047 - triangle) key -> (keys [N, npix] int32, winning w)."""
    n, _, t = coefs.shape
    dev = coefs.device
    npix = roi_h * roi_w
    flat = torch.arange(npix, device=dev)
    px = ((anchors[:, 0:1] + flat % roi_w) * stride).to(torch.float32)
    py = (height - 1 - (anchors[:, 1:2] + flat // roi_w) * stride).to(
        torch.float32)
    ids = _ID_MASK - torch.arange(t, dtype=torch.int32, device=dev)
    best = torch.zeros((n, npix), dtype=torch.int32, device=dev)
    pb = max(1, min(npix, _BLOCK // t))
    nb = max(1, _BLOCK // (pb * t))
    for i in range(0, n, nb):
        c = coefs[i:i + nb, :, None, :]
        for j in range(0, npix, pb):
            x = px[i:i + nb, j:j + pb, None]
            y = py[i:i + nb, j:j + pb, None]

            def affine(r):
                return c[:, r] * x + c[:, r + 1] * y + c[:, r + 2]

            beta, gamma, alpha, w = affine(0), affine(3), affine(6), affine(9)
            covered = ((alpha >= 0.0) & (beta >= 0.0) & (gamma >= 0.0)
                       & torch.isfinite(w) & (w > 0.0))
            wkey = (w.view(torch.int32) & ~_ID_MASK) | ids
            best[i:i + nb, j:j + pb] = torch.where(covered, wkey, 0).amax(-1)
    found = best > 0
    w_win = ((best & ~_ID_MASK) | (1 << (TRI_ID_BITS - 1))).view(torch.float32)
    tri = _ID_MASK - (best & _ID_MASK)
    depth = torch.clamp(torch.round(1.0 / w_win), 1.0, float(_MAX_DEPTH))
    keys = (depth.to(torch.int32) << TRI_ID_BITS) | tri
    return torch.where(found, keys, INVALID_KEY), torch.where(found, w_win,
                                                              0.0)


def render(tri_verts, tri_valid, pose_mats, model_ids, proj, *,
           width, height, stride=1, source_depth=None, source_label=None,
           pose_labels=None, occlusion_threshold=1.0,
           use_segmentation_label=False, use_tree_occlusion=False,
           roi_shape=None, cullable=None, quant=None) -> Render:
    """Render N poses as strided depth images, then
    remove pixels behind the observed source of another segment (and with
    use_tree_occlusion flag a pose in front of it). `quant` rounds the
    vertices and poses, the control's lower precision."""
    n = pose_mats.shape[0]
    dev = pose_mats.device
    ids = model_ids.long()
    if quant is not None:
        tri_verts, pose_mats = quant(tri_verts), quant(pose_mats)
    if roi_shape is not None:
        out_h, out_w = roi_shape
        anchors = roi_anchors(pose_mats, proj, width, height, stride,
                              roi_shape, model_centers(tri_verts,
                                                       tri_valid)[ids])
    else:
        out_h, out_w = height // stride, width // stride
        anchors = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    verts16 = pack_bank_verts(tri_verts, tri_valid, cullable)
    pose12 = pose_mats[:, :3, :].reshape(n, 12).to(torch.float32).contiguous()
    proj12 = proj[:3, :].reshape(12).to(torch.float32).contiguous()
    coefs = triangle_setup(verts16, pose12, ids.to(torch.int32), proj12,
                           width, height)
    keys, w = pixel_keys(coefs, anchors.to(torch.int32), height=height,
                         stride=stride, roi_h=out_h, roi_w=out_w)

    empty = keys == INVALID_KEY
    depth = torch.where(empty, 0, keys >> TRI_ID_BITS)
    pose_occluded = torch.zeros((n,), dtype=torch.int32, device=dev)
    if source_depth is not None:
        if roi_shape is not None:
            ly = torch.arange(out_h, device=dev).repeat_interleave(out_w)
            lx = torch.arange(out_w, device=dev).repeat(out_h)
            rows = anchors[:, 1:2].long() + ly
            cols = anchors[:, 0:1].long() + lx
            src = source_depth[rows, cols].to(torch.int32)
            if use_segmentation_label:
                slab = source_label[rows, cols].to(torch.int32)
        else:
            src = source_depth.reshape(1, -1).to(torch.int32)
            if use_segmentation_label:
                slab = source_label.reshape(1, -1).to(torch.int32)
        diff = (depth - src).abs().to(torch.float32)
        if use_segmentation_label:
            mismatch = ((pose_labels[:, None].to(torch.int32) != slab - 1)
                        & (diff > 0.5))
        else:
            mismatch = diff > occlusion_threshold
        present = ~empty
        removed = present & mismatch & (depth > src) & (src > 0)
        if use_tree_occlusion:
            occluding = present & mismatch & (depth <= src) & (src > 0)
            pose_occluded = occluding.any(dim=1).to(torch.int32)
        depth = torch.where(removed, 0, depth)
        w = torch.where(removed, 0.0, w)
    return Render(depth=depth.reshape(n, out_h, out_w),
                  pose_occluded=pose_occluded, anchors=anchors,
                  w=w.reshape(n, out_h, out_w))
