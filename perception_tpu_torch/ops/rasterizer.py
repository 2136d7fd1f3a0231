"""Batched candidate-pose rendering: strided depth, colour and triangle ids.

Counterpart of `perception_tpu/ops/rasterizer.py`. `backend` picks the
raster, as the JAX package's kernel backends do: the direct kernel
(`ops/raster_direct.py`; "auto", "pallas_direct"), the coefficient-table
kernel (`ops/raster_keys.py`; "pallas") fed by a per-pose triangle setup
(one kernel launch on the card; `keys_setup` below in plain PyTorch on the
CPU), or the scatter-bin kernel (`ops/raster_bin.py`;
"pallas_bin"). The packed keys become depth (int cm), winning triangle id
and face colour; then the occlusion pass against the observed source images
removes render pixels hidden behind closer source geometry of another
segment, and counts `clutter_ratio`; with `use_tree_occlusion` (the tree
search's composed sources) a render in front of the source at a mismatching
pixel sets `pose_occluded`.
"""

from __future__ import annotations

import dataclasses

import torch

from perception_tpu_torch.ops.numerics import div

# Triangle-id bits in the packed z-buffer key. depth_cm < 2^20, tri_id < 2^11.
TRI_ID_BITS = 11
MAX_TRIS = 1 << TRI_ID_BITS
_MAX_DEPTH = (1 << 20) - 2
_INVALID_KEY = 2**31 - 1
# Kernel backends of the port ("auto" is the direct kernel on every device).
BACKENDS = ("auto", "pallas_direct", "pallas", "pallas_bin")


def check_backend(backend: str) -> None:
    """Raise unless the port has this kernel backend: "xla" (the composed
    XLA raster and cost) is not ported; the JAX package's *_interpret names
    run its Pallas interpreter and have no counterpart here."""
    if backend == "xla":
        raise NotImplementedError(
            "kernel backend 'xla' (the composed raster and cost) is not "
            "ported to PyTorch yet")
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; the port has "
                         f"{', '.join(BACKENDS)}")


@dataclasses.dataclass
class RenderOutput:
    depth: torch.Tensor          # [N, h, w] int32 cm, 0 = empty
    color: torch.Tensor          # [N, h, w, 3] float32 0..255
    pose_occluded: torch.Tensor  # [N] int32 (tree occlusion only)
    tri_id: torch.Tensor         # [N, h, w] int32 winning triangle, -1 empty
    anchors: torch.Tensor        # [N, 2] int32 strided ROI origin (x0, y0)
    clutter_ratio: torch.Tensor  # [N] float32 % of rendered pixels occluded


def compute_roi_anchors(pose_mats: torch.Tensor, proj: torch.Tensor,
                        width: int, height: int, stride: int,
                        roi_shape: tuple[int, int],
                        model_centers: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Strided ROI origins [N, 2] (x0, y0) centred on each pose's projected
    object centre (model_centers [N, 3], model frame), clamped inside the
    image."""
    roi_h, roi_w = roi_shape
    w_s, h_s = width // stride, height // stride
    rot, t = pose_mats[:, :3, :3], pose_mats[:, :3, 3]
    if model_centers is not None:
        mc = model_centers
        centers = (rot[:, :, 0] * mc[:, None, 0] + rot[:, :, 1] * mc[:, None, 1]
                   + rot[:, :, 2] * mc[:, None, 2] + t) * 100.0
    else:
        centers = t * 100.0
    pr = [float(x) for x in proj[:2].reshape(-1).tolist()]
    z = torch.clamp(centers[:, 2], min=1e-3)
    clip_x = (centers[:, 0] * pr[0] + centers[:, 1] * pr[1]
              + centers[:, 2] * pr[2] + pr[3])
    clip_y = centers[:, 1] * pr[5] + centers[:, 2] * pr[6] + pr[7]
    sx = clip_x / z * (width / 2.0) + width / 2.0
    sy = clip_y / z * (height / 2.0) + height / 2.0
    y_img = (height - 1) - sy
    x0 = torch.round(div(sx, stride)).to(torch.int32) - roi_w // 2
    y0 = torch.round(div(y_img, stride)).to(torch.int32) - roi_h // 2
    x0 = torch.clamp(x0, 0, max(w_s - roi_w, 0))
    y0 = torch.clamp(y0, 0, max(h_s - roi_h, 0))
    return torch.stack([x0, y0], dim=1)


def model_centers(bank_tri_verts: torch.Tensor,
                  bank_tri_valid: torch.Tensor) -> torch.Tensor:
    """[M, 3] mean of each model's valid triangle vertices (summed in float64,
    so the f32 result does not depend on the device's summation order)."""
    counts = torch.clamp(bank_tri_valid.sum(dim=1), min=1)[:, None]
    masked = bank_tri_verts.double() * bank_tri_valid[..., None, None]
    return (masked.sum(dim=(1, 2)) / (3.0 * counts)).float()


def screen_vertices(tri_v_cam_cm: torch.Tensor, proj: torch.Tensor,
                    width: int, height: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame (cm) triangle vertices [..., 3(vert), 3(xyz)] -> screen
    points [..., 3, 2] and depths [..., 3]: clip = proj @ v, divided by the
    pre-projection z (no guard: triangle_coefficients culls z <= 1e-3)."""
    pr = [float(x) for x in proj[:2].reshape(-1).tolist()]
    x, y, z = tri_v_cam_cm[..., 0], tri_v_cam_cm[..., 1], tri_v_cam_cm[..., 2]
    clip_x = x * pr[0] + y * pr[1] + z * pr[2] + pr[3]
    clip_y = y * pr[5] + z * pr[6] + pr[7]
    sx = clip_x / z * (width / 2.0) + width / 2.0
    sy = clip_y / z * (height / 2.0) + height / 2.0
    return torch.stack([sx, sy], dim=-1), z


def triangle_coefficients(pts2: torch.Tensor, z: torch.Tensor,
                          tri_ok: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-triangle affine functionals of the screen position (px, py, 1):
    (coefs [..., T, 3, 3] rows beta, gamma (sign-adjusted, unnormalised)
    and w = 1/depth; abs_base [..., T] = |base|, the coverage test's third
    bound; ok [..., T]). Triangles of projected area <= 0.01 px^2 or behind
    z = 1e-3 are culled. The JAX package's function in the same order of
    operations, without the vertex depth range its XLA raster clamps to."""
    p0, p1, p2 = pts2[..., 0, :], pts2[..., 1, :], pts2[..., 2, :]
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    e20 = p2 - p0
    e10 = p1 - p0
    base = 0.5 * (e20[..., 0] * e10[..., 1] - e10[..., 0] * e20[..., 1])
    ok = (tri_ok & (base.abs() > 1e-2) & (z0 > 1e-3) & (z1 > 1e-3)
          & (z2 > 1e-3))
    sign = torch.where(base >= 0, 1.0, -1.0)
    inv_base = torch.where(ok, 1.0 / torch.where(ok, base, 1.0), 0.0)
    beta_x = -0.5 * e20[..., 1]
    beta_y = 0.5 * e20[..., 0]
    beta_c = 0.5 * (p0[..., 0] * e20[..., 1] - p0[..., 1] * e20[..., 0])
    gamma_x = 0.5 * e10[..., 1]
    gamma_y = -0.5 * e10[..., 0]
    gamma_c = 0.5 * (p0[..., 1] * e10[..., 0] - p0[..., 0] * e10[..., 1])
    iz0 = torch.where(ok, 1.0 / torch.where(ok, z0, 1.0), 0.0)
    iz1 = torch.where(ok, 1.0 / torch.where(ok, z1, 1.0), 0.0)
    iz2 = torch.where(ok, 1.0 / torch.where(ok, z2, 1.0), 0.0)
    d1, d2 = iz1 - iz0, iz2 - iz0
    w_x = (beta_x * d1 + gamma_x * d2) * inv_base
    w_y = (beta_y * d1 + gamma_y * d2) * inv_base
    w_c = iz0 + (beta_c * d1 + gamma_c * d2) * inv_base
    coefs = torch.stack([
        torch.stack([beta_x, beta_y, beta_c], dim=-1) * sign[..., None],
        torch.stack([gamma_x, gamma_y, gamma_c], dim=-1) * sign[..., None],
        torch.stack([w_x, w_y, w_c], dim=-1),
    ], dim=-2)
    return coefs, base.abs(), ok


def keys_setup(bank_tri_verts: torch.Tensor, bank_tri_valid: torch.Tensor,
               pose_mats: torch.Tensor, model_ids: torch.Tensor,
               proj: torch.Tensor, width: int, height: int,
               bank_backface: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The coefficient-table raster's per-pose triangle setup (the JAX
    render_pose_batch's setup_pallas): camera transform, backface cull by
    the cross product in metres, x100 to cm, projection, coefficients, and
    each triangle's screen bbox (xmin, xmax, ymin, ymax; +-inf when culled).
    Element-wise in a fixed order (no matmul), so it rounds alike on the
    CPU and the card. Returns (coefs [N, T, 3, 3], abs_base [N, T],
    ok [N, T], bboxes [N, T, 4])."""
    tv = bank_tri_verts[model_ids]                   # [N, T, 3, 3]
    ok = bank_tri_valid[model_ids]
    r = [pose_mats[:, i, j, None, None] for i in range(3) for j in range(4)]
    vx, vy, vz = tv[..., 0], tv[..., 1], tv[..., 2]  # [N, T, 3]
    cx = r[0] * vx + r[1] * vy + r[2] * vz + r[3]
    cy = r[4] * vx + r[5] * vy + r[6] * vz + r[7]
    cz = r[8] * vx + r[9] * vy + r[10] * vz + r[11]
    if bank_backface is not None:
        e1x, e1y, e1z = (cx[..., 1] - cx[..., 0], cy[..., 1] - cy[..., 0],
                         cz[..., 1] - cz[..., 0])
        e2x, e2y, e2z = (cx[..., 2] - cx[..., 0], cy[..., 2] - cy[..., 0],
                         cz[..., 2] - cz[..., 0])
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        facing = (nx * cx[..., 0] + ny * cy[..., 0] + nz * cz[..., 0]) < 0.0
        ok = ok & (facing | ~bank_backface[model_ids][:, None])
    v_cam = torch.stack([cx, cy, cz], dim=-1) * 100.0
    pts2, z = screen_vertices(v_cam, proj, width, height)
    coefs, abs_base, cok = triangle_coefficients(pts2, z, ok)
    inf = float("inf")
    bbox = torch.stack([
        torch.where(cok, pts2[..., 0].amin(dim=-1), inf),
        torch.where(cok, pts2[..., 0].amax(dim=-1), -inf),
        torch.where(cok, pts2[..., 1].amin(dim=-1), inf),
        torch.where(cok, pts2[..., 1].amax(dim=-1), -inf),
    ], dim=-1)
    return coefs, abs_base, cok, bbox


def render_pose_batch(
    bank_tri_verts: torch.Tensor,    # [M, T, 3, 3] float32 model frame (m)
    bank_tri_colors: torch.Tensor,   # [M, T, 3] float32 0..255
    bank_tri_valid: torch.Tensor,    # [M, T] bool
    pose_mats: torch.Tensor,         # [N, 4, 4] model->camera (m)
    pose_model_ids: torch.Tensor,    # [N] int
    proj: torch.Tensor,              # [4, 4] projection (cm near/far)
    *,
    width: int,
    height: int,
    stride: int = 1,
    source_depth: torch.Tensor | None = None,  # [h, w] int32 cm, strided
    source_label: torch.Tensor | None = None,  # [h, w] int32 1-based labels
    pose_labels: torch.Tensor | None = None,   # [N] int 0-based labels
    occlusion_threshold: float = 1.0,           # cm
    use_segmentation_label: bool = False,
    use_tree_occlusion: bool = False,
    roi_shape: tuple[int, int] | None = None,   # (roi_h, roi_w) strided
    bank_backface: torch.Tensor | None = None,  # [M] bool watertight models
    backend: str = "auto",   # "auto" | "pallas_direct" | "pallas" | "pallas_bin"
) -> RenderOutput:
    """Render N candidate poses as strided depth + colour images with the
    occlusion pass. With roi_shape each pose renders a window centred on
    its projected model centre; `anchors` gives each window's origin."""
    check_backend(backend)
    from perception_tpu_torch.ops import raster_bin, raster_direct, raster_keys

    n = pose_mats.shape[0]
    dev = pose_mats.device
    ids = pose_model_ids.long()
    if roi_shape is not None:
        out_h, out_w = roi_shape
        centers = model_centers(bank_tri_verts, bank_tri_valid)
        anchors = compute_roi_anchors(pose_mats, proj, width, height, stride,
                                      roi_shape, model_centers=centers[ids])
    else:
        out_h, out_w = height // stride, width // stride
        anchors = torch.zeros((n, 2), dtype=torch.int32, device=dev)

    geometry = dict(width=width, height=height, stride=stride,
                    roi_shape=roi_shape)
    if backend == "pallas":
        # The table's setup: one kernel launch on the card, PyTorch on the
        # CPU.
        if dev.type == "cpu":
            coefs, abs_base, ok, bboxes = keys_setup(
                bank_tri_verts, bank_tri_valid, pose_mats, ids, proj, width,
                height, bank_backface)
            table = raster_keys.pack_coefficients(coefs, abs_base, ok)
        else:
            table, bboxes = raster_keys.setup_table(
                raster_direct.pack_bank_verts(bank_tri_verts, bank_tri_valid,
                                              bank_backface),
                pose_mats, ids, proj, width=width, height=height)
        keys = raster_keys.rasterize_keys(table, bboxes, anchors, **geometry)
    else:
        verts16 = raster_direct.pack_bank_verts(bank_tri_verts, bank_tri_valid,
                                                bank_backface)
        raster = (raster_bin.rasterize_bin if backend == "pallas_bin"
                  else raster_direct.rasterize_direct)
        keys = raster(verts16, pose_mats, ids, anchors, proj, **geometry)

    empty = keys == _INVALID_KEY
    depth = torch.where(empty, 0, keys >> TRI_ID_BITS)
    tri_id = torch.where(empty, -1, keys & (MAX_TRIS - 1))
    color = bank_tri_colors[ids[:, None], tri_id.clamp(min=0).long()]
    color = torch.where(empty[..., None], 0.0, color)

    pose_occluded = torch.zeros((n,), dtype=torch.int32, device=dev)
    clutter_ratio = torch.zeros((n,), dtype=torch.float32, device=dev)
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
            plab = pose_labels[:, None].to(torch.int32)
            mismatch = (plab != slab - 1) & (diff > 0.5)
        else:
            mismatch = diff > occlusion_threshold
        present = ~empty
        removed = present & mismatch & (depth > src) & (src > 0)
        if use_tree_occlusion:
            # The tree search's composed source: a render in front of the
            # source at a mismatching pixel flags the whole pose.
            occluding = present & mismatch & (depth <= src) & (src > 0)
            pose_occluded = occluding.any(dim=1).to(torch.int32)
        # Clutter: rendered pixels hidden behind clearly closer (>= 5 cm)
        # source geometry.
        clutter = removed & (src <= depth - 5)
        total = present.sum(dim=1).to(torch.float32)
        clutter_ratio = (clutter.sum(dim=1) / torch.clamp(total, min=1.0)
                         * 100.0)
        depth = torch.where(removed, 0, depth)
        tri_id = torch.where(removed, -1, tri_id)
        color = torch.where(removed[..., None], 0.0, color)

    return RenderOutput(
        depth=depth.reshape(n, out_h, out_w),
        color=color.reshape(n, out_h, out_w, 3),
        pose_occluded=pose_occluded,
        tri_id=tri_id.reshape(n, out_h, out_w),
        anchors=anchors,
        clutter_ratio=clutter_ratio,
    )
