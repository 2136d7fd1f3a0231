"""Batched candidate-pose rendering: strided depth, colour and triangle ids.

Counterpart of `perception_tpu/ops/rasterizer.py` with the direct kernel
(`ops/raster_direct.py`) as its only raster. The packed keys become depth
(int cm), winning triangle id and face colour; then the occlusion pass
against the observed source images removes render pixels hidden behind
closer source geometry of another segment, and counts `clutter_ratio`.
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


@dataclasses.dataclass
class RenderOutput:
    depth: torch.Tensor          # [N, h, w] int32 cm, 0 = empty
    color: torch.Tensor          # [N, h, w, 3] float32 0..255
    pose_occluded: torch.Tensor  # [N] int32 (always 0: no tree occlusion)
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
) -> RenderOutput:
    """Render N candidate poses as strided depth + colour images with the
    occlusion pass. With roi_shape each pose renders a window centred on
    its projected model centre; `anchors` gives each window's origin."""
    if use_tree_occlusion:
        raise NotImplementedError(
            "use_tree_occlusion (render-occludes-source invalidation) is not "
            "ported; the greedy path runs with it off")
    from perception_tpu_torch.ops.raster_direct import (
        pack_bank_verts,
        rasterize_direct,
    )

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

    verts16 = pack_bank_verts(bank_tri_verts, bank_tri_valid, bank_backface)
    keys = rasterize_direct(verts16, pose_mats, ids, anchors, proj,
                            width=width, height=height, stride=stride,
                            roi_shape=roi_shape)

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
