"""Depth image -> point cloud, with a stable valid-first compaction.

Counterpart of `perception_tpu/ops/pointcloud.py`. Pixel (x, y) at
full-resolution coordinates with z = depth / depth_factor metres unprojects
to ((x - cx) / fx * z, (y - cy) / fy * z, z). Compaction keeps valid points
first in scan order (a stable sort), so a static prefix of a segment is a
fixed subsample of it; the cost stage's target crop depends on that order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from perception_tpu_torch.ops.numerics import div


@dataclasses.dataclass
class CloudBatch:
    xyz: torch.Tensor     # [N, P, 3] float32 camera frame (m)
    rgb: torch.Tensor     # [N, P, 3] float32 0..255
    valid: torch.Tensor   # [N, P] bool
    count: torch.Tensor   # [N] int32 valid points per pose
    pixel: torch.Tensor   # [N, P] int32 flat strided-pixel index (-1 invalid)


@functools.lru_cache(maxsize=None)
def _interleave_perm(n: int) -> np.ndarray:
    """Deterministic low-discrepancy permutation of range(n): a
    multiplicative stride near n/phi, forced coprime to n, so every prefix is
    an evenly spread subsample of the scan order."""
    g = max(1, round(n * 0.6180339887)) | 1
    while np.gcd(g, n) != 1:
        g += 2
    return (np.arange(n, dtype=np.int64) * g % n).astype(np.int32)


def _strided_pixel_coords(width: int, height: int, stride: int,
                          device) -> tuple[torch.Tensor, torch.Tensor]:
    w_s, h_s = width // stride, height // stride
    xs = torch.arange(w_s, device=device, dtype=torch.float32) * stride
    ys = torch.arange(h_s, device=device, dtype=torch.float32) * stride
    return xs.repeat(h_s), ys.repeat_interleave(w_s)


def _valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Stable partition order along the last axis: valid entries first."""
    return torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices


def depth_to_cloud_batch(
    depth: torch.Tensor,   # [N, h_s, w_s] int32 render units
    color: torch.Tensor,   # [N, h_s, w_s, 3] float32
    *,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, stride: int,
    depth_factor: float = 100.0,
    max_points: int = 1024,
) -> CloudBatch:
    """Unproject strided depth images into clouds of capacity max_points
    (valid points first; points beyond the cap are dropped)."""
    n = depth.shape[0]
    npix = depth.shape[1] * depth.shape[2]
    px, py = _strided_pixel_coords(width, height, stride, depth.device)
    d = depth.reshape(n, npix)
    valid = d > 0
    order = _valid_first(valid)[:, :max_points]
    sel_valid = torch.gather(valid, 1, order)
    sel_d = torch.gather(d, 1, order).to(torch.float32)
    z = div(sel_d, depth_factor)
    x = div(px[order] - cx, fx) * z
    y = div(py[order] - cy, fy) * z
    xyz = torch.where(sel_valid[..., None], torch.stack([x, y, z], dim=-1),
                      0.0)
    rgb = torch.gather(color.reshape(n, npix, 3), 1,
                       order[..., None].expand(-1, -1, 3))
    rgb = torch.where(sel_valid[..., None], rgb, 0.0)
    return CloudBatch(
        xyz=xyz, rgb=rgb, valid=sel_valid,
        count=valid.sum(dim=1).to(torch.int32),
        pixel=torch.where(sel_valid, order, -1).to(torch.int32))


def depth_to_cloud_roi(
    depth: torch.Tensor,    # [N, rh, rw] int32 render units
    color: torch.Tensor,    # [N, rh, rw, 3] float32
    anchors: torch.Tensor,  # [N, 2] int32 strided ROI origin (x0, y0)
    *,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, stride: int,
    depth_factor: float = 100.0,
) -> CloudBatch:
    """ROI depth windows -> clouds with no compaction: every window pixel is
    a (possibly invalid) point in place."""
    n, rh, rw = depth.shape
    npix = rh * rw
    dev = depth.device
    lx = torch.arange(rw, device=dev).repeat(rh)
    ly = torch.arange(rh, device=dev).repeat_interleave(rw)
    px = (anchors[:, 0:1] + lx).to(torch.float32) * stride
    py = (anchors[:, 1:2] + ly).to(torch.float32) * stride
    d = depth.reshape(n, npix).to(torch.float32)
    valid = d > 0
    z = div(d, depth_factor)
    x = div(px - cx, fx) * z
    y = div(py - cy, fy) * z
    xyz = torch.where(valid[..., None], torch.stack([x, y, z], dim=-1), 0.0)
    rgb = torch.where(valid[..., None], color.reshape(n, npix, 3), 0.0)
    global_pix = (anchors[:, 1:2] + ly) * (width // stride) + anchors[:, 0:1] + lx
    return CloudBatch(
        xyz=xyz, rgb=rgb, valid=valid,
        count=valid.sum(dim=1).to(torch.int32),
        pixel=torch.where(valid, global_pix, -1).to(torch.int32))


@dataclasses.dataclass
class ObservedCloud:
    """Observed scene cloud, flat and label-partitioned."""

    xyz: torch.Tensor         # [O, 3]
    rgb: torch.Tensor         # [O, 3]
    label: torch.Tensor       # [O] int32 0-based (-1 invalid)
    valid: torch.Tensor       # [O] bool
    count: torch.Tensor       # [] int32
    pixel: torch.Tensor       # [O] int32 strided-grid pixel index (-1 invalid)
    seg_xyz: torch.Tensor     # [L, S, 3]
    seg_rgb: torch.Tensor     # [L, S, 3]
    seg_valid: torch.Tensor   # [L, S] bool
    seg_count: torch.Tensor   # [L] int32


def observed_cloud_from_depth(
    depth: torch.Tensor,        # [H, W] float32 raw sensor units
    color: torch.Tensor,        # [H, W, 3] float32
    label_mask: torch.Tensor,   # [H, W] int32 1-based labels, 0 background
    *,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, stride: int,
    depth_factor: float,
    max_points: int,
    seg_cap: int,
    num_labels: int,
    use_label_filter: bool = True,
    use_bounds_filter: bool = False,
    bounds: torch.Tensor | None = None,        # [6] x_max,x_min,y_max,...
    cam_to_world: torch.Tensor | None = None,  # [4, 4]
) -> ObservedCloud:
    """Observed RGB-D image -> strided, filtered, label-partitioned cloud
    (camera frame). Segment l holds up to seg_cap points of label l+1, taken
    in interleaved (coprime-stride) order so any static prefix of a segment
    is a spatially uniform subsample."""
    dev = depth.device
    # The render's strided grid: (height // stride) x (width // stride)
    # pixels, also where the stride does not divide the frame.
    grid = np.s_[:height // stride * stride:stride,
                 :width // stride * stride:stride]
    d = depth[grid].to(torch.float32)
    rgb = color[grid].to(torch.float32)
    lab = label_mask[grid].to(torch.int32)
    npix = d.shape[0] * d.shape[1]
    px, py = _strided_pixel_coords(width, height, stride, dev)
    d = d.reshape(npix)
    rgb = rgb.reshape(npix, 3)
    lab = lab.reshape(npix)

    z = div(d, depth_factor)
    xyz = torch.stack([div(px - cx, fx) * z, div(py - cy, fy) * z, z], dim=-1)
    valid = d > 0
    if use_label_filter:
        valid = valid & (lab > 0)
    if use_bounds_filter:
        world = xyz
        if cam_to_world is not None:
            world = xyz @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]
        valid = valid & (world[:, 0] <= bounds[0]) & (world[:, 0] >= bounds[1])
        valid = valid & (world[:, 1] <= bounds[2]) & (world[:, 1] >= bounds[3])
        valid = valid & (world[:, 2] <= bounds[4]) & (world[:, 2] >= bounds[5])

    order = _valid_first(valid)[:max_points]
    sel_valid = valid[order]
    sel_xyz = torch.where(sel_valid[:, None], xyz[order], 0.0)
    sel_rgb = torch.where(sel_valid[:, None], rgb[order], 0.0)
    sel_lab = torch.where(sel_valid, lab[order] - 1, -1)
    sel_pix = torch.where(sel_valid, order, -1).to(torch.int32)

    # The permutation spans max_points even when the frame has fewer pixels;
    # out-of-range entries read the last point, as JAX's clamped gather does.
    perm = torch.as_tensor(_interleave_perm(max_points), device=dev).long()
    perm = perm.clamp(max=sel_valid.shape[0] - 1)
    labels = torch.arange(num_labels, device=dev)
    m = sel_valid[None, :] & (sel_lab[None, :] == labels[:, None])  # [L, O]
    seg_order = perm[_valid_first(m[:, perm])[:, :seg_cap]]         # [L, S]
    seg_valid = torch.gather(m, 1, seg_order)
    seg_xyz = torch.where(seg_valid[..., None], sel_xyz[seg_order], 0.0)
    seg_rgb = torch.where(seg_valid[..., None], sel_rgb[seg_order], 0.0)
    return ObservedCloud(
        xyz=sel_xyz, rgb=sel_rgb, label=sel_lab.to(torch.int32),
        valid=sel_valid, count=sel_valid.sum().to(torch.int32),
        pixel=sel_pix,
        seg_xyz=seg_xyz, seg_rgb=seg_rgb, seg_valid=seg_valid,
        seg_count=m.sum(dim=1).to(torch.int32))
