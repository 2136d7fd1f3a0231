"""Depth images to point clouds: the observed scene and the rendered
candidates.

Frozen copies of the port's plain `ops/pointcloud.py`: pixel (x, y) at
full-resolution coordinates with z = depth / depth_factor unprojects to
((x - cx) / fx * z, (y - cy) / fy * z, z); compaction keeps valid points
first in scan order; a segment takes its points in an interleaved
(coprime-stride) order so any prefix is a uniform subsample.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.numerics import div


@dataclasses.dataclass
class Cloud:
    xyz: torch.Tensor     # [N, P, 3]
    valid: torch.Tensor   # [N, P] bool


@dataclasses.dataclass
class Observed:
    xyz: torch.Tensor         # [O, 3] camera frame
    label: torch.Tensor       # [O] int32 0-based, -1 invalid
    valid: torch.Tensor       # [O] bool
    seg_xyz: torch.Tensor     # [L, S, 3]
    seg_valid: torch.Tensor   # [L, S] bool
    seg_count: torch.Tensor   # [L] int32


def interleave_perm(n: int) -> np.ndarray:
    g = max(1, round(n * 0.6180339887)) | 1
    while np.gcd(g, n) != 1:
        g += 2
    return (np.arange(n, dtype=np.int64) * g % n).astype(np.int32)


def _pixel_coords(width, height, stride, device):
    w_s, h_s = width // stride, height // stride
    xs = torch.arange(w_s, device=device, dtype=torch.float32) * stride
    ys = torch.arange(h_s, device=device, dtype=torch.float32) * stride
    return xs.repeat(h_s), ys.repeat_interleave(w_s)


def _valid_first(valid: torch.Tensor) -> torch.Tensor:
    return torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices


def cloud_batch(depth, *, fx, fy, cx, cy, width, height, stride,
                depth_factor=100.0, max_points=1024) -> Cloud:
    """Full-frame strided renders -> compacted clouds of max_points."""
    n = depth.shape[0]
    npix = depth.shape[1] * depth.shape[2]
    px, py = _pixel_coords(width, height, stride, depth.device)
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
    return Cloud(xyz=xyz, valid=sel_valid)


def cloud_roi(depth, anchors, *, fx, fy, cx, cy, width, height,
              stride, depth_factor=100.0) -> Cloud:
    """ROI renders -> clouds with every window pixel a point in place."""
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
    return Cloud(xyz=xyz, valid=valid)


def observed_cloud(depth, label_mask, *, fx, fy, cx, cy, width, height,
                   stride, depth_factor, max_points, seg_cap, num_labels,
                   use_label_filter=True, bounds=None,
                   cam_to_world=None) -> Observed:
    """The observed frame -> strided, filtered, label-partitioned cloud.
    bounds [6] (x_max, x_min, y_max, y_min, z_max, z_min, world frame)
    keeps a 3-DoF input's region."""
    dev = depth.device
    grid = np.s_[:height // stride * stride:stride,
                 :width // stride * stride:stride]
    d = depth[grid].to(torch.float32)
    lab = label_mask[grid].to(torch.int32)
    npix = d.shape[0] * d.shape[1]
    px, py = _pixel_coords(width, height, stride, dev)
    d = d.reshape(npix)
    lab = lab.reshape(npix)
    z = div(d, depth_factor)
    xyz = torch.stack([div(px - cx, fx) * z, div(py - cy, fy) * z, z], dim=-1)
    valid = d > 0
    if use_label_filter:
        valid = valid & (lab > 0)
    if bounds is not None:
        world = xyz @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]
        valid = valid & (world[:, 0] <= bounds[0]) & (world[:, 0] >= bounds[1])
        valid = valid & (world[:, 1] <= bounds[2]) & (world[:, 1] >= bounds[3])
        valid = valid & (world[:, 2] <= bounds[4]) & (world[:, 2] >= bounds[5])
    order = _valid_first(valid)[:max_points]
    sel_valid = valid[order]
    sel_xyz = torch.where(sel_valid[:, None], xyz[order], 0.0)
    sel_lab = torch.where(sel_valid, lab[order] - 1, -1)
    perm = torch.as_tensor(interleave_perm(max_points), device=dev).long()
    perm = perm.clamp(max=sel_valid.shape[0] - 1)
    labels = torch.arange(num_labels, device=dev)
    m = sel_valid[None, :] & (sel_lab[None, :] == labels[:, None])
    seg_order = perm[_valid_first(m[:, perm])[:, :seg_cap]]
    seg_valid = torch.gather(m, 1, seg_order)
    seg_xyz = torch.where(seg_valid[..., None], sel_xyz[seg_order], 0.0)
    return Observed(xyz=sel_xyz, label=sel_lab.to(torch.int32),
                    valid=sel_valid, seg_xyz=seg_xyz, seg_valid=seg_valid,
                    seg_count=m.sum(dim=1).to(torch.int32))
