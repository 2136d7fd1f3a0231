"""Score a batch of candidate poses: render, cloud, point-to-plane ICP,
moved cloud with explain-only surface samples, depth cost.

The scoring path both configurations state (the port's `score_pose_batch`
at `icp_mode` "fused" point-to-plane, `cost_cloud` "transform", the render
source, the depth-only cost), written out plainly. Besides the scores it
counts the work the kernels' stages need for these poses: the ICP's
iterations, association sweeps and valid (source, target) pairs, and the
cost's valid (point, target) pairs, with the bytes each stage reads and
writes once (`portbench/work.py` turns them into a least time).
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.cloud import cloud_batch, cloud_roi
from portbench.reference.cost import depth_cost
from portbench.reference.icp import (
    crop_near,
    icp_point_to_plane,
    pack_targets,
    rotate_points,
)
from portbench.reference.raster import render


@dataclasses.dataclass
class Scene:
    """The observed scene the scorer reads."""

    seg_xyz: torch.Tensor       # [L, S, 3]
    seg_valid: torch.Tensor     # [L, S]
    seg_normals: torch.Tensor   # [L, S, 3]
    source_depth: torch.Tensor  # [h, w] int32 cm
    source_label: torch.Tensor  # [h, w] int32 1-based


@dataclasses.dataclass
class Work:
    """What the ICP and cost stages need, summed over scored poses."""

    icp_pair_sweeps: float = 0.0     # sweeps x valid sources x valid targets
    icp_point_iters: float = 0.0     # iterations x valid sources
    icp_bytes: float = 0.0
    cost_pairs: float = 0.0
    cost_bytes: float = 0.0

    def add(self, other: "Work") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))


@dataclasses.dataclass
class Scores:
    total: torch.Tensor         # [N] int32, -1 invalid
    rendered: torch.Tensor      # [N] float32
    observed: torch.Tensor      # [N] float32
    adjusted: torch.Tensor      # [N, 4, 4] model -> camera after ICP
    work: Work


def _compose(a, b):
    return (a[:, :, 0:1] * b[:, 0:1] + a[:, :, 1:2] * b[:, 1:2]
            + a[:, :, 2:3] * b[:, 2:3] + a[:, :, 3:4] * b[:, 3:4])


def _nbytes(*ts) -> float:
    return float(sum(t.numel() * 4 for t in ts))


def icp_work(src_xyz, src_valid, tgt, iters, sweeps) -> Work:
    """The ICP stage's counts: sweeps x valid sources x valid targets,
    iterations x valid sources, and its bytes (sources, their validity,
    the packed targets, the [N, 4, 4] corrections)."""
    nv = src_valid.sum(dim=1).double()
    nt = (tgt[..., 7] < 1e30).sum(dim=1).double()
    return Work(icp_pair_sweeps=(sweeps.double() * nv * nt).sum().item(),
                icp_point_iters=(iters.double() * nv).sum().item(),
                icp_bytes=_nbytes(src_xyz, src_valid, tgt)
                + src_xyz.shape[0] * 16 * 4)


def cost_work(xyz, valid, tgt_xyz, tgt_valid, pairs: float) -> Work:
    """The cost stage's valid pairs and bytes (cloud, its flags, targets
    with their validity, three counts per pose)."""
    return Work(cost_pairs=pairs,
                cost_bytes=_nbytes(xyz, valid, tgt_xyz, tgt_valid)
                + xyz.shape[0] * 3 * 4)


def icp_targets(scene: Scene, labels, k_cap: int):
    """[N, k, 8] packed targets: each segment's k targets nearest its valid
    centroid (the whole segment when it fits), shared by its poses."""
    s = scene.seg_xyz.shape[1]
    k = min(k_cap or 256, s)
    packed = pack_targets(scene.seg_xyz, scene.seg_valid, scene.seg_normals)
    if k >= s:
        return packed[labels]
    valid = scene.seg_valid
    centre = ((scene.seg_xyz.double() * valid[..., None]).sum(dim=1)
              / torch.clamp(valid.sum(dim=1), min=1)[:, None]).float()
    cidx = crop_near(scene.seg_xyz, valid, centre, k)
    return torch.gather(packed, 1, cidx[..., None].expand(-1, -1, 8))[labels]


def score_batch(bank: dict, poses, model_ids, pose_labels, observed_total,
                proj, scene: Scene, cfg: dict, do_icp: bool,
                quant=None) -> Scores:
    """cfg: camera (fx, fy, cx, cy, width, height), stride, roi_shape,
    max_points_per_pose, icp_downsample, icp_crop_targets,
    cost_crop_targets, icp_* settings, sensor_resolution,
    occlusion_threshold, use_segmentation_label, use_tree_occlusion.
    `quant` rounds each stage's floating inputs (the control)."""
    q = quant or (lambda t: t)
    labels = torch.clamp(pose_labels.long(), 0, scene.seg_xyz.shape[0] - 1)
    ids = model_ids.long()
    s_full = scene.seg_xyz.shape[1]
    sc = min(cfg["cost_crop_targets"] or s_full, s_full)
    cost_xyz = scene.seg_xyz[:, :sc][labels]
    cost_valid = scene.seg_valid[:, :sc][labels]
    if sc < s_full:
        observed_total = torch.minimum(
            observed_total, cost_valid.sum(dim=1).to(observed_total.dtype))
    cam = {k: cfg[k] for k in ("fx", "fy", "cx", "cy", "width", "height")}
    out = render(bank["tri_verts"], bank["tri_valid"], poses, ids, proj,
                 stride=cfg["stride"],
                 source_depth=scene.source_depth,
                 source_label=scene.source_label, pose_labels=labels,
                 occlusion_threshold=cfg["occlusion_threshold"],
                 use_segmentation_label=cfg["use_segmentation_label"],
                 use_tree_occlusion=cfg["use_tree_occlusion"],
                 roi_shape=cfg["roi_shape"], cullable=bank["cullable"],
                 quant=quant, width=cfg["width"], height=cfg["height"])
    if cfg["roi_shape"] is not None:
        cloud = cloud_roi(out.depth, out.anchors,
                          stride=cfg["stride"], **cam)
    else:
        cloud = cloud_batch(out.depth, stride=cfg["stride"],
                            max_points=cfg["max_points_per_pose"], **cam)
    work = Work()
    adjusted = poses
    explain_only = None
    xyz, valid = q(cloud.xyz), cloud.valid
    if do_icp:
        ds = cfg["icp_downsample"]
        src_xyz, src_valid = xyz[:, ::ds], valid[:, ::ds]
        tgt = q(icp_targets(scene, labels, cfg["icp_crop_targets"]))
        delta, iters, sweeps = icp_point_to_plane(
            src_xyz, src_valid, tgt,
            max_iterations=cfg["icp_max_iterations"],
            max_correspondence=cfg["icp_max_correspondence"],
            nn_every=cfg["icp_nn_every"],
            rotation_epsilon=cfg["icp_rotation_epsilon"],
            transformation_epsilon=cfg["icp_transformation_epsilon"],
            stagnation_streak=float(cfg["icp_stagnation_streak"]))
        delta = q(delta)
        work.add(icp_work(src_xyz, src_valid, tgt, iters, sweeps))
        adjusted = _compose(delta, poses)
        moved = rotate_points(delta[:, :3, :3], xyz) + delta[:, None, :3, 3]
        xyz = torch.where(valid[..., None], moved, xyz)
        samp = bank["icp_samples"][ids]
        snrm = bank["icp_normals"][ids]
        rot = adjusted[:, :3, :3]
        aug_xyz = rotate_points(rot, samp) + adjusted[:, None, :3, 3]
        n_cam = rotate_points(rot, snrm)
        aug_valid = (n_cam[..., 0] * aug_xyz[..., 0]
                     + n_cam[..., 1] * aug_xyz[..., 1]
                     + n_cam[..., 2] * aug_xyz[..., 2]) < 0.0
        n_b, p_b = valid.shape
        explain_only = torch.cat(
            [torch.zeros((n_b, p_b), dtype=torch.bool, device=xyz.device),
             torch.ones((n_b, aug_xyz.shape[1]), dtype=torch.bool,
                        device=xyz.device)], dim=1)
        xyz = torch.cat([xyz, q(aug_xyz)], dim=1)
        valid = torch.cat([valid, aug_valid], dim=1)
    costs = depth_cost(xyz, valid, explain_only, out.pose_occluded,
                       q(cost_xyz), cost_valid, observed_total,
                       cfg["sensor_resolution"])
    work.add(cost_work(xyz, valid, cost_xyz, cost_valid, costs.pairs))
    invalid = costs.rendered.to(torch.int32) < 0
    total = torch.where(invalid, -1,
                        (costs.rendered + costs.observed).to(torch.int32))
    return Scores(total=total, rendered=costs.rendered,
                  observed=costs.observed, adjusted=adjusted, work=work)
