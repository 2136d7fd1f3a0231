"""Explained / unexplained point costs.

Counterpart of `perception_tpu/ops/cost.py`. `compute_costs_fused`: the
fused kernels' three counts per pose become the percentage costs with the
-1 sentinel for poses with no rendered points, depth only (cost types 0 / 2)
or with the CIEDE2000 colour gate on Lab inputs (types 1 / 3).
`compute_costs`: the composed form, from each rendered point's nearest
observed point (`knn.nn1_batch`, the 1-NN kernel on the card): the gate on
RGB colours converted to Lab per point, and a scatter-max of the explained
observed points.
"""

from __future__ import annotations

import dataclasses

import torch

from perception_tpu_torch.ops.color import ciede2000, rgb_to_lab
from perception_tpu_torch.ops.cost_fused import nn_cost_fused
from perception_tpu_torch.ops.cost_fused_color import (
    nn_cost_fused_color,
    nn_cost_fused_color_tri,
)

COST_TYPE_3DOF_DEPTH = 0
COST_TYPE_3DOF_RGBD = 1
COST_TYPE_6DOF = 2
COST_TYPE_6DOF_RGB = 3


@dataclasses.dataclass
class CostOutput:
    rendered_cost: torch.Tensor      # [N] % unexplained rendered (-1 invalid)
    observed_cost: torch.Tensor      # [N] % unexplained observed
    points_diff_cost: torch.Tensor   # [N] rendered_explained - observed_explained
    pose_point_num: torch.Tensor     # [N] rendered points per pose
    observed_explained: torch.Tensor  # [N]


def normalize_costs(raw_rendered, pose_point_num, observed_explained,
                    observed_total, occluded) -> CostOutput:
    """Percentages and sentinels: rendered cost -1 for empty or occluded
    poses; observed cost clamped to [0, 100], and 100 when nothing is
    observed."""
    rendered_explained = pose_point_num - raw_rendered
    rendered_cost = torch.where(
        pose_point_num == 0, -1.0,
        raw_rendered / torch.clamp(pose_point_num, min=1.0) * 100.0)
    rendered_cost = torch.where(occluded, -1.0, rendered_cost)
    observed_cost = ((observed_total - observed_explained)
                     / torch.clamp(observed_total, min=1e-9) * 100.0)
    observed_cost = torch.where(observed_total <= 0, 100.0,
                                torch.clamp(observed_cost, 0.0, 100.0))
    return CostOutput(
        rendered_cost=rendered_cost,
        observed_cost=observed_cost,
        points_diff_cost=rendered_explained - observed_explained,
        pose_point_num=pose_point_num,
        observed_explained=observed_explained,
    )


def compute_costs_fused(
    cloud_xyz, cloud_valid, pose_occluded, tgt_xyz, tgt_valid,
    observed_total, *, sensor_resolution: float, cloud_lab=None,
    tgt_lab=None, color_distance_threshold: float = 15.0,
    use_color: bool = False, cloud_tri_id=None, model_ids=None,
    bank_lab=None, cloud_explain_only=None,
) -> CostOutput:
    """Cost through a fused NN + count kernel: depth only by default; with
    use_color the CIEDE2000 gate, against tgt_lab, of the rendered Lab from
    cloud_lab or, given cloud_tri_id / model_ids / bank_lab [M, T, 3], of
    each point's face colour (ROI clouds: point index == pixel index)."""
    if use_color and (tgt_lab is None or (cloud_lab is None
                                          and cloud_tri_id is None)):
        raise ValueError(
            "the fused colour cost needs Lab inputs; compute_costs is the "
            "composed cost on RGB")
    if use_color and cloud_tri_id is not None:
        point_num, unexplained, explained = nn_cost_fused_color_tri(
            cloud_xyz, cloud_valid, cloud_tri_id, model_ids, bank_lab,
            tgt_xyz, tgt_valid, tgt_lab, sensor_resolution,
            color_distance_threshold, cloud_explain_only=cloud_explain_only)
    elif use_color:
        point_num, unexplained, explained = nn_cost_fused_color(
            cloud_xyz, cloud_valid, cloud_lab, tgt_xyz, tgt_valid, tgt_lab,
            sensor_resolution, color_distance_threshold,
            cloud_explain_only=cloud_explain_only)
    else:
        point_num, unexplained, explained = nn_cost_fused(
            cloud_xyz, cloud_valid, tgt_xyz, tgt_valid, sensor_resolution,
            cloud_explain_only=cloud_explain_only)
    occluded = pose_occluded.to(torch.bool)
    point_num = torch.where(occluded, 0.0, point_num)
    unexplained = torch.where(occluded, 0.0, unexplained)
    explained = torch.where(occluded, 0.0, explained)
    return normalize_costs(unexplained, point_num, explained,
                           observed_total, occluded)


def compute_costs(
    knn_dist_sq: torch.Tensor,     # [N, P] squared distance to observed NN
    knn_idx: torch.Tensor,         # [N, P] index into the pose's segment
    cloud_valid: torch.Tensor,     # [N, P]
    pose_occluded: torch.Tensor,   # [N]
    rendered_rgb: torch.Tensor,    # [N, P, 3] 0..255
    observed_rgb: torch.Tensor,    # [N, S, 3] 0..255
    observed_total: torch.Tensor,  # [N]
    *, sensor_resolution: float, color_distance_threshold: float = 15.0,
    cost_type: int = COST_TYPE_6DOF,
    cloud_explain_only: torch.Tensor | None = None,
) -> CostOutput:
    """The composed cost of the JAX compute_costs: a valid, unoccluded point
    farther than sensor_resolution from its nearest observed point (or, for
    types 1 / 3, close but over the CIEDE2000 threshold) is unexplained; a
    close one that passes the gate explains its neighbour. Explain-only
    points (cloud_explain_only) never count as rendered and explain their
    neighbour whenever close."""
    s = observed_rgb.shape[1]
    thresh_sq = sensor_resolution * sensor_resolution
    occluded = pose_occluded.to(torch.bool)
    active = cloud_valid & ~occluded[:, None]
    counted = (active if cloud_explain_only is None
               else active & ~cloud_explain_only)
    far = knn_dist_sq > thresh_sq
    idx = knn_idx.long()
    if cost_type in (COST_TYPE_3DOF_RGBD, COST_TYPE_6DOF_RGB):
        nn_rgb = torch.gather(observed_rgb, 1, idx[..., None].expand(-1, -1, 3))
        cdist = ciede2000(rgb_to_lab(nn_rgb), rgb_to_lab(rendered_rgb))
        color_bad = cdist > color_distance_threshold
        unexplained = counted & (far | (~far & color_bad))
        explains = active & ~far & ~color_bad
        if cloud_explain_only is not None:
            explains = explains | (active & ~far & cloud_explain_only)
    else:
        unexplained = counted & far
        explains = active & ~far
    raw_rendered = unexplained.sum(dim=1).to(torch.float32)
    pose_point_num = counted.sum(dim=1).to(torch.float32)
    explained = torch.zeros((idx.shape[0], s), dtype=torch.float32,
                            device=idx.device)
    explained.scatter_reduce_(1, idx, explains.to(torch.float32),
                              reduce="amax")
    return normalize_costs(raw_rendered, pose_point_num,
                           explained.sum(dim=1), observed_total, occluded)
