"""Explained / unexplained point costs.

Counterpart of the depth-only fused path of `perception_tpu/ops/cost.py`:
the fused kernel's three counts per pose become the percentage costs with
the -1 sentinel for poses with no rendered points. The colour-gated cost
types and the composed (1-NN + scatter) path are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from perception_tpu_torch.ops.cost_fused import nn_cost_fused

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
    observed_total, *, sensor_resolution: float, use_color: bool = False,
    cloud_explain_only=None,
) -> CostOutput:
    """Depth-only cost through the fused NN + count kernel."""
    if use_color:
        raise NotImplementedError(
            "the colour-gated fused cost (cost types 1 / 3) is not ported yet")
    point_num, unexplained, explained = nn_cost_fused(
        cloud_xyz, cloud_valid, tgt_xyz, tgt_valid, sensor_resolution,
        cloud_explain_only=cloud_explain_only)
    occluded = pose_occluded.to(torch.bool)
    point_num = torch.where(occluded, 0.0, point_num)
    unexplained = torch.where(occluded, 0.0, unexplained)
    explained = torch.where(occluded, 0.0, explained)
    return normalize_costs(unexplained, point_num, explained,
                           observed_total, occluded)
