"""Cells cut to a size the CPU runs in seconds, for the tests: the same
configurations at 160x120 with the intrinsics scaled, the 6-DoF cell at
stride 4 with a 16x16 ROI and 8 rotation samples, the
3-DoF cells at stride 6 (the full frame's 26x20 grid) with 4 yaws and
512 points a segment, 128 a rendered cloud, 64 ICP targets, blobs of
256 triangles; two
frames a run."""

from __future__ import annotations

import copy
import dataclasses
import math

from portbench import harness
from portbench.scenes.frames import kind


def tiny(cell: harness.Cell) -> harness.Cell:
    c = copy.deepcopy(cell.config)
    cam = c["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= 0.25
    cam["width"], cam["height"] = 160, 120
    c["env"]["width"], c["env"]["height"] = 160, 120
    if kind(c, cell.bench / "scenes")[0]:
        c["perch"]["gpu_stride"] = 4
        c["perch"]["gpu_batch_size"] = 64
        c["env"]["roi_size"] = 16
        c["candidates"]["num_samples"] = 8
        c["scene"]["min_visible_pixels"] = 100
    else:
        c["perch"]["gpu_stride"] = 6
        c["perch"]["gpu_batch_size"] = 256
        c["env"]["theta_res"] = math.pi / 2
        c["env"]["max_points_per_label"] = 512
        c["env"]["max_labels"] = 2
        c["models"].update(n_seg=16, n_rings=10)
        c["env"].update(max_points_per_pose=128, icp_crop_targets=64)
        c["scene"]["min_visible_pixels"] = 750
    return dataclasses.replace(cell, config=c,
                               traffic=dict(cell.traffic, frames=2))


def tiny_cell(name: str) -> harness.Cell:
    return tiny(harness.load_cell(name))


CELLS = ("ycbv6d.depth-robot", "table3dof.greedyicp-robot",
         "table3dof.tree-robot")
