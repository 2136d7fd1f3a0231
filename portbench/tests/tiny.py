"""Cells cut to a size the CPU runs in seconds, for the tests: the same
configurations at 160x120 with the intrinsics scaled, the 6-DoF cell at
stride 4 with a 16x16 ROI and 8 rotation samples, the
3-DoF cells at stride 6 (the full frame's 26x20 grid) with 4 yaws and
512 points a segment, 128 a rendered cloud, 64 ICP targets, blobs of
256 triangles; two
frames a run."""

from __future__ import annotations

import copy
import math

from portbench import harness


def tiny(cell: harness.Cell) -> harness.Cell:
    c = copy.deepcopy(cell.config)
    cam = c["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= 0.25
    cam["width"], cam["height"] = 160, 120
    c["env"]["width"], c["env"]["height"] = 160, 120
    if c["scene"]["kind"] == "6dof":
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
    return harness.Cell(cell.name, c, dict(cell.traffic, frames=2),
                        cell.end_to_end, cell.per_layer)


# A cell whose files the benchmark keeps, with no
# BENCHMARK.json entry yet: the cell that shares its configuration, and its
# traffic.
LATER = {"table3dof.tree-robot": ("table3dof.greedyicp-robot", "tree-robot")}


def tiny_cell(name: str) -> harness.Cell:
    if name in LATER:
        base, traffic = LATER[name]
        cell = harness.load_cell(base)
        cell = harness.Cell(name, cell.config, harness.load_json(
            harness.BENCH / "traffic" / f"{traffic}.json"), cell.end_to_end,
            cell.per_layer)
        return tiny(cell)
    return tiny(harness.load_cell(name))


CELLS = ("ycbv6d.depth-robot", "table3dof.greedyicp-robot",
         "table3dof.tree-robot")
