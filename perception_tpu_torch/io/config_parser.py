"""3-DoF experiment scene config parser.

The port's copy of `perception_tpu/io/config_parser.py`, line-compatible
with the reference's text format (sbpl_perception/src/config_parser.cpp:
22-111): pcd path, model count, model paths, per-model symmetry and flip
flags, workspace x/y bounds, table height, and a 4x4 camera pose.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class SceneConfig:
    pcd_file_path: str
    model_files: list[str]
    model_names: list[str]
    model_symmetries: list[bool]
    model_flippings: list[bool]
    min_x: float
    max_x: float
    min_y: float
    max_y: float
    table_height: float
    camera_pose: np.ndarray   # [4, 4] camera -> world


def parse_scene_config(path: str, base_dir: str = "") -> SceneConfig:
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f]
    it = iter(lines)

    def next_line():
        return next(it)

    pcd = os.path.join(base_dir, next_line())
    num_models = int(next_line())
    model_files = [os.path.join(base_dir, next_line())
                   for _ in range(num_models)]
    model_names = [os.path.splitext(os.path.basename(p))[0]
                   for p in model_files]
    symmetries = [next_line().strip() == "true" for _ in range(num_models)]
    flippings = [next_line().strip() == "true" for _ in range(num_models)]
    min_x, max_x = (float(v) for v in next_line().split())
    min_y, max_y = (float(v) for v in next_line().split())
    table_height = float(next_line())
    vals = []
    for line in it:
        vals.extend(float(v) for v in line.split())
    camera_pose = np.asarray(vals[:16], dtype=np.float64).reshape(4, 4)
    return SceneConfig(
        pcd_file_path=pcd, model_files=model_files, model_names=model_names,
        model_symmetries=symmetries, model_flippings=flippings,
        min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
        table_height=table_height, camera_pose=camera_pose)
