"""Pose-file formats of the reference's evaluation stack.

The port's own copy of `perception_tpu/io/poses_file.py`; the same inputs
write the same bytes:

  * `poses.txt`: one "x y z qx qy qz qw" candidate per line
    (search_env.cpp:7109-7128);
  * `output_poses.txt`: 13-line records (name / translation / quaternion /
    4x4 incl-preprocessing / 4x4 preprocessing), perch_fat.cpp:302-307;
  * `output_stats.txt`: header + one stats row (perch_fat.cpp:316-323);
  * `cost_dump.json`: per-candidate costs and transforms
    (search_env.cpp:2600-2619).
"""

from __future__ import annotations

import json
import os

import numpy as np

from perception_tpu_torch.core.pose import ContPose, matrix_to_quat


def read_poses_file(path: str) -> np.ndarray:
    """Read a per-object poses.txt -> [K, 7] (x y z qx qy qz qw)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append([float(v) for v in parts[:7]])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 7)


def _rotation_from_linear(linear: np.ndarray) -> np.ndarray:
    """Nearest rotation to a (possibly scaled / flipped) linear part."""
    u, _, vt = np.linalg.svd(linear)
    rot = u @ vt
    if np.linalg.det(rot) < 0:
        u[:, -1] *= -1
        rot = u @ vt
    return rot


def _fmt_matrix(mat: np.ndarray) -> list[str]:
    return [" ".join(f"{v:.9g}" for v in row) for row in np.asarray(mat)]


def write_output_poses(path: str,
                       detections: list[tuple[str, ContPose, np.ndarray]]
                       ) -> None:
    """Write output_poses.txt from (model name, world pose,
    preprocessing_transform); translation and quaternion come from the
    incl-preprocessing transform."""
    lines: list[str] = []
    for name, pose, pre in detections:
        obj_tf = pose.transform() @ pre
        qx, qy, qz, qw = matrix_to_quat(_rotation_from_linear(obj_tf[:3, :3]))
        t = obj_tf[:3, 3]
        lines.append(name)
        lines.append(f"translation {t[0]:.9g} {t[1]:.9g} {t[2]:.9g}")
        lines.append(f"quaternion {qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g} ")
        lines.append("matrix(incl preprocessing) ")
        lines.extend(_fmt_matrix(obj_tf))
        lines.append("matrix(preprocessing) ")
        lines.extend(_fmt_matrix(pre))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def read_output_poses(path: str, distance_scale: float = 1.0) -> list[dict]:
    """Parse output_poses.txt as the reference's perch.py:139-175 does."""
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f.readlines()]
    out = []
    for i in range(0, len(lines) - 12, 13):
        location = [float(v) for v in lines[i + 1].split()[1:]]
        quaternion = [float(v) for v in lines[i + 2].split()[1:]]
        tf = np.array([[float(v) for v in lines[i + k].split()]
                       for k in range(4, 8)])
        pre = np.array([[float(v) for v in lines[i + k].split()]
                        for k in range(9, 13)])
        out.append({
            "name": lines[i],
            "location": [v * distance_scale for v in location],
            "quaternion_xyzw": quaternion,
            "transform_matrix": tf,
            "preprocessing_transform_matrix": pre,
        })
    return out


def write_output_stats(path: str, stats) -> None:
    """Write output_stats.txt (perch_fat.cpp:316-323 layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("[[[[[[[[  Stats  ]]]]]]]]:\n")
        f.write("#Rendered #Valid Rendered #Expands Time "
                "Cost ICP-Time Peak-GPU-Mem\n")
        f.write(f"{stats.scenes_rendered} {stats.scenes_valid} "
                f"{stats.expands} {stats.time} {stats.cost} "
                f"{stats.icp_time} {stats.peak_device_mem_mb}\n")


def write_cost_dump(path: str, scored, env) -> None:
    """Per-candidate cost / transform dump (cost_dump.json)."""
    poses_json = []
    for i, su in enumerate(scored):
        pose = su.state.pose
        model = env.bank.models[su.state.id]
        tf = pose.transform() @ model.preprocessing_transform
        qx, qy, qz, qw = pose.quaternion()
        rot = _rotation_from_linear(tf[:3, :3])
        # Lie (axis-angle) log of the rotation.
        cos_t = max(-1.0, min(1.0, (np.trace(rot) - 1) / 2))
        theta = float(np.arccos(cos_t))
        if theta < 1e-9:
            lie = [0.0, 0.0, 0.0]
        else:
            axis = np.array([rot[2, 1] - rot[1, 2],
                             rot[0, 2] - rot[2, 0],
                             rot[1, 0] - rot[0, 1]]) / (2 * np.sin(theta))
            lie = (axis * theta).tolist()
        poses_json.append({
            "id": i,
            "target_cost": su.target_cost,
            "source_cost": su.source_cost,
            "total_cost": su.cost,
            "transform": np.asarray(tf, dtype=float).ravel(order="F").tolist(),
            "translation": [pose.x, pose.y, pose.z],
            "quaternion": [qx, qy, qz, qw],
            "lie_rotation": lie,
        })
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"poses": poses_json}, f, indent=4)
