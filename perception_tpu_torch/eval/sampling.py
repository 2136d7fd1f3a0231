"""Candidate rotation sampling: fibonacci sphere + per-object symmetry table.

The port's copy of `perception_tpu/eval/sampling.py`, re-implementing the
reference's pose-hypothesis generator
(fat_dataset/sphere_fibonacci_grid_points.py:32-105 and
fat_pose_image.py:1171-1281 get_rotation_samples): viewpoints on a fibonacci
spiral (half-sphere for symmetric objects), expanded into euler triplets per
the object's symmetry mode. The env's pose refinement takes its rotation
axes from `sphere_fibonacci_grid`; `eval.ycb.generate_candidates` its
rotations from `get_rotation_samples`.
"""

from __future__ import annotations

import math

import numpy as np

from perception_tpu_torch.core.pose import euler_xyz_to_matrix, matrix_to_quat

# (sphere half/whole, in-plane mode) per YCB object
# (fat_pose_image.py:1174-1216 name_sym_dict).
YCB_SYMMETRY = {
    "002_master_chef_can": (0, 0),
    "003_cracker_box": (0, 0),
    "004_sugar_box": (0, 3),
    "005_tomato_soup_can": (0, 0),
    "006_mustard_bottle": (0, 0),
    "007_tuna_fish_can": (0, 0),
    "008_pudding_box": (0, 1),
    "009_gelatin_box": (0, 0),
    "010_potted_meat_can": (0, 0),
    "011_banana": (1, 0),
    "019_pitcher_base": (0, 0),
    "021_bleach_cleanser": (0, 0),
    "024_bowl": (1, 0),
    "025_mug": (0, 1),
    "035_power_drill": (0, 7),
    "036_wood_block": (0, 0),
    "037_scissors": (0, 2),
    "040_large_marker": (1, 0),
    "051_large_clamp": (0, 7),
    "052_extra_large_clamp": (0, 7),
    "061_foam_brick": (0, 0),
}


def sphere_fibonacci_grid(num_samples: int, half: bool = False) -> np.ndarray:
    """Points on a fibonacci spiral over the (half-)sphere [K, 3]."""
    increment = math.pi * (3.0 - math.sqrt(5.0))
    offset = 2.0 / num_samples
    count = round(num_samples / 2) if half else num_samples
    i = np.arange(count)
    y = i * offset - 1 + offset / 2
    r = np.sqrt(np.maximum(0.0, 1 - y * y))
    phi = ((i + 1) % num_samples) * increment
    return np.stack([np.cos(phi) * r, y, np.sin(phi) * r], axis=1)


def _cart2sphere_euler(v) -> tuple[float, float]:
    """Viewpoint direction -> (theta, phi) euler pieces, matching the
    reference's cart2sphere + sphere2euler chain."""
    x, y, z = v
    r = math.sqrt(x * x + y * y + z * z)
    theta = math.acos(max(-1.0, min(1.0, z / r)))  # dipy cart2sphere inclination
    phi = math.atan2(y, x)
    # sphere2euler (convert_fat_coco.py:348-352): theta -> pi/2 - theta.
    return math.pi / 2 - theta, phi


def get_rotation_samples(label: str, num_samples: int,
                         symmetry: tuple[int, int] | None = None) -> np.ndarray:
    """Euler (roll, pitch, yaw) candidate rotations for an object [K, 3].

    Mirrors get_rotation_samples (fat_pose_image.py:1171-1281): viewpoints
    from the fibonacci sphere (half if sphere-symmetric), expanded by the
    object's in-plane mode.
    """
    if symmetry is None:
        # Default matches the reference's dominant mode (0, 0). Note: denser
        # in-plane sampling (0, 7) closes orientation gaps but measurably
        # LOWERS ADD-S AUC on random-SO(3) synthetic scenes — extra
        # candidates add plausible-but-wrong minima that win the visible-
        # surface cost argmin. Pass `symmetry` explicitly to override.
        symmetry = YCB_SYMMETRY.get(label, (0, 0))
    half_whole, inplane = symmetry
    pts = sphere_fibonacci_grid(num_samples, half=(half_whole == 0))
    rots: list[list[float]] = []
    for v in pts:
        theta, phi = _cart2sphere_euler(v)
        if inplane == 0:
            rots.append([-phi, theta, 0.0])
        elif inplane == 1:
            for yaw in np.arange(0, math.pi, math.pi / 2):
                rots.append([-phi, yaw, theta])
        elif inplane == 2:
            for yaw in np.arange(0, math.pi, math.pi / 4):
                rots.append([-phi, yaw, theta])
        elif inplane == 3:
            rots.append([-phi, 0.0, theta])
            rots.append([-phi, 2 * math.pi / 3, theta])
        elif inplane == 4:
            rots.append([-phi, math.pi + theta, 0.0])
        elif inplane == 5:
            rots.append([phi, theta, math.pi])
        elif inplane == 6:
            rots.append([-phi, 0.0, theta])
            rots.append([-phi, math.pi / 3, theta])
            rots.append([-phi, 2 * math.pi / 3, theta])
        elif inplane == 7:
            for yaw in np.arange(0, 2 * math.pi, math.pi / 2):
                rots.append([-phi, yaw, theta])
        elif inplane == 8:
            for yaw in np.arange(0, math.pi, math.pi / 3):
                rots.append([yaw, -phi, theta])
        else:
            rots.append([-phi, theta, 0.0])
    return np.asarray(rots, dtype=np.float64)


def poses_from_rotations(rotations: np.ndarray, centroid: np.ndarray) -> np.ndarray:
    """Rotation samples + object centroid -> poses.txt rows [K, 7]."""
    rows = []
    for roll, pitch, yaw in rotations:
        q = matrix_to_quat(euler_xyz_to_matrix(roll, pitch, yaw))
        rows.append([centroid[0], centroid[1], centroid[2], *q])
    return np.asarray(rows, dtype=np.float64)
