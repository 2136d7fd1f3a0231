"""YCB-Video constants and candidate generation.

The port's copy of the candidate half of `perception_tpu/eval/ycb.py`
(host NumPy, as there): per-object mask centroid unprojected at depth
layers min..max mask depth (2 cm resolution; 1 cm for scissors), crossed
with fibonacci-sphere rotation samples under the object's symmetry mode
(the reference's fat_dataset/fat_pose_image.py:1633-1660). The dataset
reader and the evaluation driver are not ported yet.
"""

from __future__ import annotations

import numpy as np

from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.core.pose import euler_xyz_to_matrix, matrix_to_quat
from perception_tpu_torch.eval.sampling import get_rotation_samples

# Objects scored with ADD-S (symmetric) in the YCB-Video protocol.
YCB_ADDS_OBJECTS = {
    "024_bowl", "036_wood_block", "051_large_clamp",
    "052_extra_large_clamp", "061_foam_brick",
}

YCB_CAMERA = CameraIntrinsics(
    fx=1066.778, fy=1067.487, cx=312.9869, cy=241.3109, width=640, height=480)
YCB_DEPTH_FACTOR = 10000.0


def generate_candidates(
    depth: np.ndarray,
    instance_mask: np.ndarray,
    object_names: list[str],
    camera: CameraIntrinsics,
    depth_factor: float = YCB_DEPTH_FACTOR,
    num_samples: int = 60,
    cam_to_world: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Per-object candidate pose rows [K, 7] (the poses.txt contract): the
    mask's 2D centroid unprojected at min..max mask depth in `resolution`
    layers, crossed with the symmetry-aware rotation samples. Object i is
    instance i + 1 of the mask; an object without depth in its mask gets
    no entry."""
    out: dict[str, np.ndarray] = {}
    for i, name in enumerate(object_names):
        mask = instance_mask == (i + 1)
        obj_depth = np.where(mask, depth, 0).astype(np.float64)
        nz = obj_depth[obj_depth > 0]
        if nz.size == 0:
            continue
        min_depth = nz.min() / depth_factor
        max_depth = nz.max() / depth_factor
        ys, xs = np.nonzero(mask)
        centroid = np.array([xs.mean(), ys.mean()])

        resolution = 0.01 if name == "037_scissors" else 0.02
        rotations = get_rotation_samples(name, num_samples)
        quats = [matrix_to_quat(euler_xyz_to_matrix(*r)) for r in rotations]

        rows = []
        for d in np.arange(min_depth, max_depth + resolution, resolution):
            x = (centroid[0] - camera.cx) / camera.fx * d
            y = (centroid[1] - camera.cy) / camera.fy * d
            point = np.array([x, y, d, 1.0])
            if cam_to_world is not None:
                point = cam_to_world @ point
            for q in quats:
                rows.append([point[0], point[1], point[2], *q])
        out[name] = np.asarray(rows)
    return out
