"""DenseFusion baseline ingestion + shared-protocol evaluation.

The port's copy of `perception_tpu/eval/densefusion.py` (host NumPy and
SciPy, as there). The reference vendors `densefusion.py`
(fat_dataset/densefusion.py:190-244,350-351), a driver that runs the
external DenseFusion PoseNet/PoseRefineNet CNNs per keyframe and saves
YCB-toolbox-style result files:

    scio.savemat("%04d.mat", {"poses": [[qw, qx, qy, qz, tx, ty, tz],
                                        ...]})

one row per detection, quaternion in (w, x, y, z) order (its vendored
`transformations.quaternion_from_matrix` convention), translation in
METRES, and the row order following the PoseCNN roi list of the same
keyframe (each row i estimates the object of class ``rois[i][1]``).

The CNNs themselves are external torch weights (out of scope, like the
live MaskRCNN); what this module replaces is the durable file side:
read DenseFusion-format result dumps, recover per-row class ids from
an explicit list or a PoseCNN ``.mat`` companion, and score them under
the byte-compatible ADD/ADD-S AUC protocol (`eval/metrics.py`) so a
DenseFusion baseline column sits next to this framework's results —
the comparison the reference's README table makes against its paper
numbers.
"""

from __future__ import annotations

import os

import numpy as np

from perception_tpu_torch.eval.dope import (
    quat_xyzw_to_matrix,
    score_detections,
)


def quat_wxyz_to_matrix(q) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) quaternion (DenseFusion rows)."""
    w, x, y, z = q
    return quat_xyzw_to_matrix((x, y, z, w))


def load_densefusion_mat(path: str, class_ids=None) -> list[dict]:
    """One DenseFusion result .mat -> [{category_id, r (3x3), t (m)}].

    ``class_ids`` supplies the per-row object class (the PoseCNN roi
    class column the reference keys rows by); rows beyond the list — or
    all rows when it is omitted — get category_id 0. All-zero rows (the
    reference writes ``[0.0]*7`` for failed frames) are dropped.
    """
    import scipy.io as scio
    data = scio.loadmat(path)
    poses = np.atleast_2d(np.asarray(data.get("poses"), np.float64))
    out = []
    for i, row in enumerate(poses):
        if row.shape[0] != 7 or not np.any(row):
            continue
        cid = (int(class_ids[i])
               if class_ids is not None and i < len(class_ids) else 0)
        out.append({
            "category_id": cid,
            "id": i,
            "r": quat_wxyz_to_matrix(row[:4]),
            "t": np.asarray(row[4:7], np.float64),
        })
    return out


def evaluate_densefusion_results(
    results_dir: str,
    gt: dict[str, list[dict]],
    model_points: dict[int, np.ndarray],
    class_ids: dict[str, list[int]] | None = None,
    symmetric_ids: set[int] = frozenset(),
) -> dict:
    """Score a directory of per-keyframe DenseFusion .mat dumps.

    Mirrors `evaluate_dope_results` (eval/dope.py): ``gt`` maps the dump
    basename (without .mat) to ground-truth {category_id, r, t} lists;
    ``class_ids`` optionally maps the same keys to the per-row class-id
    list of that keyframe's detections. Each GT object scores the best
    same-class detection; misses count as max error under the shared
    AUC protocol (fat_pose_image.py:3793+).
    """
    def detections_of(key):
        path = os.path.join(results_dir, key + ".mat")
        ids = class_ids.get(key) if class_ids else None
        return load_densefusion_mat(path, ids) if os.path.exists(path) else []

    return score_detections(gt, model_points, symmetric_ids, detections_of)
