"""DOPE baseline ingestion + evaluation.

The port's copy of `perception_tpu/eval/dope.py` (host NumPy, as there).
The reference ships `dope_image.py` (fat_dataset/dope_image.py:500-633),
a driver that runs the external DOPE belief-map CNN + PnP on FAT/YCB
images and dumps per-image annotation lists:

    [{"location": [x, y, z]            # CENTIMETRES (dope convention)
      "quaternion_xyzw": [x, y, z, w],
      "category_id": <int>,
      "id": <detection index>}, ...]

which its evaluation notebooks then score against ground truth with the
same ADD/ADD-S AUC protocol this framework implements byte-compatibly in
`eval/metrics.py`. The CNN itself is external (torch weights); what this
module replaces is the durable file side: read DOPE-format annotation
dumps, convert cm -> m / xyzw -> rotation, and score them against a
ground-truth pose table under the shared protocol — so a DOPE baseline
column can sit next to this framework's results in one table.
"""

from __future__ import annotations

import json
import os

import numpy as np

from perception_tpu_torch.eval.metrics import (
    add_err,
    adi_err,
    compute_pose_metrics,
)


def quat_xyzw_to_matrix(q) -> np.ndarray:
    """Rotation matrix from an (x, y, z, w) quaternion (DOPE convention)."""
    x, y, z, w = (float(v) for v in q)
    n = max(np.sqrt(x * x + y * y + z * z + w * w), 1e-12)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def load_dope_annotations(path: str) -> list[dict]:
    """One DOPE annotation dump -> [{category_id, r (3x3), t (m)}].

    Accepts the raw list dope_image.py returns or a dict wrapping it
    under "annotations" (the sidecar-JSON layout its batch driver
    writes). Locations convert cm -> m (dope_image.py:581
    CONVERT_SCALE_CM_TO_METERS)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("annotations", [])
    out = []
    for ann in data:
        loc = ann.get("location")
        quat = ann.get("quaternion_xyzw")
        if loc is None or quat is None:
            continue
        out.append({
            "category_id": int(ann.get("category_id", 0)),
            "id": int(ann.get("id", 0)),
            "r": quat_xyzw_to_matrix(quat),
            "t": np.asarray(loc, np.float64) / 100.0,
        })
    return out


def evaluate_dope_results(
    results_dir: str,
    gt: dict[str, list[dict]],
    model_points: dict[int, np.ndarray],
    symmetric_ids: set[int] = frozenset(),
) -> dict:
    """Score a directory of per-image DOPE dumps against ground truth.

    ``gt`` maps image key (the dump's basename without .json) to a list
    of {category_id, r, t} ground-truth poses (metres); ``model_points``
    maps category_id to [K, 3] model points. Each GT object matches the
    detection of its category with the smallest error (the reference
    protocol scores one estimate per GT instance; missing detections
    count as max error, fat_pose_image.py:3793+). Returns the protocol
    metrics plus the raw per-object error list."""
    def detections_of(key):
        path = os.path.join(results_dir, key + ".json")
        return load_dope_annotations(path) if os.path.exists(path) else []

    return score_detections(gt, model_points, symmetric_ids, detections_of)


def score_detections(gt: dict[str, list[dict]],
                     model_points: dict[int, np.ndarray],
                     symmetric_ids, detections_of) -> dict:
    """The shared protocol of the baseline columns: each GT object of each
    image key scores the detection of its category (detections_of(key):
    [{category_id, r, t}]) with the smallest ADD (ADD-S for symmetric_ids);
    a missing one counts as an infinite error. The protocol metrics plus
    the detected / total counts and the raw per-object errors."""
    errs = []
    matched = 0
    total = 0
    for key, gt_objs in gt.items():
        dets = detections_of(key)
        for obj in gt_objs:
            total += 1
            cid = int(obj["category_id"])
            pts = model_points[cid]
            err_fn = adi_err if cid in symmetric_ids else add_err
            cands = [d for d in dets if d["category_id"] == cid]
            if not cands:
                errs.append(np.inf)
                continue
            best = min(err_fn(d["r"], d["t"], obj["r"], obj["t"], pts)
                       for d in cands)
            errs.append(best)
            matched += 1
    metrics = compute_pose_metrics(np.asarray(errs, np.float64))
    metrics["detected"] = matched
    metrics["total"] = total
    metrics["errors"] = [float(e) for e in errs]
    return metrics
