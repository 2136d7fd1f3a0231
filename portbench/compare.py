"""The comparison that decides `correct`: every reply of the window against
the plain reference's answer to its frame.

Numbers, each the worst over every reply of the run:

  failed        requests that got no answer or an error;
  missing       objects that one side reports and the other does not;
  pose_gap_mm   greedy modes: the distance from the program's detection to
                the nearest of the reference's eligible candidates after ICP
                (the largest displacement of a corner of the model's
                bounding box along any axis); the tree: to the reference's
                detection;
  cost_gap      greedy modes: how far the cost of that nearest candidate
                lies above the reference's best (integer percent; the
                rendered cost alone in greedy_icp, whose choice it is).

A limit comes from the lower and upper readings recorded in PERF.md; the
limits live in `limits/<mode>.json`, or in `limits/<config>.<mode>.json`
for a configuration that has limits of its own.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench.reference.geometry import quat_to_matrix

LIMITS = Path(__file__).resolve().parent / "limits"


def limits(mode: str, config: str | None = None,
           where: Path = LIMITS) -> dict:
    """The configuration's own limits for the mode where it has a file of
    them, else the mode's."""
    own = Path(where) / f"{config}.{mode}.json"
    path = own if config and own.exists() else Path(where) / f"{mode}.json"
    return json.loads(path.read_text())


def reply_transform(det: dict) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = quat_to_matrix(*det["quaternion_xyzw"])
    out[:3, 3] = det["translation"]
    return out


def _corners(model) -> np.ndarray:
    """[8, 4] homogeneous bounding-box corners in the original mesh frame."""
    c = np.c_[model.corners(), np.ones(8)]
    return c @ np.linalg.inv(model.preprocessing).T


def corner_gap_mm(a: np.ndarray, b: np.ndarray, corners: np.ndarray) -> float:
    """The largest per-axis displacement (mm) of the corners between two
    poses."""
    return float(np.abs((corners @ a.T - corners @ b.T)[:, :3]).max() * 1e3)


def compare(mode: str, replies: list, answers: list, frame_of: list,
            bank) -> dict:
    """replies: parsed replies (None for a failed request); answers: the
    reference's Answer per distinct frame; frame_of: each reply's frame."""
    out = {"failed": 0, "missing": 0, "pose_gap_mm": 0.0}
    if mode != "tree":
        out["cost_gap"] = 0
    corners = [_corners(m) for m in bank.models]
    for reply, f in zip(replies, frame_of):
        if reply is None or "detections" not in reply:
            out["failed"] += 1
            continue
        ans = answers[f]
        got = {d["name"]: reply_transform(d) for d in reply["detections"]}
        want = dict(zip(ans.names, zip(ans.keys, ans.poses)))
        out["missing"] += len(set(got) ^ set(want))
        for name in set(got) & set(want):
            key, ref_pose = want[name]
            c = corners[key[0]]
            if mode == "tree":
                gap = corner_gap_mm(got[name], ref_pose, c)
                out["pose_gap_mm"] = max(out["pose_gap_mm"], gap)
                continue
            value = (lambda su: su.target) if mode == "greedy_icp" else (
                lambda su: su.cost)
            cands = ans.scored[key]
            gaps = np.array([corner_gap_mm(got[name], su.world, c)
                             for su in cands])
            near = gaps.min()
            match = min((su for su, g in zip(cands, gaps) if g <= near + 1e-6),
                        key=value)
            out["pose_gap_mm"] = max(out["pose_gap_mm"], float(near))
            out["cost_gap"] = max(out["cost_gap"],
                                  value(match) - value(ans.best[key]))
    return out


def verdict(numbers: dict, lim: dict) -> tuple[bool, list[str]]:
    """(every number within its limit, one line per number)."""
    lines, ok = [], True
    for name, value in numbers.items():
        limit = lim[name]
        good = value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines
