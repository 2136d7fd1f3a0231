"""Detection-driven search heuristics.

Counterpart of `perception_tpu/pipeline/heuristics.py` (the reference's
RCNNHeuristicFactory): per-object detections (bounding box and score, from
disk or in memory) become candidate-ordering keys for the tree search and
heuristic queues for MHA*: a candidate whose projected centre falls far from
its object's detected box is expanded late, or pruned.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.core.state import ObjectState
from perception_tpu_torch.io.images import write_png


@dataclasses.dataclass
class Detection:
    name: str
    bbox: tuple[float, float, float, float]   # x1, y1, x2, y2 (pixels)
    score: float = 1.0

    @property
    def center(self) -> np.ndarray:
        return np.array([(self.bbox[0] + self.bbox[2]) / 2,
                         (self.bbox[1] + self.bbox[3]) / 2])


def load_detections(path: str) -> list[Detection]:
    """Detections from a JSON file: a list of {"name" or "category", "bbox",
    "score"}, or {"detections": [...]}."""
    with open(path) as f:
        raw = json.load(f)
    return [Detection(name=d.get("name") or d.get("category"),
                      bbox=tuple(d["bbox"]),
                      score=float(d.get("score", 1.0)))
            for d in (raw if isinstance(raw, list)
                      else raw.get("detections", []))]


class DetectionHeuristicFactory:
    def __init__(self, detections: list[Detection],
                 camera: CameraIntrinsics,
                 cam_to_world: np.ndarray | None = None):
        """The best-scoring detection of each name is kept."""
        self.camera = camera
        self.world_to_cam = (np.linalg.inv(cam_to_world)
                             if cam_to_world is not None else np.eye(4))
        self.by_name: dict[str, Detection] = {}
        for d in detections:
            best = self.by_name.get(d.name)
            if best is None or d.score > best.score:
                self.by_name[d.name] = d

    def _project(self, state: ObjectState) -> np.ndarray | None:
        p = self.world_to_cam @ np.array(
            [state.pose.x, state.pose.y, state.pose.z, 1.0])
        if p[2] <= 1e-6:
            return None
        cam = self.camera
        return np.array([cam.fx * p[0] / p[2] + cam.cx,
                         cam.fy * p[1] / p[2] + cam.cy])

    def heuristic(self, names: list[str]):
        """Candidate key: the pixel distance from the candidate's projected
        centre to its object's detected box centre (0 without a detection,
        inf behind the camera); names[i] is model i's name."""

        def h(state: ObjectState) -> float:
            name = names[state.id] if state.id < len(names) else None
            det = self.by_name.get(name)
            if det is None:
                return 0.0
            uv = self._project(state)
            if uv is None:
                return float("inf")
            return float(np.linalg.norm(uv - det.center))

        return h

    def prune(self, states: list[ObjectState], names: list[str],
              max_pixel_dist: float = 80.0) -> list[ObjectState]:
        """The candidates whose projection lies within max_pixel_dist of
        their detection."""
        h = self.heuristic(names)
        return [s for s in states if h(s) <= max_pixel_dist]


def save_rois(color_image: np.ndarray, detections: list[Detection],
              out_dir: str) -> list[str]:
    """Each detection's crop of the RGB image as `roi_<i>_<name>.png`."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, d in enumerate(detections):
        x1, y1, x2, y2 = (int(v) for v in d.bbox)
        crop = np.asarray(color_image)[max(y1, 0):y2, max(x1, 0):x2]
        path = os.path.join(out_dir, f"roi_{i}_{d.name}.png")
        write_png(path, np.ascontiguousarray(crop).astype(np.uint8))
        paths.append(path)
    return paths
