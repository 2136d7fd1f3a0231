"""Debug images.

The port's copy of `colorize_depth` and `save_depth_image` from
`perception_tpu/utils/debug.py`, writing PNGs with `io.images.write_png`.
The env dumps its final greedy state through them when
`PerchConfig.vis_expanded_states` is set and `PerceptionEnv.debug_dir` names
a directory.
"""

from __future__ import annotations

import os

import numpy as np

from perception_tpu_torch.io.images import write_png


def colorize_depth(depth: np.ndarray,
                   max_depth: float | None = None) -> np.ndarray:
    """int / float depth -> uint8 RGB: red rises and blue falls with depth,
    green marks valid pixels, empty pixels are black."""
    d = np.asarray(depth, dtype=np.float64)
    valid = d > 0
    if max_depth is None:
        max_depth = d.max() if valid.any() else 1.0
    norm = np.where(valid, np.clip(d / max(max_depth, 1e-9), 0, 1), 0)
    r = (255 * norm).astype(np.uint8)
    b = (255 * (1 - norm) * valid).astype(np.uint8)
    g = np.where(valid, 80, 0).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def save_depth_image(depth: np.ndarray, path: str,
                     max_depth: float | None = None) -> None:
    """colorize_depth(depth) as a PNG file, its directory made if needed."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, colorize_depth(depth, max_depth))
