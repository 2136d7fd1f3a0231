"""Viewpoint sampling on the sphere.

The port's copy of `sphere_fibonacci_grid` from
`perception_tpu/eval/sampling.py` (the reference's
fat_dataset/sphere_fibonacci_grid_points.py): the env's pose refinement
takes its rotation axes from it.
"""

from __future__ import annotations

import math

import numpy as np


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
