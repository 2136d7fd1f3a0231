"""The Kinect-class depth degradation of a 3-DoF frame, frozen from the
port's `eval/sensor_model.py` (the same parameters and the same draws from
the caller's rng): edge dropout on the clean image, uniform dropout,
range-dependent Gaussian noise, disparity quantisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Parameters of the synthetic degradation. Defaults approximate a
    Kinect-class structured-light sensor at 0.5-1.5 m range."""

    # Gaussian depth noise: sigma(z) = depth_std + depth_std_quad * z^2.
    depth_std: float = 0.001          # m, range-independent floor
    depth_std_quad: float = 2.85e-3   # 1/m (Kinect axial-noise fit)
    # Disparity quantisation: the sensor resolves disparity steps of
    # (1/8 pixel) / (fx * baseline). Depth step at range z is
    # z^2 * disparity_step. 0 disables. Kinect: fx~580 px, baseline
    # 0.075 m, 1/8 px steps -> 1/(580*0.075*8) ~= 2.87e-3 1/m.
    disparity_step: float = 2.87e-3   # 1/m
    # Edge dropout: pixels whose 4-neighbour depth jump exceeds
    # edge_jump (m) drop with probability edge_dropout.
    edge_jump: float = 0.02
    edge_dropout: float = 0.5
    # Uniform random dropout of valid pixels.
    random_dropout: float = 0.002
    # Colour: per-channel multiplicative gain ~ N(1, color_gain_std),
    # global brightness offset ~ N(0, color_offset_std) (0..255 units),
    # per-pixel additive noise ~ N(0, color_noise_std).
    color_gain_std: float = 0.06
    color_offset_std: float = 6.0
    color_noise_std: float = 3.0

    def apply_depth(self, depth_m: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """Degrade a metric depth image (0 = missing). Returns a copy."""
        d = np.array(depth_m, dtype=np.float64, copy=True)
        valid = d > 0

        # Edge dropout first (computed on the clean image so the boundary
        # detection is not confounded by the additive noise).
        if self.edge_dropout > 0 and self.edge_jump > 0:
            edge = np.zeros_like(valid)
            for axis, shift in ((0, 1), (0, -1), (1, 1), (1, -1)):
                nb = np.roll(d, shift, axis=axis)
                nb_valid = np.roll(valid, shift, axis=axis)
                jump = (np.abs(d - nb) > self.edge_jump) | ~nb_valid
                edge |= valid & jump
            drop = edge & (rng.random(d.shape) < self.edge_dropout)
            d[drop] = 0.0
            valid = d > 0

        if self.random_dropout > 0:
            drop = valid & (rng.random(d.shape) < self.random_dropout)
            d[drop] = 0.0
            valid = d > 0

        if self.depth_std > 0 or self.depth_std_quad > 0:
            z = d[valid]
            sigma = self.depth_std + self.depth_std_quad * z * z
            d[valid] = np.maximum(z + sigma * rng.standard_normal(z.shape),
                                  1e-3)

        if self.disparity_step > 0:
            z = d[valid]
            inv = np.round(1.0 / z / self.disparity_step)
            d[valid] = 1.0 / np.maximum(inv, 1.0) / self.disparity_step
        return d


KINECT = SensorModel()
