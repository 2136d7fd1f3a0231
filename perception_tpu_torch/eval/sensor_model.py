"""Synthetic RGB-D sensor degradation model.

The port's own copy of `perception_tpu/eval/sensor_model.py` (numpy only):
the same parameters and the same draws from the caller's rng, so one seed
degrades an observation identically in both packages.

The reference's simulator applies Gaussian depth noise and depth
quantization to every rendered observation before scoring
(kinect_sim/src/range_likelihood.cpp:1203-1241 `addNoise`: sigma 0.0015 in
normalised GL depth, then ceil(d * 470)/470 bin quantisation; its comments
also name edge noise as the missing next term). Without a sensor model,
accuracy benchmarks that render their own observations are circular: the
observed depth is bit-identical to what the candidate renderer produces at
the ground-truth pose, vertex colours are perfectly consistent, and the
sensor_resolution threshold is never stressed.

This module provides the de-circularising counterpart, in metric units:

  * additive Gaussian depth noise with the Kinect's range-dependent term
    (sigma(z) = base + quad * z^2; Khoshelham & Elberink 2012 fit
    quad ~= 2.85e-3 1/m),
  * disparity-space quantisation (the Kinect measures disparity, so the
    depth step grows as z^2 — matching the reference's fixed-bin intent but
    physically parameterised),
  * edge/boundary dropout: pixels whose local depth gradient exceeds a
    jump threshold go missing with given probability (occlusion-boundary
    speckle), plus uniform random dropout,
  * colour gain / white-balance / additive-noise perturbation per frame.

Everything is host-side numpy on the observation image (it runs once per
scene, not per candidate) and fully determined by the caller's rng.
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

    def apply_color(self, color: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """Degrade an RGB image (float, 0..255). Returns a copy."""
        c = np.array(color, dtype=np.float64, copy=True)
        gains = 1.0 + self.color_gain_std * rng.standard_normal(3)
        offset = self.color_offset_std * rng.standard_normal()
        c = c * gains + offset
        if self.color_noise_std > 0:
            c = c + self.color_noise_std * rng.standard_normal(c.shape)
        return np.clip(c, 0.0, 255.0)

    def apply(self, depth_m: np.ndarray, color: np.ndarray | None,
              rng: np.random.Generator):
        out_c = None if color is None else self.apply_color(color, rng)
        return self.apply_depth(depth_m, rng), out_c


# The benchmark default: every knob on, Kinect-class magnitudes.
KINECT_CLASS = SensorModel()

# Noise-free passthrough (the round-1/2 circular setting, kept for A/B).
NOISELESS = SensorModel(depth_std=0.0, depth_std_quad=0.0,
                        disparity_step=0.0, edge_jump=0.0, edge_dropout=0.0,
                        random_dropout=0.0, color_gain_std=0.0,
                        color_offset_std=0.0, color_noise_std=0.0)


def by_name(name: str) -> SensorModel:
    """Benchmark CLI lookup: 'none' | 'kinect' | 'kinect2x' (doubled
    noise magnitudes for stress)."""
    if name in ("none", "off", ""):
        return NOISELESS
    if name == "kinect":
        return KINECT_CLASS
    if name == "kinect2x":
        k = KINECT_CLASS
        return SensorModel(
            depth_std=2 * k.depth_std, depth_std_quad=2 * k.depth_std_quad,
            disparity_step=2 * k.disparity_step, edge_jump=k.edge_jump,
            edge_dropout=min(1.0, 2 * k.edge_dropout),
            random_dropout=2 * k.random_dropout,
            color_gain_std=2 * k.color_gain_std,
            color_offset_std=2 * k.color_offset_std,
            color_noise_std=2 * k.color_noise_std)
    raise ValueError(f"unknown sensor model {name!r}")
