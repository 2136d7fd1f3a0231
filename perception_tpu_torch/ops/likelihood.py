"""Per-particle depth-image log-likelihood.

Counterpart of `perception_tpu/ops/likelihood.py` (the reference's
kinect_sim `RangeLikelihood::computeLikelihoods`): the particle axis is the
leading batch axis of the rendered depth stack, and each particle's score is
one masked sum of a per-pixel log-likelihood. Two modes:

  * "gaussian_mixture" (the reference's costFunction2): per pixel
    log(floor / r_max + (1 - floor) * HN(|obs - rend|)), HN the half-normal
    pdf 2 N(d; 0, sigma), the distance clamped at r_max;
  * "disparity_truncated" (costFunction5): a Gaussian in normalised
    disparity (disp = -0.7253 / depth + 1.0360, the freenect calibration),
    truncated to [0, 1] and renormalised, mixed with a uniform floor.

Pixels where either depth is non-positive or not finite score 0. Plain
tensor code on the inputs' device.
"""

from __future__ import annotations

import math

import torch

_DISP_A = -0.7253
_DISP_B = 1.0360


def _half_normal_pdf(d: torch.Tensor, sigma: float) -> torch.Tensor:
    return (2.0 / (sigma * math.sqrt(2.0 * math.pi))) * torch.exp(
        -(d * d) / (2.0 * sigma * sigma))


def _norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def particle_log_likelihood(
    observed_depth: torch.Tensor,   # [...pix] metres, <= 0 or NaN invalid
    rendered_depth: torch.Tensor,   # [N, ...pix] metres, <= 0 or NaN invalid
    *,
    mode: str = "gaussian_mixture",
    sigma: float = 0.5,
    floor_ratio: float = 0.99,
    r_max: float = 3.0,
) -> torch.Tensor:
    """Summed per-pixel depth log-likelihood of each particle: [N] float32.
    `observed_depth` broadcasts against the particle axis."""
    obs = (observed_depth[None]
           if observed_depth.dim() == rendered_depth.dim() - 1
           else observed_depth).to(torch.float32)
    rend = rendered_depth.to(torch.float32)
    obs_ok = torch.isfinite(obs) & (obs > 0.0)
    rend_ok = torch.isfinite(rend) & (rend > 0.0)
    valid = obs_ok & rend_ok
    if mode == "gaussian_mixture":
        d = torch.clamp(torch.abs(torch.where(valid, obs, 0.0)
                                  - torch.where(valid, rend, 0.0)), max=r_max)
        lhood = floor_ratio / r_max + (1.0 - floor_ratio) * _half_normal_pdf(
            d, sigma)
    elif mode == "disparity_truncated":
        measured = _DISP_A / torch.where(obs_ok, obs, 1.0) + _DISP_B
        model = torch.clamp(
            torch.where(rend_ok, _DISP_A / torch.where(rend_ok, rend, 1.0)
                        + _DISP_B, 0.0), 0.0, 1.0)
        z = (measured - model) / sigma
        gauss = torch.exp(-0.5 * z * z) / (sigma * math.sqrt(2.0 * math.pi))
        trunc = 1.0 / torch.clamp(
            _norm_cdf((1.0 - model) / sigma) - _norm_cdf((0.0 - model) / sigma),
            min=1e-12)
        lhood = floor_ratio + (1.0 - floor_ratio) * trunc * gauss
    else:
        raise ValueError(f"unknown likelihood mode {mode!r}")
    log_l = torch.where(valid, torch.log(lhood), 0.0)
    return log_l.reshape(log_l.shape[0], -1).sum(dim=-1)


def depth_cm_to_m(depth_cm: torch.Tensor) -> torch.Tensor:
    """int32-cm render depth (0 = empty) -> metres float32 (0 = invalid)."""
    return depth_cm.to(torch.float32) * 0.01


def best_particle(log_likelihoods: torch.Tensor) -> torch.Tensor:
    """The index of the most likely particle."""
    return torch.argmax(log_likelihoods)
