"""sRGB -> CIELAB conversion and the CIEDE2000 colour distance.

Counterpart of `perception_tpu/ops/color.py` (the reference's
compute_costs.cuh:57-159 `rgb2lab` / `color_distance`, branch structure
included).

`rgb_to_lab` builds Lab tables (the bank's face colours once per env, the
observed segment colours once per frame) and converts the composed cost's
rendered colours per point. It runs in float64 on the input's device and
rounds once to float32, so the card and the CPU hold the same Lab: float32
`** 2.4` and `cbrt` differ between devices.

`ciede2000_components` is written in the order and with the roundings of the
colour cost kernels (`csrc/cost_fused_color.cu`), so their PyTorch twins
give the kernels' result bit for bit: every integer power is an explicit
product in the square-and-multiply order of JAX's `integer_pow`, sin / cos /
exp / sqrt are taken in float64 and rounded once, divisions are by a tensor
(IEEE division on both devices), and every constant is float32. Hue angles
use the polynomial `atan2_poly` and a one-step conditional mod 2pi, as the
kernels do: this is the JAX package's `kernel_safe=True` branch, the only
one the port runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f32(v: float) -> float:
    """A Python float that is exactly representable in float32."""
    return float(np.float32(v))


PI = _f32(math.pi)
HALF_PI = _f32(math.pi / 2)
TWO_PI = _f32(2 * math.pi)
_EPS = 1e-5
_PI_EPS = _f32(math.pi + _EPS)
_POW25_7 = _f32(6103515625.0)
_DEG30 = _f32(30 * math.pi / 180.0)
_DEG6 = _f32(6 * math.pi / 180.0)
_DEG63 = _f32(63 * math.pi / 180.0)
# Minimax atan on [-1, 1], innermost coefficient first.
_ATAN_COEFFS = tuple(_f32(c) for c in (
    -0.01172120, 0.05265332, -0.11643287, 0.19354346, -0.33262347,
    0.99997726))


def rgb_to_lab(rgb) -> torch.Tensor:
    """sRGB (0..255, [..., 3]) -> CIELAB, D65, float32, on the input's
    device (a numpy input gives a CPU tensor). Computed in float64 and
    rounded once; the cube root as a power of 1/3."""
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.as_tensor(np.asarray(rgb))
    c = rgb.to(torch.float64) / 255.0
    c = torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4,
                    c / 12.92) * 100.0
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    x = (r * 0.4124564 + g * 0.3575761 + b * 0.1804375) / 95.047
    y = (r * 0.2126729 + g * 0.7151522 + b * 0.0721750) / 100.0
    z = (r * 0.0193339 + g * 0.1191920 + b * 0.9503041) / 108.883

    def f(t):
        return torch.where(t > 0.008856, t ** (1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    lab = torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                       200.0 * (fy - fz)], dim=-1)
    return lab.to(torch.float32)


def _div(x: torch.Tensor, v) -> torch.Tensor:
    """x / v as an IEEE float32 division (v a tensor or a float)."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v, dtype=x.dtype, device=x.device)
    return x / v


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """fn in float64, rounded once to float32."""
    return fn(x.double()).to(torch.float32)


def _sqrt(x):
    return _f64(torch.sqrt, x)


def _pow2(x):
    return x * x


def _pow7(x):
    x2 = x * x
    return (x * x2) * (x2 * x2)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Branch-free polynomial atan2, range (-pi, pi], atan2(0, 0) = 0;
    error ~1e-6 rad."""
    ax, ay = x.abs(), y.abs()
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    z = _div(mn, torch.clamp(mx, min=_f32(1e-30)))
    z2 = z * z
    acc = z2 * _ATAN_COEFFS[0]
    for c in _ATAN_COEFFS[1:-1]:
        acc = z2 * (c + acc)
    a = z * (_ATAN_COEFFS[-1] + acc)
    a = torch.where(ay > ax, HALF_PI - a, a)
    a = torch.where(x < 0, PI - a, a)
    return torch.where(y < 0, -a, a)


def _mod2pi(v: torch.Tensor) -> torch.Tensor:
    # v = atan2 + 2pi lies in (pi, 3pi]: one conditional subtract.
    return torch.where(v >= TWO_PI, v - TWO_PI, v)


def ciede2000_components(l1, a1, b1, l2, a2, b2) -> torch.Tensor:
    """CIEDE2000 distance of same-shape float32 component tensors."""
    c1 = _sqrt(_pow2(a1) + _pow2(b1))
    c2 = _sqrt(_pow2(a2) + _pow2(b2))
    mean_c7 = _pow7(_div(c1 + c2, 2.0))
    g = 0.5 * (1 - _sqrt(_div(mean_c7, mean_c7 + _POW25_7)))
    a1p = a1 * (1 + g)
    a2p = a2 * (1 + g)
    c1 = _sqrt(_pow2(a1p) + _pow2(b1))
    c2 = _sqrt(_pow2(a2p) + _pow2(b2))
    h1 = _mod2pi(atan2_poly(b1, a1p) + TWO_PI)
    h2 = _mod2pi(atan2_poly(b2, a2p) + TWO_PI)

    delta_l = l2 - l1
    delta_c = c2 - c1
    dh = h2 - h1
    # The reference's c1*c2 < eps branch is overridden by the |dh| <= pi
    # test that follows it, so it changes nothing and is left out.
    delta_h_angle = torch.where(
        dh.abs() <= PI, dh, torch.where(h2 > h1, dh - TWO_PI, dh + TWO_PI))
    delta_hh = (2 * _sqrt(c1 * c2)) * _f64(torch.sin,
                                           _div(delta_h_angle, 2.0))

    mean_l = _div(l1 + l2, 2.0)
    mean_c = _div(c1 + c2, 2.0)
    mean_c7 = _pow7(mean_c)
    hs = h1 + h2
    mean_h = torch.where(
        (h1 - h2).abs() <= _PI_EPS, _div(hs, 2.0),
        torch.where(hs < TWO_PI, _div(hs + TWO_PI, 2.0),
                    _div(hs - TWO_PI, 2.0)))

    t = (1 - 0.17 * _f64(torch.cos, mean_h - _DEG30)
         + 0.24 * _f64(torch.cos, 2 * mean_h)
         + 0.32 * _f64(torch.cos, 3 * mean_h + _DEG6)
         - 0.2 * _f64(torch.cos, 4 * mean_h - _DEG63))
    ml2 = _pow2(mean_l - 50)
    sl = 1 + _div(0.015 * ml2, _sqrt(20 + ml2))
    sc = 1 + 0.045 * mean_c
    sh = 1 + (0.015 * mean_c) * t
    rc = 2 * _sqrt(_div(mean_c7, mean_c7 + _POW25_7))
    hdeg = _div(_div(mean_h, PI) * 180.0 - 275, 25.0)
    theta = _div(60 * _f64(torch.exp, -_pow2(hdeg)) * PI, 180.0)
    rt = -_f64(torch.sin, theta) * rc

    dl = _div(delta_l, sl)
    dc = _div(delta_c, sc)
    dhh = _div(delta_hh, sh)
    return _sqrt(_pow2(dl) + _pow2(dc) + _pow2(dhh) + (rt * dc) * dhh)


def ciede2000(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """CIEDE2000 distance of [..., 3] Lab tensors."""
    return ciede2000_components(
        lab1[..., 0], lab1[..., 1], lab1[..., 2],
        lab2[..., 0], lab2[..., 1], lab2[..., 2])
