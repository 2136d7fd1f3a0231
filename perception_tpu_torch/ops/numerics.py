"""Float32 arithmetic that rounds the same on the CPU and on the card.

PyTorch's CUDA kernels divide a tensor by a Python scalar as a multiplication
by its reciprocal, and its CPU sqrt is not correctly rounded; the CUDA
kernels of this package and the JAX reference divide and take square roots
as IEEE operations. These helpers give the IEEE result on both devices, so a
twin on the CPU computes what the kernel computes on the card.
"""

from __future__ import annotations

import torch


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a correctly rounded division by float32(v)."""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (float64 root, rounded once)."""
    return torch.sqrt(x.double()).to(x.dtype)


def dot3_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over a last axis of 3 of a * b (broadcast), as XLA's CPU backend
    reduces it: a chain of fused multiply-adds in index order, each rounded
    once (float64 product and sum, rounded to float32; the same on both
    devices)."""
    a64, b64 = a.double(), b.double()
    acc = (a64[..., 0] * b64[..., 0]).to(a.dtype)
    for i in (1, 2):
        acc = (a64[..., i] * b64[..., i] + acc.double()).to(a.dtype)
    return acc
