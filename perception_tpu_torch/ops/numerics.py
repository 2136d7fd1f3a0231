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
