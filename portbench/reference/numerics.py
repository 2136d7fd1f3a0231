"""Float32 division and square root that round as IEEE operations on the
CPU and the card alike (PyTorch's CUDA division by a Python scalar is a
multiplication by its reciprocal; its CPU square root is not correctly
rounded)."""

from __future__ import annotations

import torch


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v, correctly rounded, by float32(v)."""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (float64 root, rounded once)."""
    return torch.sqrt(x.double()).to(x.dtype)
