"""ICP support: segment normals and the target crop.

Counterpart of the parts of `perception_tpu/ops/icp.py` that the fused
point-to-plane path needs: `smallest_eigenvector_3x3`, `cloud_normals` (k-NN
covariance normals, oriented towards the camera) and `crop_targets` in mode
"near". The composed ICP solvers ("nn", "projective", "gicp") are not ported
yet.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.ops.knn import knn_self


def smallest_eigenvector_3x3(cov: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Smallest eigenvector of symmetric [..., 3, 3] matrices by shifted power
    iteration on (trace * I - C)^2 from a fixed start."""
    sigma = torch.diagonal(cov, dim1=-2, dim2=-1).sum(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    m = sigma * eye - cov
    m = m @ m
    start = (torch.full((3,), 0.57735, dtype=cov.dtype, device=cov.device)
             + torch.tensor([0.1, -0.05, 0.02], dtype=cov.dtype,
                            device=cov.device))
    v = start.expand(cov.shape[:-1])
    for _ in range(iters):
        v = (m @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-20)
    return v


def cloud_normals(xyz: torch.Tensor, valid: torch.Tensor,
                  k: int = 10) -> torch.Tensor:
    """Per-point normals [B, P, 3] from the covariance of the k nearest valid
    neighbours, flipped so that n . p <= 0 (towards the camera origin)."""
    _, idx = knn_self(xyz, valid, k=k)
    idx = idx.long()
    b = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    neighbors = xyz[b, idx]                               # [B, P, k, 3]
    wgt = valid[b, idx].to(xyz.dtype)[..., None]          # [B, P, k, 1]
    cnt = torch.clamp(wgt.sum(dim=2, keepdim=True), min=1.0)
    mean = (neighbors * wgt).sum(dim=2, keepdim=True) / cnt
    centered = (neighbors - mean) * wgt
    cov = torch.einsum("bpki,bpkj->bpij", centered, centered) / cnt
    n = smallest_eigenvector_3x3(cov)
    flip = torch.sign(-(n * xyz).sum(dim=-1, keepdim=True))
    return n * torch.where(flip == 0, 1.0, flip)


def crop_targets(tgt_xyz: torch.Tensor, tgt_valid: torch.Tensor,
                 centers: torch.Tensor, k: int,
                 mode: str = "near") -> torch.Tensor:
    """Indices [N, k] of the k targets nearest each centre, nearest first,
    invalid targets last. The selection is exact (a stable sort, so equal
    distances keep the lower index, as lax.top_k does on the CPU)."""
    if mode != "near":
        raise NotImplementedError(
            f"crop mode {mode!r} is not ported; only 'near' is")
    diff = tgt_xyz - centers[:, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])
    d = torch.where(tgt_valid, d, float("inf"))
    idx = torch.sort(d, dim=1, stable=True).indices
    return idx[:, :min(k, tgt_xyz.shape[1])]
