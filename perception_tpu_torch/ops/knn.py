"""k-nearest neighbours within a cloud (for the segment normals).

Counterpart of `knn_self` in `perception_tpu/ops/knn.py`; the batched 1-NN
(`nn1_batch`) of the composed cost and ICP paths is not ported yet.
"""

from __future__ import annotations

import torch


def knn_self(xyz: torch.Tensor, valid: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN of each point within its own cloud, self excluded.

    xyz [N, P, 3], valid [N, P] -> (dists [N, P, k], idx [N, P, k] int32),
    nearest first; invalid neighbours sort last with distance inf. The
    selection is a stable sort, so equal distances keep the lower index, as
    lax.top_k does."""
    p = xyz.shape[1]
    diff = xyz[:, :, None, :] - xyz[:, None, :, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])
    eye = torch.eye(p, dtype=torch.bool, device=xyz.device)
    d = torch.where(valid[:, None, :] & ~eye, d, float("inf"))
    dists, idx = torch.sort(d, dim=-1, stable=True)
    return dists[..., :k], idx[..., :k].to(torch.int32)
