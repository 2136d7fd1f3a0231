"""Nearest neighbours: the batched masked 1-NN and k-NN within a cloud.

`nn1_batch` is the counterpart of `nn1_batch_pallas` in
`perception_tpu/ops/pallas_knn.py` (the composed "nn" and "gicp" refiners'
association): for each query, the minimum difference-form squared distance
dx^2 + dy^2 + dz^2 + add to the pose's references (add = +inf for an invalid
reference) and the lowest index attaining it; (inf, 0) when no reference is
valid. The kernel (`csrc/knn.cu`) and the PyTorch twin compute it alike.
`knn_self` is the counterpart of `knn_self` in `perception_tpu/ops/knn.py`
(the normals' neighbourhoods).
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops.cost_fused import nearest


def nn1_batch(query_xyz: torch.Tensor, query_valid: torch.Tensor,
              ref_xyz: torch.Tensor, ref_valid: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """query [N, P, 3], ref [N, S, 3] with validity [N, S] ->
    (min d^2 [N, P] float32, argmin [N, P] int32). `query_valid` is unused,
    as in the JAX function. CUDA tensors launch the kernel; CPU tensors run
    the twin."""
    args, _ = prepare_inputs(query_xyz, query_valid, ref_xyz, ref_valid)
    if query_xyz.device.type == "cpu":
        build.TWIN_CALLS["nn1_batch"] += 1
        return nn1_batch_twin(*args)
    return launch_kernel(*args)


def prepare_inputs(query_xyz, query_valid, ref_xyz, ref_valid
                   ) -> tuple[tuple, dict]:
    """The kernel's (and the twin's) arguments: contiguous f32 queries and
    the references with their 0 / +inf additive, [N, S, 4]."""
    del query_valid
    if ref_xyz.shape[1] == 0:
        raise ValueError("nn1_batch: no references")
    query = query_xyz.to(torch.float32).contiguous()
    add = torch.where(ref_valid, 0.0, float("inf")).to(torch.float32)
    ref4 = torch.cat([ref_xyz.to(torch.float32), add[..., None]],
                     dim=-1).contiguous()
    return (query, ref4), {}


def launch_kernel(query: torch.Tensor, ref4: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/knn.cu on CUDA tensors."""
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"nn1_batch kernel: tensors on {dev}")
    n, p, _ = query.shape
    s = ref4.shape[1]
    build.check(query, "query_xyz", torch.float32, (n, p, 3), dev)
    build.check(ref4, "ref4", torch.float32, (n, s, 4), dev)
    if n > 65535:
        raise ValueError(f"nn1_batch kernel: N={n} poses exceed the grid")
    if ref4.data_ptr() % 16:
        raise ValueError("nn1_batch kernel: ref4 is not 16-byte aligned")
    dist = torch.empty((n, p), dtype=torch.float32, device=dev)
    idx = torch.empty((n, p), dtype=torch.int32, device=dev)
    build.launch("pt_nn1_batch", build.ptr(query), build.ptr(ref4), n, p, s,
                 build.ptr(dist), build.ptr(idx))
    return dist, idx


def nn1_batch_twin(query: torch.Tensor, ref4: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same distances, the lowest
    index among equal minima (index 0 when every distance is inf)."""
    dist, win = nearest(query, ref4)
    return dist, torch.clamp(win, max=ref4.shape[1] - 1).to(torch.int32)


# Distance entries of one row block of knn_self: bounds its memory (the
# block's [N, rows, P] distances, their differences and keys) whatever P is.
KNN_BLOCK = 1 << 24
_KEY_MAX = torch.iinfo(torch.int64).max


def knn_self(xyz: torch.Tensor, valid: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN of each point within its own cloud, self excluded.

    xyz [N, P, 3], valid [N, P] -> (dists [N, P, k], idx [N, P, k] int32),
    nearest first; invalid neighbours sort last with distance inf. Equal
    distances keep the lower index first, as lax.top_k does, so the result
    is a stable sort's first k. The distances are built in row blocks of at
    most KNN_BLOCK entries, and each block selects its k smallest by k
    passes of a minimum over unique keys: a non-negative float32's bits
    order like its value, and the low 32 bits hold the index."""
    n, p, _ = xyz.shape
    dev = xyz.device
    dists = torch.empty((n, p, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, p, k), dtype=torch.int32, device=dev)
    cols = torch.arange(p, device=dev)
    rows = max(1, KNN_BLOCK // max(n * p, 1))
    for lo in range(0, p, rows):
        hi = min(p, lo + rows)
        diff = xyz[:, lo:hi, None, :] - xyz[:, None, :, :]    # [N, r, P, 3]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        del diff
        other = cols[lo:hi, None] != cols[None, :]
        d = torch.where(valid[:, None, :] & other, d, float("inf"))
        key = (d.contiguous().view(torch.int32).to(torch.int64) << 32) | cols
        del d
        for j in range(k):
            m = key.amin(dim=-1)                                # [N, r]
            col = m & 0xFFFFFFFF
            dists[:, lo:hi, j] = (m >> 32).to(torch.int32).view(torch.float32)
            idx[:, lo:hi, j] = col.to(torch.int32)
            key.scatter_(-1, col[..., None], _KEY_MAX)
    return dists, idx
