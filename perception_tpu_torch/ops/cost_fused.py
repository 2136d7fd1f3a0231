"""Fused 1-NN + cost counts for the depth-only cost types (0 / 2).

Counterpart of `nn_cost_fused_pallas` in `perception_tpu/ops/pallas_cost.py`.
The kernel (`csrc/cost_fused.cu`) and its PyTorch twin compute, per pose:
the minimum squared distance from each cloud point to the observed targets
(difference form dx^2 + dy^2 + dz^2 + tadd, tadd = inf for invalid targets),
the lowest-index winner, and three counts: real points (`cadd == 0`),
unexplained real points (d^2 > res^2), and distinct targets won by a close
point that is real or explain-only (`cadd <= 0`).
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build

_TWIN_BLOCK = 1 << 22
_MAX_SHARED = 227 * 1024


def _cadd_flags(cloud_valid: torch.Tensor,
                cloud_explain_only: torch.Tensor | None) -> torch.Tensor:
    """3-state flag: 0 real, -1 explain-only augmentation, inf invalid."""
    cadd = torch.where(cloud_valid, 0.0, float("inf")).to(torch.float32)
    if cloud_explain_only is not None:
        cadd = torch.where(cloud_valid & cloud_explain_only, -1.0, cadd)
    return cadd


def nn_cost_fused(
    cloud_xyz: torch.Tensor,    # [N, P, 3]
    cloud_valid: torch.Tensor,  # [N, P] bool
    tgt_xyz: torch.Tensor,      # [N, S, 3]
    tgt_valid: torch.Tensor,    # [N, S] bool
    sensor_resolution: float,
    cloud_explain_only: torch.Tensor | None = None,   # [N, P] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(point_num [N], unexplained [N], observed_explained [N]) float32. CUDA
    tensors launch the kernel; CPU tensors run the twin."""
    args, kw = prepare_inputs(cloud_xyz, cloud_valid, tgt_xyz, tgt_valid,
                              sensor_resolution, cloud_explain_only)
    if cloud_xyz.device.type == "cpu":
        build.TWIN_CALLS["cost_fused"] += 1
        return nn_cost_fused_twin(*args, **kw)
    return launch_kernel(*args, **kw)


def prepare_inputs(cloud_xyz, cloud_valid, tgt_xyz, tgt_valid,
                   sensor_resolution, cloud_explain_only=None
                   ) -> tuple[tuple, dict]:
    """The kernel's (and the twin's) arguments: contiguous f32 cloud, its
    3-state flags, targets with their +inf additive [N, S, 4], and res^2."""
    cloud = cloud_xyz.to(torch.float32).contiguous()
    cadd = _cadd_flags(cloud_valid, cloud_explain_only).contiguous()
    tadd = torch.where(tgt_valid, 0.0, float("inf")).to(torch.float32)
    tgt4 = torch.cat([tgt_xyz.to(torch.float32), tadd[..., None]],
                     dim=-1).contiguous()
    return (cloud, cadd, tgt4), dict(
        max_dist_sq=sensor_resolution * sensor_resolution)


def launch_kernel(cloud: torch.Tensor, cadd: torch.Tensor, tgt4: torch.Tensor,
                  *, max_dist_sq: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """csrc/cost_fused.cu on CUDA tensors."""
    dev = cloud.device
    if dev.type != "cuda":
        raise ValueError(f"cost_fused kernel: tensors on {dev}")
    n, p, _ = cloud.shape
    s = tgt4.shape[1]
    build.check(cloud, "cloud_xyz", torch.float32, (n, p, 3), dev)
    build.check(cadd, "cadd", torch.float32, (n, p), dev)
    build.check(tgt4, "tgt4", torch.float32, (n, s, 4), dev)
    # Compacted targets (16 B), explained bits, and the points staged in
    # chunks of at least one round of 256 (16 B): any P fits.
    if s * 16 + -(-s // 32) * 4 + 256 * 16 > _MAX_SHARED:
        raise ValueError(f"cost_fused kernel: S={s} targets exceed shared "
                         "memory")
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    build.launch("pt_cost_fused", build.ptr(cloud), build.ptr(cadd),
                 build.ptr(tgt4), n, p, s, max_dist_sq, build.ptr(out))
    return out[:, 0], out[:, 1], out[:, 2]


def nearest(cloud: torch.Tensor, tgt4: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per cloud point: the minimum squared distance to the targets
    (summed in the kernels' order) and the lowest index attaining it (S when
    none does: NaN rows)."""
    n, p, _ = cloud.shape
    s = tgt4.shape[1]
    dmin = torch.empty((n, p), dtype=torch.float32, device=cloud.device)
    win = torch.empty((n, p), dtype=torch.int64, device=cloud.device)
    sidx = torch.arange(s, device=cloud.device)
    nb = max(1, _TWIN_BLOCK // (s * p))
    for i in range(0, n, nb):
        c = cloud[i:i + nb, :, None, :]                  # [nb, P, 1, 3]
        t = tgt4[i:i + nb, None, :, :]                   # [nb, 1, S, 4]
        dx = t[..., 0] - c[..., 0]
        dy = t[..., 1] - c[..., 1]
        dz = t[..., 2] - c[..., 2]
        d = dx * dx + dy * dy + dz * dz + t[..., 3]      # [nb, P, S]
        dm = d.amin(dim=2)
        dmin[i:i + nb] = dm
        win[i:i + nb] = torch.where(d <= dm[..., None], sidx, s).amin(dim=2)
    return dmin, win


def nn_cost_fused_twin(cloud: torch.Tensor, cadd: torch.Tensor,
                       tgt4: torch.Tensor, *, max_dist_sq: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, vectorised over poses."""
    n = cloud.shape[0]
    s = tgt4.shape[1]
    dmin, win = nearest(cloud, tgt4)
    real = cadd == 0.0
    close = (dmin <= max_dist_sq) & (cadd <= 0.0)
    point_num = real.sum(dim=1).to(torch.float32)
    unexplained = (real & (dmin > max_dist_sq)).sum(dim=1).to(torch.float32)
    explained = torch.zeros((n, s + 1), dtype=torch.float32,
                            device=cloud.device)
    explained.scatter_reduce_(1, win, close.to(torch.float32), reduce="amax")
    return point_num, unexplained, explained[:, :s].sum(dim=1)
