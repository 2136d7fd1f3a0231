"""The candidate-pose axis split across devices and processes.

Counterpart of `perception_tpu/parallel/sharding.py`. The JAX version is one
program over a device mesh; here, as PyTorch does it, every device has its
own process on `torch.distributed`. Each rank holds the model bank and the
observed scene whole, scores one contiguous chunk of the candidates on its
own device with `pipeline/scorer.score_pose_batch`, and the per-pose results
are all-gathered, so every rank returns the full result (the reference's
scatter / gather of candidate chunks, search_env.cpp:920-1023, with its
dummy padding, :934-947).

A pose's scores do not depend on the other poses of its batch (every kernel
and twin works pose by pose), so the gathered result equals one process's
`score_pose_batch` over all the poses.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from perception_tpu_torch.pipeline.scorer import (
    ObservedScene,
    PoseScores,
    ScorerConfig,
    score_pose_batch,
)


@dataclasses.dataclass(frozen=True)
class PoseMesh:
    """The ranks the pose axis is split over: the process group (None for
    one process without torch.distributed), this process's rank in it, its
    size, and the device this rank scores on."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the pose mesh runs on the "
                               "card unless given device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_pose_mesh(device: str | torch.device = "cuda",
                   group=None) -> PoseMesh:
    """The 1-D pose mesh over `group` (default: the world group when
    torch.distributed is initialised, else this process alone). `device`
    is this rank's device: with one rank per card, the caller passes its
    own card (e.g. f"cuda:{local_rank}")."""
    device = _device(device)
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise RuntimeError("a process group needs torch.distributed "
                               "initialised (parallel.dist)")
        return PoseMesh(group=None, rank=0, world_size=1, device=device)
    group = group or dist.group.WORLD
    return PoseMesh(group=group, rank=dist.get_rank(group),
                    world_size=dist.get_world_size(group), device=device)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _clock(device: torch.device) -> float:
    """The host clock once the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _to(x, device):
    return None if x is None else x.to(device)


def _gather(x: torch.Tensor, mesh: PoseMesh) -> torch.Tensor:
    """The ranks' [per, ...] chunks of one per-pose field, concatenated in
    rank order on every rank."""
    backend = dist.get_backend(mesh.group)
    # Gloo gathers host tensors only: where the ranks share one card over
    # gloo (NCCL refuses two ranks on one device), each rank's per-pose
    # results go to the host for the gather and come back after it.
    staged = x.cpu() if backend == "gloo" else x
    dtype = staged.dtype
    if dtype == torch.bool:
        staged = staged.to(torch.uint8)
    staged = staged.contiguous()
    parts = [torch.empty_like(staged) for _ in range(mesh.world_size)]
    dist.all_gather(parts, staged, group=mesh.group)
    return torch.cat(parts).to(dtype).to(x.device)


def score_pose_batch_multichip(
    mesh: PoseMesh,
    bank_tri_verts, bank_tri_colors, bank_tri_valid,
    poses, model_ids, pose_labels, observed_total,
    proj, scene: ObservedScene,
    cfg: ScorerConfig,
    bank_backface=None,
    bank_icp_samples=None,
    bank_icp_normals=None,
    bank_tri_lab=None,
    timings: dict | None = None,
) -> PoseScores:
    """Pose-split scoring: the arguments of `score_pose_batch` (every aux
    bank forwarded, as the single-process path gets them), each rank on its
    contiguous chunk. The pose axis is padded to a multiple of the world
    size with zero poses of model 0, label 0 and total 0 (they score -1);
    the padding is sliced off the gathered result. With one rank no
    collective runs and the result is `score_pose_batch`'s own. Every rank
    returns every pose's scores, on mesh.device. Given a dict `timings`,
    its "batch_ms" and "gather_ms" get the host-clock times of this rank's
    scoring and of the gather, each with the device synchronised."""
    dev = mesh.device
    common = [_to(x, dev) for x in (bank_tri_verts, bank_tri_colors,
                                    bank_tri_valid)]
    aux = dict(bank_backface=_to(bank_backface, dev),
               bank_icp_samples=_to(bank_icp_samples, dev),
               bank_icp_normals=_to(bank_icp_normals, dev),
               bank_tri_lab=_to(bank_tri_lab, dev))
    scene = ObservedScene(**{f.name: getattr(scene, f.name).to(dev)
                             for f in dataclasses.fields(scene)})
    per_pose = [poses, model_ids, pose_labels, observed_total]
    n = poses.shape[0]
    t0 = _clock(dev)
    if mesh.world_size == 1:
        scores = score_pose_batch(*common, *[x.to(dev) for x in per_pose],
                                  proj.to(dev), scene, cfg, **aux)
        if timings is not None:
            timings.update(batch_ms=(_clock(dev) - t0) * 1e3, gather_ms=0.0)
        return scores
    n_pad = pad_to_multiple(max(n, mesh.world_size), mesh.world_size)
    per = n_pad // mesh.world_size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    chunk = []
    for x in per_pose:
        x = x.to(dev)
        if n_pad > n:
            pad = torch.zeros((n_pad - n, *x.shape[1:]), dtype=x.dtype,
                              device=dev)
            x = torch.cat([x, pad])
        chunk.append(x[lo:hi])
    scores = score_pose_batch(*common, *chunk, proj.to(dev), scene, cfg,
                              **aux)
    t1 = _clock(dev)
    out = PoseScores(**{f.name: _gather(getattr(scores, f.name), mesh)[:n]
                        for f in dataclasses.fields(scores)})
    if timings is not None:
        timings.update(batch_ms=(t1 - t0) * 1e3,
                       gather_ms=(_clock(dev) - t1) * 1e3)
    return out
