"""The explained / unexplained depth cost of a batch of rendered clouds.

A frozen copy of the port's plain depth-only cost (`ops/cost_fused.py`
twin, `ops/cost.py` `normalize_costs`): per cloud point the nearest valid
observed target by the difference form, lowest index on ties; a real point
farther than sensor_resolution is unexplained; a close real or
explain-only point explains its target; the percentages follow.
"""

from __future__ import annotations

import dataclasses

import torch

_BLOCK = 1 << 22


@dataclasses.dataclass
class Costs:
    rendered: torch.Tensor   # [N] % unexplained rendered points (-1 none)
    observed: torch.Tensor   # [N] % unexplained observed points
    pairs: float             # (real or explain-only point, valid target)


def nearest(cloud, tgt4):
    """(min squared distance [N, P], lowest index attaining it)."""
    n, p, _ = cloud.shape
    s = tgt4.shape[1]
    dmin = torch.empty((n, p), dtype=torch.float32, device=cloud.device)
    win = torch.empty((n, p), dtype=torch.int64, device=cloud.device)
    sidx = torch.arange(s, device=cloud.device)
    nb = max(1, _BLOCK // (s * p))
    for i in range(0, n, nb):
        c = cloud[i:i + nb, :, None, :]
        t = tgt4[i:i + nb, None, :, :]
        dx = t[..., 0] - c[..., 0]
        dy = t[..., 1] - c[..., 1]
        dz = t[..., 2] - c[..., 2]
        d = dx * dx + dy * dy + dz * dz + t[..., 3]
        dm = d.amin(dim=2)
        dmin[i:i + nb] = dm
        win[i:i + nb] = torch.where(d <= dm[..., None], sidx, s).amin(dim=2)
    return dmin, win


def depth_cost(cloud_xyz, cloud_valid, explain_only, pose_occluded, tgt_xyz,
               tgt_valid, observed_total, sensor_resolution) -> Costs:
    cloud = cloud_xyz.to(torch.float32)
    cadd = torch.where(cloud_valid, 0.0, float("inf")).to(torch.float32)
    if explain_only is not None:
        cadd = torch.where(cloud_valid & explain_only, -1.0, cadd)
    tadd = torch.where(tgt_valid, 0.0, float("inf")).to(torch.float32)
    tgt4 = torch.cat([tgt_xyz.to(torch.float32), tadd[..., None]], dim=-1)
    max_dist_sq = sensor_resolution * sensor_resolution
    n, s = tgt4.shape[0], tgt4.shape[1]
    dmin, win = nearest(cloud, tgt4)
    real = cadd == 0.0
    close = (dmin <= max_dist_sq) & (cadd <= 0.0)
    point_num = real.sum(dim=1).to(torch.float32)
    unexplained = (real & (dmin > max_dist_sq)).sum(dim=1).to(torch.float32)
    hit = torch.zeros((n, s + 1), dtype=torch.float32, device=cloud.device)
    hit.scatter_reduce_(1, win, close.to(torch.float32), reduce="amax")
    explained = hit[:, :s].sum(dim=1)
    occluded = pose_occluded.to(torch.bool)
    point_num = torch.where(occluded, 0.0, point_num)
    unexplained = torch.where(occluded, 0.0, unexplained)
    explained = torch.where(occluded, 0.0, explained)
    rendered = torch.where(point_num == 0, -1.0,
                           unexplained / torch.clamp(point_num, min=1.0)
                           * 100.0)
    rendered = torch.where(occluded, -1.0, rendered)
    observed = ((observed_total - explained)
                / torch.clamp(observed_total, min=1e-9) * 100.0)
    observed = torch.where(observed_total <= 0, 100.0,
                           torch.clamp(observed, 0.0, 100.0))
    pairs = ((cadd <= 0.0).sum(dim=1).double()
             * tgt_valid.sum(dim=1).double()).sum().item()
    return Costs(rendered=rendered, observed=observed, pairs=pairs)
