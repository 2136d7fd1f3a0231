"""Fused 1-NN + cost counts with the CIEDE2000 colour gate (types 1 / 3).

Counterparts of `nn_cost_fused_color_pallas` and
`nn_cost_fused_color_tri_pallas` in `perception_tpu/ops/pallas_cost.py`.
The kernels (`csrc/cost_fused_color.cu`) and their PyTorch twins compute, per
pose, what `ops/cost_fused.py` computes plus the gate: a close point
explains its winning target only if CIEDE2000(target Lab, rendered Lab) <=
threshold (explain-only samples pass without a colour); a close point that
fails the gate counts as unexplained.

  * `nn_cost_fused_color`: the rendered Lab comes with the cloud
    ([N, P, 3]; full-frame clouds, rendered with Lab face colours).
  * `nn_cost_fused_color_tri`: the rendered Lab is the face colour of the
    point's winning triangle, bank_lab[model_ids[n], tri_id[n, p]] (ROI
    clouds, whose points are the window's pixels in order).
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops.color import ciede2000_components
from perception_tpu_torch.ops.cost_fused import _cadd_flags, nearest

_MAX_SHARED = 227 * 1024


def _shared_bytes(s: int, t: int = 0) -> int:
    """The least dynamic shared memory the kernel takes: per target its
    compacted copy (16 B), its Lab (12 B) and an explained bit; the model Lab
    row (12 B per face) in the face-id form; and the points, staged in chunks
    of at least one round of 256 (16 B each), so any P fits."""
    return s * 28 + -(-s // 32) * 4 + t * 12 + 256 * 16


def nn_cost_fused_color(
    cloud_xyz: torch.Tensor,    # [N, P, 3]
    cloud_valid: torch.Tensor,  # [N, P] bool
    cloud_lab: torch.Tensor,    # [N, P, 3] CIELAB
    tgt_xyz: torch.Tensor,      # [N, S, 3]
    tgt_valid: torch.Tensor,    # [N, S] bool
    tgt_lab: torch.Tensor,      # [N, S, 3] CIELAB
    sensor_resolution: float,
    color_distance_threshold: float,
    cloud_explain_only: torch.Tensor | None = None,   # [N, P] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(point_num [N], unexplained [N], observed_explained [N]) float32.
    CUDA tensors launch the kernel; CPU tensors run the twin."""
    args, kw = prepare_inputs(cloud_xyz, cloud_valid, cloud_lab, tgt_xyz,
                              tgt_valid, tgt_lab, sensor_resolution,
                              color_distance_threshold, cloud_explain_only)
    if cloud_xyz.device.type == "cpu":
        build.TWIN_CALLS["cost_fused_color"] += 1
        return nn_cost_fused_color_twin(*args, **kw)
    return launch_kernel(*args, **kw)


def nn_cost_fused_color_tri(
    cloud_xyz: torch.Tensor,     # [N, P, 3]
    cloud_valid: torch.Tensor,   # [N, P] bool
    cloud_tri_id: torch.Tensor,  # [N, P] int winning face (-1 = none)
    model_ids: torch.Tensor,     # [N] int
    bank_lab: torch.Tensor,      # [M, T, 3] CIELAB face colours
    tgt_xyz: torch.Tensor,       # [N, S, 3]
    tgt_valid: torch.Tensor,     # [N, S] bool
    tgt_lab: torch.Tensor,       # [N, S, 3] CIELAB
    sensor_resolution: float,
    color_distance_threshold: float,
    cloud_explain_only: torch.Tensor | None = None,   # [N, P] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(point_num [N], unexplained [N], observed_explained [N]) float32, the
    rendered Lab looked up from the face ids. CUDA tensors launch the
    kernel; CPU tensors run the twin."""
    args, kw = prepare_inputs_tri(
        cloud_xyz, cloud_valid, cloud_tri_id, model_ids, bank_lab, tgt_xyz,
        tgt_valid, tgt_lab, sensor_resolution, color_distance_threshold,
        cloud_explain_only)
    if cloud_xyz.device.type == "cpu":
        build.TWIN_CALLS["cost_fused_color_tri"] += 1
        return nn_cost_fused_color_tri_twin(*args, **kw)
    return launch_kernel_tri(*args, **kw)


def _targets(tgt_xyz, tgt_valid, tgt_lab):
    tadd = torch.where(tgt_valid, 0.0, float("inf")).to(torch.float32)
    tgt4 = torch.cat([tgt_xyz.to(torch.float32), tadd[..., None]],
                     dim=-1).contiguous()
    return tgt4, tgt_lab.to(torch.float32).contiguous()


def prepare_inputs(cloud_xyz, cloud_valid, cloud_lab, tgt_xyz, tgt_valid,
                   tgt_lab, sensor_resolution, color_distance_threshold,
                   cloud_explain_only=None) -> tuple[tuple, dict]:
    """The Lab-form kernel's (and twin's) arguments: contiguous f32 cloud,
    its 3-state flags and Lab, targets with their +inf additive [N, S, 4]
    and Lab, res^2 and the threshold."""
    tgt4, tlab = _targets(tgt_xyz, tgt_valid, tgt_lab)
    return (cloud_xyz.to(torch.float32).contiguous(),
            _cadd_flags(cloud_valid, cloud_explain_only).contiguous(),
            cloud_lab.to(torch.float32).contiguous(), tgt4, tlab), dict(
        max_dist_sq=sensor_resolution * sensor_resolution,
        thresh=color_distance_threshold)


def prepare_inputs_tri(cloud_xyz, cloud_valid, cloud_tri_id, model_ids,
                       bank_lab, tgt_xyz, tgt_valid, tgt_lab,
                       sensor_resolution, color_distance_threshold,
                       cloud_explain_only=None) -> tuple[tuple, dict]:
    """The face-id kernel's (and twin's) arguments: as prepare_inputs, with
    int32 face ids (-1 for invalid and explain-only points), int32 model
    ids and the f32 [M, T, 3] face Lab table in place of the cloud's Lab."""
    live = cloud_valid
    if cloud_explain_only is not None:
        live = live & ~cloud_explain_only
    tri = torch.where(live, cloud_tri_id.to(torch.int32), -1).contiguous()
    tgt4, tlab = _targets(tgt_xyz, tgt_valid, tgt_lab)
    return (cloud_xyz.to(torch.float32).contiguous(),
            _cadd_flags(cloud_valid, cloud_explain_only).contiguous(),
            tri, model_ids.to(torch.int32).contiguous(),
            bank_lab.to(torch.float32).contiguous(), tgt4, tlab), dict(
        max_dist_sq=sensor_resolution * sensor_resolution,
        thresh=color_distance_threshold)


def _check_common(cloud, cadd, tgt4, tlab, dev, smem) -> tuple[int, int, int]:
    if dev.type != "cuda":
        raise ValueError(f"colour cost kernel: tensors on {dev}")
    n, p, _ = cloud.shape
    s = tgt4.shape[1]
    build.check(cloud, "cloud_xyz", torch.float32, (n, p, 3), dev)
    build.check(cadd, "cadd", torch.float32, (n, p), dev)
    build.check(tgt4, "tgt4", torch.float32, (n, s, 4), dev)
    build.check(tlab, "tgt_lab", torch.float32, (n, s, 3), dev)
    if smem > _MAX_SHARED:
        raise ValueError(f"colour cost kernel: {smem} bytes of shared "
                         f"memory exceed {_MAX_SHARED}")
    return n, p, s


def launch_kernel(cloud, cadd, cloud_lab, tgt4, tlab, *, max_dist_sq: float,
                  thresh: float):
    """csrc/cost_fused_color.cu, Lab form, on CUDA tensors."""
    dev = cloud.device
    n, p, s = _check_common(cloud, cadd, tgt4, tlab, dev, _shared_bytes(
        tgt4.shape[1]))
    build.check(cloud_lab, "cloud_lab", torch.float32, (n, p, 3), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    build.launch("pt_cost_fused_color", build.ptr(cloud), build.ptr(cadd),
                 build.ptr(cloud_lab), build.ptr(tgt4), build.ptr(tlab), n, p,
                 s, max_dist_sq, thresh, build.ptr(out))
    return out[:, 0], out[:, 1], out[:, 2]


def launch_kernel_tri(cloud, cadd, tri, mids, bank_lab, tgt4, tlab, *,
                      max_dist_sq: float, thresh: float):
    """csrc/cost_fused_color.cu, face-id form, on CUDA tensors. model_ids
    must lie in [0, M)."""
    dev = cloud.device
    m, t, _ = bank_lab.shape
    n, p, s = _check_common(cloud, cadd, tgt4, tlab, dev, _shared_bytes(
        tgt4.shape[1], t))
    build.check(tri, "cloud_tri_id", torch.int32, (n, p), dev)
    build.check(mids, "model_ids", torch.int32, (n,), dev)
    build.check(bank_lab, "bank_lab", torch.float32, (m, t, 3), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    build.launch("pt_cost_fused_color_tri", build.ptr(cloud), build.ptr(cadd),
                 build.ptr(tri), build.ptr(mids), build.ptr(bank_lab),
                 build.ptr(tgt4), build.ptr(tlab), n, p, s, t, max_dist_sq,
                 thresh, build.ptr(out))
    return out[:, 0], out[:, 1], out[:, 2]


def _gated_counts(cadd, dmin, win, cloud_lab, tlab, s, max_dist_sq, thresh):
    n = cadd.shape[0]
    real = cadd == 0.0
    close = (dmin <= max_dist_sq) & (cadd <= 0.0)
    w = win.clamp(max=s - 1)
    wlab = torch.gather(tlab, 1, w[..., None].expand(-1, -1, 3))
    de = ciede2000_components(
        wlab[..., 0], wlab[..., 1], wlab[..., 2],
        cloud_lab[..., 0], cloud_lab[..., 1], cloud_lab[..., 2])
    ok = (de <= thresh) | (cadd == -1.0)
    point_num = real.sum(dim=1).to(torch.float32)
    unexplained = ((real & (dmin > max_dist_sq)).sum(dim=1)
                   + (close & ~ok).sum(dim=1)).to(torch.float32)
    explained = torch.zeros((n, s + 1), dtype=torch.float32,
                            device=cadd.device)
    explained.scatter_reduce_(1, win, (close & ok).to(torch.float32),
                              reduce="amax")
    return point_num, unexplained, explained[:, :s].sum(dim=1)


def nn_cost_fused_color_twin(cloud, cadd, cloud_lab, tgt4, tlab, *,
                             max_dist_sq: float, thresh: float):
    """Plain PyTorch version of the Lab-form kernel."""
    dmin, win = nearest(cloud, tgt4)
    return _gated_counts(cadd, dmin, win, cloud_lab, tlab, tgt4.shape[1],
                         max_dist_sq, thresh)


def nn_cost_fused_color_tri_twin(cloud, cadd, tri, mids, bank_lab, tgt4,
                                 tlab, *, max_dist_sq: float, thresh: float):
    """Plain PyTorch version of the face-id kernel: the Lab of each point's
    face (0 for ids outside [0, T)), then the Lab-form twin."""
    t = bank_lab.shape[1]
    inside = (tri >= 0) & (tri < t)
    lab = bank_lab[mids.long()[:, None], tri.long().clamp(0, t - 1)]
    cloud_lab = torch.where(inside[..., None], lab, 0.0)
    return nn_cost_fused_color_twin(cloud, cadd, cloud_lab, tgt4, tlab,
                                    max_dist_sq=max_dist_sq, thresh=thresh)
