"""Score a batch of candidate poses with a GICP refinement: render, cloud,
GICP, moved cloud with explain-only surface samples, depth cost.

The scoring path of a configuration at `icp_mode` "gicp" (PERCH 2.0's
`icp_type` 3: fast_gicp's `FastGICPCudaCore::optimize_multi`), written out
plainly. The render, clouds, moved cloud and cost are `scorer.py`'s; the
refinement is GICP from fast_gicp's equations:

  * covariances on both clouds from the normals of their k = 10 nearest
    neighbours (`icp.cloud_normals`), plane-regularised:
    C = I - (1 - eps) n n^T, that is diag(1, 1, eps) in the normal's frame;
  * every iteration, each moved source point's nearest target
    (`cost.nearest`: squared distance in difference form, the lowest index
    among equal minima), weighted 1 within max_correspondence, else 0;
  * the residual weight W = inv(C_t + R C_s R^T) by the adjugate;
  * a 6x6 Gauss-Newton step about the correspondences' centroid c, with
    J = [-[x - c]x | I], H = sum J^T W J, g = -sum J^T W r, Marquardt
    damping (H_ii += damping * H_ii + 1e-9), solved by an unrolled Cholesky,
    applied as x' = R (x - c) + c + t;
  * each pose stops on a small step (a tenth of the point-to-plane
    thresholds), a 3-iteration streak of unchanged fitness and residual, or
    fewer than 6 correspondences; the loop ends once every pose has stopped.

The per-pose sums (centroids, counts, the normal equations, residuals) are
batched reductions and products. A device sums those in an order that may
depend on the batch's size, so every block is padded to the configuration's
slot count with copies of its first pose, as the program pads its last
batch: a pose then rounds alike wherever it sits. TF32 is off.

Besides the scores it counts the work of the 1-NN association (sweeps x
valid sources x valid targets, its inputs read and outputs written once per
refinement) and the cost's valid pairs.
"""

from __future__ import annotations

import torch

from portbench.reference.cloud import cloud_batch, cloud_roi
from portbench.reference.cost import depth_cost, nearest
from portbench.reference.icp import (
    _cholesky_solve_6x6,
    _matmul3,
    _norm3,
    cloud_normals,
    crop_near,
    rotate_points,
)
from portbench.reference.numerics import sqrt
from portbench.reference.raster import render
from portbench.reference.scorer import Scores, Work, _compose, cost_work

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _hat(v):
    """Skew matrices [..., 3, 3] of [..., 3] vectors."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)


def _rodrigues(omega):
    """[N, 3] -> [N, 3, 3]; sin and cos in float64, rounded once."""
    theta = torch.clamp(_norm3(omega), min=1e-12)
    k = _hat(omega / theta)
    theta = theta[..., None]
    st = torch.sin(theta.double()).to(omega.dtype)
    ct = torch.cos(theta.double()).to(omega.dtype)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + st * k + (1 - ct) * _matmul3(k, k)


def _inverse_sym3(m):
    """Inverses of symmetric [..., 3, 3] matrices by the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1.0)
    adj = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co01, co11, co12], dim=-1),
        torch.stack([co02, co12, co22], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def gicp(src_xyz, src_valid, src_normals, tgt_xyz, tgt_valid, tgt_normals,
         *, max_iterations, max_correspondence, rotation_epsilon,
         transformation_epsilon, gicp_epsilon, crop_k, damping=1e-4,
         quant=None):
    """-> (delta [N, 4, 4] camera-frame correction, iterations [N] int32,
    the cropped targets' validity [N, k]). Targets are each pose's crop_k
    valid targets nearest its valid source centroid."""
    q = quant or (lambda t: t)
    n = src_xyz.shape[0]
    dev = src_xyz.device
    if crop_k and crop_k < tgt_xyz.shape[1]:
        centre = ((src_xyz * src_valid[..., None]).sum(dim=1)
                  / torch.clamp(src_valid.sum(dim=1), min=1)[:, None])
        cidx = crop_near(tgt_xyz, tgt_valid, centre, crop_k)
        i3 = cidx[..., None].expand(-1, -1, 3)
        tgt_xyz, tgt_valid, tgt_normals = (
            torch.gather(tgt_xyz, 1, i3), torch.gather(tgt_valid, 1, cidx),
            torch.gather(tgt_normals, 1, i3))
    tgt_xyz, tgt_normals = q(tgt_xyz), q(tgt_normals)
    # Targets (x, y, z, 0 or +inf): nearest() sums dx^2 + dy^2 + dz^2 + add
    # and keeps the lowest index among equal minima (0 when none is valid).
    s = tgt_xyz.shape[1]
    tgt4 = torch.cat([tgt_xyz, torch.where(tgt_valid, 0.0, float("inf"))
                      .to(torch.float32)[..., None]], dim=-1)
    max_corr_sq = max_correspondence * max_correspondence
    one_m_eps = 1.0 - gicp_epsilon
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    delta = torch.eye(4, dtype=torch.float32, device=dev).repeat(n, 1, 1)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    fitness = torch.zeros((n,), dtype=torch.float32, device=dev)
    rmse = torch.zeros((n,), dtype=torch.float32, device=dev)
    streak = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_valid = torch.clamp(src_valid.sum(dim=1).to(torch.float32), min=1.0)
    for k in range(max_iterations):
        rot = delta[:, :3, :3]
        cur = rotate_points(rot, src_xyz) + delta[:, None, :3, 3]
        dist_sq, idx = nearest(cur, tgt4)
        i3 = torch.clamp(idx, max=s - 1)[..., None].expand(-1, -1, 3)
        match = torch.gather(tgt_xyz, 1, i3)
        nt = torch.gather(tgt_normals, 1, i3)
        w = (src_valid & (dist_sq <= max_corr_sq)).to(torch.float32)
        # C_t + R C_s R^T, C = I - (1 - eps) n n^T.
        ns = rotate_points(rot, src_normals)
        cov = 2.0 * eye3 - one_m_eps * (nt[..., :, None] * nt[..., None, :]
                                        + ns[..., :, None] * ns[..., None, :])
        wmat = _inverse_sym3(cov) * w[..., None, None]
        r = cur - match
        count = w.sum(dim=1)
        centre = ((cur * w[..., None]).sum(dim=1)
                  / torch.clamp(count, min=1.0)[:, None])
        jac = torch.cat([-_hat(cur - centre[:, None, :]),
                         eye3.expand(n, cur.shape[1], 3, 3)], dim=-1)
        wj = torch.einsum("npab,npbj->npaj", wmat, jac)
        h = torch.einsum("npai,npaj->nij", jac, wj)
        g = -torch.einsum("npaj,npa->nj", wj, r)
        ok = count >= 6
        diag = torch.diagonal(h, dim1=1, dim2=2)
        h = h + eye6 * (damping * diag + 1e-9)[:, None, :]
        h = torch.where(ok[:, None, None], h, eye6)
        lower = [[h[:, i, j] for i in range(6)] for j in range(6)]
        xi = torch.stack(_cholesky_solve_6x6(lower, [g[:, i]
                                                     for i in range(6)]),
                         dim=1)
        xi = torch.where((ok & ~done)[:, None], xi, 0.0)
        step = torch.zeros((n, 4, 4), dtype=torch.float32, device=dev)
        step[:, :3, :3] = _rodrigues(xi[:, :3])
        step[:, :3, 3] = xi[:, 3:]
        step[:, 3, 3] = 1.0
        step[:, :3, 3] += centre - torch.einsum("nij,nj->ni",
                                                step[:, :3, :3], centre)
        delta = torch.bmm(step, delta)
        res = torch.einsum("npa,npab,npb->np", r, wmat, r).sum(dim=1)
        prev_fit, prev_rmse = fitness, rmse
        fitness = count / n_valid
        rmse = sqrt(torch.clamp(res / torch.clamp(count, min=1.0), min=0.0))
        small = ((_norm3(xi[:, :3])[:, 0] < rotation_epsilon)
                 & (_norm3(xi[:, 3:])[:, 0] < transformation_epsilon))
        still = (((fitness - prev_fit).abs() < 1e-5)
                 & ((rmse - prev_rmse).abs() < 1e-6) & (k > 0))
        streak = torch.where(still, streak + 1, 0)
        iters = iters + (~done).to(torch.int32)
        done = done | small | (streak >= 3) | ~ok
        if bool(done.all()):
            break
    return q(delta), iters, tgt_valid


def _pad(t, slots: int):
    """t [n, ...] with copies of its first row up to `slots` rows."""
    n = t.shape[0]
    if n >= slots:
        return t
    return torch.cat([t, t[:1].expand(slots - n, *t.shape[1:])])


def icp_work(src_valid, tgt_valid, iters) -> Work:
    """The refinement's counts: one association sweep per iteration over
    valid sources x valid targets, iterations x valid sources, and the 1-NN's
    bytes (sources, the targets with their validity, the distance and index
    out), read and written once."""
    nv = src_valid.sum(dim=1).double()
    nt = tgt_valid.sum(dim=1).double()
    it = iters.double()
    n, p = src_valid.shape
    return Work(icp_pair_sweeps=(it * nv * nt).sum().item(),
                icp_point_iters=(it * nv).sum().item(),
                icp_bytes=float(n * (p * 3 + tgt_valid.shape[1] * 4
                                     + p * 2) * 4))


def score_batch(bank: dict, poses, model_ids, pose_labels, observed_total,
                proj, scene, cfg: dict, do_icp: bool,
                quant=None) -> Scores:
    """`scorer.score_batch`'s arguments; cfg also holds `slots` (the block
    is padded to it), `icp_gicp_epsilon` and the step thresholds."""
    q = quant or (lambda t: t)
    n = poses.shape[0]
    slots = max(n, int(cfg.get("slots") or n))
    poses, model_ids, pose_labels, observed_total = (
        _pad(t, slots) for t in (poses, model_ids, pose_labels,
                                 observed_total))
    labels = torch.clamp(pose_labels.long(), 0, scene.seg_xyz.shape[0] - 1)
    ids = model_ids.long()
    s_full = scene.seg_xyz.shape[1]
    sc = min(cfg["cost_crop_targets"] or s_full, s_full)
    cost_xyz = scene.seg_xyz[:, :sc][labels]
    cost_valid = scene.seg_valid[:, :sc][labels]
    if sc < s_full:
        observed_total = torch.minimum(
            observed_total, cost_valid.sum(dim=1).to(observed_total.dtype))
    cam = {k: cfg[k] for k in ("fx", "fy", "cx", "cy", "width", "height")}
    out = render(bank["tri_verts"], bank["tri_valid"], poses, ids, proj,
                 stride=cfg["stride"],
                 source_depth=scene.source_depth,
                 source_label=scene.source_label, pose_labels=labels,
                 occlusion_threshold=cfg["occlusion_threshold"],
                 use_segmentation_label=cfg["use_segmentation_label"],
                 use_tree_occlusion=cfg["use_tree_occlusion"],
                 roi_shape=cfg["roi_shape"], cullable=bank["cullable"],
                 quant=quant, width=cfg["width"], height=cfg["height"])
    if cfg["roi_shape"] is not None:
        cloud = cloud_roi(out.depth, out.anchors,
                          stride=cfg["stride"], **cam)
    else:
        cloud = cloud_batch(out.depth, stride=cfg["stride"],
                            max_points=cfg["max_points_per_pose"], **cam)
    work = Work()
    adjusted = poses
    explain_only = None
    xyz, valid = q(cloud.xyz), cloud.valid
    if do_icp:
        ds = cfg["icp_downsample"]
        src_xyz, src_valid = xyz[:, ::ds], valid[:, ::ds]
        delta, iters, tgt_valid = gicp(
            src_xyz, src_valid, cloud_normals(src_xyz, src_valid, k=10),
            scene.seg_xyz[labels], scene.seg_valid[labels],
            scene.seg_normals[labels],
            max_iterations=cfg["icp_max_iterations"],
            max_correspondence=cfg["icp_max_correspondence"],
            rotation_epsilon=cfg["icp_rotation_epsilon"],
            transformation_epsilon=cfg["icp_transformation_epsilon"],
            gicp_epsilon=cfg["icp_gicp_epsilon"],
            crop_k=cfg["icp_crop_targets"], quant=quant)
        work.add(icp_work(src_valid[:n], tgt_valid[:n], iters[:n]))
        adjusted = _compose(delta, poses)
        moved = rotate_points(delta[:, :3, :3], xyz) + delta[:, None, :3, 3]
        xyz = torch.where(valid[..., None], moved, xyz)
        samp = bank["icp_samples"][ids]
        snrm = bank["icp_normals"][ids]
        rot = adjusted[:, :3, :3]
        aug_xyz = rotate_points(rot, samp) + adjusted[:, None, :3, 3]
        n_cam = rotate_points(rot, snrm)
        aug_valid = (n_cam[..., 0] * aug_xyz[..., 0]
                     + n_cam[..., 1] * aug_xyz[..., 1]
                     + n_cam[..., 2] * aug_xyz[..., 2]) < 0.0
        n_b, p_b = valid.shape
        explain_only = torch.cat(
            [torch.zeros((n_b, p_b), dtype=torch.bool, device=xyz.device),
             torch.ones((n_b, aug_xyz.shape[1]), dtype=torch.bool,
                        device=xyz.device)], dim=1)
        xyz = torch.cat([xyz, q(aug_xyz)], dim=1)
        valid = torch.cat([valid, aug_valid], dim=1)
    costs = depth_cost(xyz[:n], valid[:n], explain_only[:n]
                       if explain_only is not None else None,
                       out.pose_occluded[:n], q(cost_xyz[:n]),
                       cost_valid[:n], observed_total[:n],
                       cfg["sensor_resolution"])
    work.add(cost_work(xyz[:n], valid[:n], cost_xyz[:n], cost_valid[:n],
                       costs.pairs))
    invalid = costs.rendered.to(torch.int32) < 0
    total = torch.where(invalid, -1,
                        (costs.rendered + costs.observed).to(torch.int32))
    return Scores(total=total, rendered=costs.rendered,
                  observed=costs.observed, adjusted=adjusted[:n], work=work)
