"""ICP support and the composed refiners.

Counterpart of `perception_tpu/ops/icp.py`: `smallest_eigenvector_3x3`,
`cloud_normals` (k-NN covariance normals, oriented towards the camera),
`crop_targets` in modes "near" and "spread", the SE(3) helpers, the two
composed batched refiners, `icp_point_to_plane_batch` ("nn") and
`icp_gicp_batch` ("gicp"), and `icp_projective_batch` ("projective").
The first two associate with `knn.nn1_batch` (the 1-NN kernel on the card)
once per Gauss-Newton iteration; the projective refiner associates by
projecting each source point into the organised observed map. All three sum
the 6x6 normal equations with PyTorch reductions and stop once every pose
has converged: one host read of the converged flags per iteration. Their
`ICPResult.loops` counts those iterations. On the card the GICP iteration
is captured as a CUDA graph once a call and replayed, bit for bit the
eager iteration's kernels.

The normals' covariance, mean and power iteration are written as
fixed-order element-wise sums (no reductions, matmuls or norms whose order
depends on the device), so the CPU and the card round them alike.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from perception_tpu_torch.ops.icp_fused import cholesky_solve_6x6
from perception_tpu_torch.ops.knn import knn_self, nn1_batch
from perception_tpu_torch.ops.numerics import div, sqrt


def _ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` by adding its slices in index order."""
    total = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        total = total + x.select(dim, i)
    return total


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (3), keepdim, summed in order."""
    return sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                + v[..., 2:3] * v[..., 2:3])


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for [..., 3, 3] matrices, summed in a fixed order."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v for [..., 3, 3] and [..., 3], summed in a fixed order."""
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3])


def smallest_eigenvector_3x3(cov: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Smallest eigenvector of symmetric [..., 3, 3] matrices by shifted power
    iteration on (trace * I - C)^2 from a fixed start."""
    sigma = (cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2])[..., None, None]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    m = sigma * eye - cov
    m = _matmul3(m, m)
    start = (torch.full((3,), 0.57735, dtype=cov.dtype, device=cov.device)
             + torch.tensor([0.1, -0.05, 0.02], dtype=cov.dtype,
                            device=cov.device))
    v = start.expand(cov.shape[:-1])
    for _ in range(iters):
        v = _matvec3(m, v)
        v = v / torch.clamp(_norm3(v), min=1e-20)
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
    cnt = torch.clamp(_ordered_sum(wgt, 2), min=1.0)      # [B, P, 1]
    mean = _ordered_sum(neighbors * wgt, 2) / cnt         # [B, P, 3]
    centered = (neighbors - mean[:, :, None]) * wgt       # [B, P, k, 3]
    outer = centered[..., :, None] * centered[..., None, :]
    cov = _ordered_sum(outer, 2) / cnt[..., None]         # [B, P, 3, 3]
    n = smallest_eigenvector_3x3(cov)
    dot = n[..., 0:1] * xyz[..., 0:1] + n[..., 1:2] * xyz[..., 1:2] \
        + n[..., 2:3] * xyz[..., 2:3]
    flip = torch.sign(-dot)
    return n * torch.where(flip == 0, 1.0, flip)


def crop_targets(tgt_xyz: torch.Tensor, tgt_valid: torch.Tensor,
                 centers: torch.Tensor, k: int,
                 mode: str = "near") -> torch.Tensor:
    """Indices [N, k] of a target crop around each centre, invalid targets
    last. "near": the k nearest, nearest first. "spread": over the 2k
    nearest, the even positions of their valid prefix first (half density
    over the 2k extent), then the odd ones, then the invalid tail. The
    selection is exact (a stable sort, so equal distances keep the lower
    index, as lax.top_k does on the CPU)."""
    diff = tgt_xyz - centers[:, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])
    d = torch.where(tgt_valid, d, float("inf"))
    s = tgt_xyz.shape[1]
    idx = torch.sort(d, dim=1, stable=True).indices
    if mode == "near" or k >= s:
        return idx[:, :min(k, s)]
    if mode != "spread":
        raise ValueError(f"unknown crop mode {mode!r}")
    k2 = min(2 * k, s)
    idx = idx[:, :k2]
    v = torch.gather(tgt_valid, 1, idx).sum(dim=1, keepdim=True)
    i = torch.arange(k, device=idx.device)[None, :]
    nhalf = torch.div(v + 1, 2, rounding_mode="floor")
    pos = torch.where(i < nhalf, 2 * i, 2 * (i - nhalf) + 1)
    pos = torch.where(i < v, pos, i)
    pos = torch.clamp(pos, max=k2 - 1)
    return torch.gather(idx, 1, pos)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew matrices [..., 3, 3] of [..., 3] vectors."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Batched SO(3) exponential [..., 3] -> [..., 3, 3] (Rodrigues); sin and
    cos in float64, rounded once."""
    theta = torch.clamp(_norm3(omega), min=1e-12)
    k = _hat(omega / theta)
    theta = theta[..., None]
    st = torch.sin(theta.double()).to(omega.dtype)
    ct = torch.cos(theta.double()).to(omega.dtype)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + st * k + (1 - ct) * _matmul3(k, k)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Batched SE(3)-style update [..., 6] (omega, t) -> [..., 4, 4]:
    rotation exact, translation first order."""
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    out[..., :3, :3] = so3_exp(xi[..., :3])
    out[..., :3, 3] = xi[..., 3:]
    out[..., 3, 3] = 1.0
    return out


def solve_spd_6x6(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD solve by an unrolled Cholesky: h [N, 6, 6] (lower
    triangle read), g [N, 6] -> x [N, 6] with h x = g."""
    upper = [[h[:, i, j] for i in range(6)] for j in range(6)]
    return torch.stack(cholesky_solve_6x6(upper, [g[:, i] for i in range(6)]),
                       dim=1)


def _gn_step(cur, q, nrm, w, converged, damping=1e-4, pp_weight=0.0):
    """One damped Gauss-Newton update, as the JAX _gn_step: point-to-plane
    residuals plus, with pp_weight > 0, that weight of the point-to-point
    term; diag-mean scaled damping, identity system when fewer than 6
    correspondences. The normal equations are summed in float64 and rounded
    once, so the CPU and the card hold the same system. Returns
    (xi [N, 6], count [N], e [N, P], ok [N])."""
    d = cur - q
    e = nrm[..., 0] * d[..., 0] + nrm[..., 1] * d[..., 1] \
        + nrm[..., 2] * d[..., 2]
    j_rot = torch.linalg.cross(cur, nrm, dim=-1)
    jac = torch.cat([j_rot, nrm], dim=-1).double()         # [N, P, 6]
    w64 = w.double()
    jw = jac * w64[..., None]
    h = torch.bmm(jw.transpose(1, 2), jac)
    g = -(jw * e.double()[..., None]).sum(dim=1)
    if pp_weight > 0:
        # Point-to-point: r = cur - q, dr/domega = -[cur]x, dr/du = I.
        cx = _hat(cur.double())                            # [N, P, 3, 3]
        eye3 = torch.eye(3, dtype=torch.float64, device=cur.device)
        j_pp = torch.cat([-cx, eye3.expand(cx.shape)], dim=-1)  # [N, P, 3, 6]
        h = h + pp_weight * torch.einsum("npki,npkj,np->nij", j_pp, j_pp, w64)
        g = g - pp_weight * torch.einsum("npki,npk,np->ni", j_pp, d.double(),
                                         w64)
    h, g = h.float(), g.float()
    count = w.sum(dim=1)
    ok = count >= 6
    diag_mean = torch.diagonal(h, dim1=1, dim2=2).double().mean(dim=1).float()
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    h = h + (damping * diag_mean[:, None, None] + 1e-9) * eye
    h = torch.where(ok[:, None, None], h, eye)
    xi = solve_spd_6x6(h, g)
    xi = torch.where((ok & ~converged)[:, None], xi, 0.0)
    return xi, count, e, ok


class ICPResult(NamedTuple):
    delta: torch.Tensor       # [N, 4, 4] camera-frame correction
    fitness: torch.Tensor     # [N] inlier fraction at convergence
    rmse: torch.Tensor        # [N] inlier RMSE (m)
    iterations: torch.Tensor  # [N] int32 iterations until convergence
    # The composed refiners' loop iterations, known on the host: each one
    # association and one host read of the converged flags.
    loops: int = 0


def _crop(src_xyz, src_valid, tgt_xyz, tgt_valid, tgt_normals, crop_k):
    """Each pose's crop_k targets nearest its valid source centroid."""
    if not crop_k or crop_k >= tgt_xyz.shape[1]:
        return tgt_xyz, tgt_valid, tgt_normals
    centers = ((src_xyz * src_valid[..., None]).sum(dim=1)
               / torch.clamp(src_valid.sum(dim=1), min=1)[:, None])
    idx = crop_targets(tgt_xyz, tgt_valid, centers, crop_k)
    i3 = idx[..., None].expand(-1, -1, 3)
    return (torch.gather(tgt_xyz, 1, i3), torch.gather(tgt_valid, 1, idx),
            torch.gather(tgt_normals, 1, i3))


def rotate_points(rot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """rot [N, 3, 3] applied to pts [N, K, 3]. Element-wise products summed
    in a fixed order (not a matmul), so the CPU and the card round alike."""
    r = rot[:, None]
    return (pts[..., 0:1] * r[..., 0] + pts[..., 1:2] * r[..., 1]
            + pts[..., 2:3] * r[..., 2])


def _transform(delta: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """delta [N, 4, 4] applied to pts [N, P, 3]."""
    return rotate_points(delta[:, :3, :3], pts) + delta[:, None, :3, 3]


def _converge(k, xi, fitness, rmse, prev_fit, prev_rmse, streak, ok,
              converged, iters, rot_eps, trn_eps):
    """The composed refiners' exits: a small step, or a 3-iteration streak of
    fitness / RMSE stagnation (1e-5 / 1e-6), or too few correspondences."""
    rot_small = _norm3(xi[:, :3])[:, 0] < rot_eps
    trans_small = _norm3(xi[:, 3:])[:, 0] < trn_eps
    stagnant = (((fitness - prev_fit).abs() < 1e-5)
                & ((rmse - prev_rmse).abs() < 1e-6) & (k > 0))
    streak = torch.where(stagnant, streak + 1, 0)
    newly = (rot_small & trans_small) | (streak >= 3)
    iters = iters + (~converged).to(torch.int32)
    return converged | newly | ~ok, iters, streak


def icp_point_to_plane_batch(
    src_xyz: torch.Tensor,      # [N, P, 3] rendered cloud per pose (camera)
    src_valid: torch.Tensor,    # [N, P]
    tgt_xyz: torch.Tensor,      # [N, S, 3] observed segment per pose
    tgt_valid: torch.Tensor,    # [N, S]
    tgt_normals: torch.Tensor,  # [N, S, 3]
    *,
    max_iterations: int = 30,
    max_correspondence: float = 0.05,
    rotation_epsilon: float = 2e-3,
    transformation_epsilon: float = 5e-4,
    damping: float = 1e-4,
    crop_k: int = 0,
) -> ICPResult:
    """Point-to-plane Gauss-Newton of all poses at once, re-associating by
    1-NN every iteration; crop_k > 0 first cuts each pose's targets to the
    crop_k nearest its source centroid."""
    n = src_xyz.shape[0]
    dev = src_xyz.device
    max_corr_sq = max_correspondence * max_correspondence
    tgt_xyz, tgt_valid, tgt_normals = _crop(src_xyz, src_valid, tgt_xyz,
                                            tgt_valid, tgt_normals, crop_k)
    delta = torch.eye(4, dtype=torch.float32, device=dev).repeat(n, 1, 1)
    converged = torch.zeros((n,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    fitness = torch.zeros((n,), dtype=torch.float32, device=dev)
    rmse = torch.zeros((n,), dtype=torch.float32, device=dev)
    streak = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_valid = torch.clamp(src_valid.sum(dim=1).to(torch.float32), min=1.0)
    loops = 0
    for k in range(max_iterations):
        cur = _transform(delta, src_xyz)
        dist_sq, idx = nn1_batch(cur, src_valid, tgt_xyz, tgt_valid)
        i3 = idx.long()[..., None].expand(-1, -1, 3)
        q = torch.gather(tgt_xyz, 1, i3)
        nrm = torch.gather(tgt_normals, 1, i3)
        w = (src_valid & (dist_sq <= max_corr_sq)).to(torch.float32)
        xi, count, e, ok = _gn_step(cur, q, nrm, w, converged, damping)
        delta = torch.bmm(se3_exp(xi), delta)
        prev_fit, prev_rmse = fitness, rmse
        fitness = count / n_valid
        rmse = sqrt((e * e * w).double().sum(dim=1).float()
                    / torch.clamp(count, min=1.0))
        converged, iters, streak = _converge(
            k, xi, fitness, rmse, prev_fit, prev_rmse, streak, ok, converged,
            iters, rotation_epsilon, transformation_epsilon)
        loops += 1
        if bool(converged.all()):
            break
    return ICPResult(delta=delta, fitness=fitness, rmse=rmse, iterations=iters,
                     loops=loops)


def icp_projective_batch(
    src_xyz: torch.Tensor,      # [N, P, 3] rendered cloud per pose (camera)
    src_valid: torch.Tensor,    # [N, P]
    obs_xyz: torch.Tensor,      # [Npix, 3] organised observed map
    obs_normals: torch.Tensor,  # [Npix, 3]
    obs_valid: torch.Tensor,    # [Npix]
    obs_label: torch.Tensor,    # [Npix] int 0-based (-1 invalid)
    pose_labels: torch.Tensor,  # [N] int
    *,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int, stride: int,
    max_iterations: int = 30,
    max_correspondence: float = 0.05,
    rotation_epsilon: float = 2e-3,
    transformation_epsilon: float = 5e-4,
    damping: float = 1e-4,
    use_labels: bool = True,
) -> ICPResult:
    """Point-to-plane Gauss-Newton (with a 0.1-weighted point-to-point term)
    under projective association: each transformed source point reads the
    observed point and normal at the strided pixel it projects to
    (round(u / stride), half to even as jnp.round), gated by validity,
    depth, its pose's segment label (use_labels) and max_correspondence.
    max_iterations steps as the JAX scan takes them; a converged pose stops
    moving, so the loop ends once every pose has converged."""
    n = src_xyz.shape[0]
    dev = src_xyz.device
    w_s, h_s = width // stride, height // stride
    max_corr_sq = max_correspondence * max_correspondence
    labels = pose_labels.long()[:, None]
    delta = torch.eye(4, dtype=torch.float32, device=dev).repeat(n, 1, 1)
    converged = torch.zeros((n,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    fitness = torch.zeros((n,), dtype=torch.float32, device=dev)
    rmse = torch.zeros((n,), dtype=torch.float32, device=dev)
    n_valid = torch.clamp(src_valid.sum(dim=1).to(torch.float32), min=1.0)
    loops = 0
    for _ in range(max_iterations):
        cur = _transform(delta, src_xyz)
        z = torch.clamp(cur[..., 2], min=1e-6)
        u = fx * cur[..., 0] / z + cx
        v = fy * cur[..., 1] / z + cy
        iu = torch.clamp(torch.round(div(u, stride)).to(torch.int32), 0,
                         w_s - 1)
        iv = torch.clamp(torch.round(div(v, stride)).to(torch.int32), 0,
                         h_s - 1)
        pix = (iv * w_s + iu).long()                         # [N, P]
        q = obs_xyz[pix]
        nrm = obs_normals[pix]
        ok = src_valid & obs_valid[pix] & (cur[..., 2] > 1e-4)
        if use_labels:
            ok = ok & (obs_label[pix].long() == labels)
        d = cur - q
        dist_sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        w = (ok & (dist_sq <= max_corr_sq)).to(torch.float32)
        xi, count, e, okp = _gn_step(cur, q, nrm, w, converged, damping,
                                     pp_weight=0.1)
        delta = torch.bmm(se3_exp(xi), delta)
        newly = ((_norm3(xi[:, :3])[:, 0] < rotation_epsilon)
                 & (_norm3(xi[:, 3:])[:, 0] < transformation_epsilon))
        iters = iters + (~converged).to(torch.int32)
        converged = converged | newly | ~okp
        rmse = sqrt((e * e * w).double().sum(dim=1).float()
                    / torch.clamp(count, min=1.0))
        fitness = count / n_valid
        loops += 1
        if bool(converged.all()):
            break
    return ICPResult(delta=delta, fitness=fitness, rmse=rmse, iterations=iters,
                     loops=loops)


def _inv_3x3_sym(m: torch.Tensor) -> torch.Tensor:
    """Batched symmetric 3x3 inverse by the adjugate."""
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
    rows = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co01, co11, co12], dim=-1),
        torch.stack([co02, co12, co22], dim=-1),
    ], dim=-2)
    return rows * inv_det[..., None, None]


def _gicp_state(n: int, dev) -> list[torch.Tensor]:
    """The GICP loop's state at its start: delta [N, 4, 4], converged,
    iterations, fitness, rmse and the stagnation streak [N]."""
    return [torch.eye(4, dtype=torch.float32, device=dev).repeat(n, 1, 1),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev)]


def _gicp_step(k, state, clouds, fixed, max_corr_sq, one_m_eps, damping,
               rot_eps, trn_eps) -> list[torch.Tensor]:
    """One GICP iteration: the next state from `state`. `k` is the
    iteration, an int or (in a CUDA graph) a 0-d tensor; `fixed` holds
    eye3, eye6 and each pose's valid source count."""
    delta, converged, iters, fitness, rmse, streak = state
    src_xyz, src_valid, src_normals, tgt_xyz, tgt_valid, tgt_normals = clouds
    eye3, eye6, n_valid = fixed
    cur = _transform(delta, src_xyz)
    dist_sq, idx = nn1_batch(cur, src_valid, tgt_xyz, tgt_valid)
    i3 = idx.long()[..., None].expand(-1, -1, 3)
    q = torch.gather(tgt_xyz, 1, i3)
    nt = torch.gather(tgt_normals, 1, i3)
    w = (src_valid & (dist_sq <= max_corr_sq)).to(torch.float32)
    # C = C_t + R C_s R^T = 2 I - (1 - eps)(nt nt^T + ns' ns'^T).
    ns = rotate_points(delta[:, :3, :3], src_normals)
    cmb = 2.0 * eye3 - one_m_eps * (nt[..., :, None] * nt[..., None, :]
                                    + ns[..., :, None] * ns[..., None, :])
    wmat = _inv_3x3_sym(cmb) * w[..., None, None]        # [N, P, 3, 3]
    r3 = cur - q
    count = w.sum(dim=1)
    cen = ((cur * w[..., None]).sum(dim=1)
           / torch.clamp(count, min=1.0)[:, None])       # [N, 3]
    cx = _hat(cur - cen[:, None, :])
    jac = torch.cat([-cx, eye3.expand(cx.shape)], dim=-1)   # [N, P, 3, 6]
    wj = torch.einsum("npab,npbj->npaj", wmat, jac)
    h = torch.einsum("npai,npaj->nij", jac, wj)
    g = -torch.einsum("npaj,npa->nj", wj, r3)
    ok = count >= 6
    diag = torch.diagonal(h, dim1=1, dim2=2)
    h = h + eye6 * (damping * diag + 1e-9)[:, None, :]
    h = torch.where(ok[:, None, None], h, eye6)
    xi = solve_spd_6x6(h, g)
    xi = torch.where((ok & ~converged)[:, None], xi, 0.0)
    step = se3_exp(xi)
    # The centred update as a camera-frame transform:
    # x' = R_s (x - c) + c + t_s.
    step[:, :3, 3] += cen - torch.einsum("nij,nj->ni", step[:, :3, :3], cen)
    delta = torch.bmm(step, delta)
    mres = torch.einsum("npa,npab,npb->np", r3, wmat, r3).sum(dim=1)
    prev_fit, prev_rmse = fitness, rmse
    fitness = count / n_valid
    rmse = sqrt(torch.clamp(mres / torch.clamp(count, min=1.0), min=0.0))
    converged, iters, streak = _converge(
        k, xi, fitness, rmse, prev_fit, prev_rmse, streak, ok, converged,
        iters, rot_eps, trn_eps)
    return [delta, converged, iters, fitness, rmse, streak]


class _Capture:
    """A device's CUDA graph capture of the GICP iteration: the side stream
    it is captured on and the last graph, whose memory pool the next
    capture shares (so the pool stays one, and is reused)."""

    def __init__(self, dev):
        self.stream = torch.cuda.Stream(dev)
        self.last = None
        self.lock = threading.Lock()


_CAPTURES: dict[str, _Capture] = {}


def _gicp_graph_loop(clouds, fixed, params, max_iterations):
    """icp_gicp_batch's loop on the card: one iteration captured as a CUDA
    graph over this call's tensors, then replayed until every pose has
    converged. A replay launches the iteration's several hundred kernels at
    once, so the loop runs at the card's pace rather than at the rate the
    host issues them; it runs the eager loop's kernels in the same order on
    the same shapes, so the two round alike. Returns (state, loops)."""
    dev = clouds[0].device
    state = _gicp_state(clouds[0].shape[0], dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def step():
        new = _gicp_step(k, state, clouds, fixed, *params)
        for old, value in zip(state, new):
            old.copy_(value)
        k.add_(1)

    cap = _CAPTURES.get(str(dev))
    if cap is None:
        cap = _CAPTURES.setdefault(str(dev), _Capture(dev))
    current = torch.cuda.current_stream(dev)
    with cap.lock:
        cap.stream.wait_stream(current)
        with torch.cuda.stream(cap.stream):
            if cap.last is None:
                # One eager iteration first: the libraries' handles and
                # workspaces for this stream.
                _gicp_step(0, _gicp_state(clouds[0].shape[0], dev), clouds,
                           fixed, *params)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(
                pool=cap.last.pool() if cap.last is not None else None,
                capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
        current.wait_stream(cap.stream)
        cap.last = graph
        loops = 0
        for _ in range(max_iterations):
            graph.replay()
            loops += 1
            if bool(state[1].all()):
                break
    return state, loops


def icp_gicp_batch(
    src_xyz: torch.Tensor,      # [N, P, 3] rendered cloud per pose (camera)
    src_valid: torch.Tensor,    # [N, P]
    src_normals: torch.Tensor,  # [N, P, 3] source normals (initial frame)
    tgt_xyz: torch.Tensor,      # [N, S, 3] observed segment per pose
    tgt_valid: torch.Tensor,    # [N, S]
    tgt_normals: torch.Tensor,  # [N, S, 3]
    *,
    max_iterations: int = 30,
    max_correspondence: float = 0.05,
    rotation_epsilon: float = 2e-4,
    transformation_epsilon: float = 5e-5,
    damping: float = 1e-4,
    gicp_epsilon: float = 1e-3,
    crop_k: int = 0,
    graph: bool = True,
) -> ICPResult:
    """Distribution-to-distribution (GICP) refinement with fast_gicp's
    semantics: plane-regularised covariances I - (1 - eps) n n^T on both
    clouds, residual weight inv(C_t + R C_s R^T) by adjugate, the full
    3-vector Gauss-Newton with J = [-[c - cen]x | I] about the
    correspondence centroid, Marquardt damping, 1-NN association every
    iteration. The default step thresholds are 10x tighter than the
    point-to-plane solver's (see the JAX function's docstring). On the card
    (unless graph=False) each iteration is one replay of a CUDA graph of
    it, captured once a call, with the same results."""
    n = src_xyz.shape[0]
    dev = src_xyz.device
    tgt_xyz, tgt_valid, tgt_normals = _crop(src_xyz, src_valid, tgt_xyz,
                                            tgt_valid, tgt_normals, crop_k)
    clouds = (src_xyz, src_valid, src_normals, tgt_xyz, tgt_valid,
              tgt_normals)
    fixed = (torch.eye(3, dtype=torch.float32, device=dev),
             torch.eye(6, dtype=torch.float32, device=dev),
             torch.clamp(src_valid.sum(dim=1).to(torch.float32), min=1.0))
    params = (max_correspondence * max_correspondence, 1.0 - gicp_epsilon,
              damping, rotation_epsilon, transformation_epsilon)
    if graph and dev.type == "cuda" and n and max_iterations > 0:
        state, loops = _gicp_graph_loop(clouds, fixed, params, max_iterations)
        delta, _, iters, fitness, rmse, _ = state
        return ICPResult(delta=delta, fitness=fitness, rmse=rmse,
                         iterations=iters, loops=loops)
    state = _gicp_state(n, dev)
    loops = 0
    for k in range(max_iterations):
        state = _gicp_step(k, state, clouds, fixed, *params)
        loops += 1
        if bool(state[1].all()):
            break
    delta, _, iters, fitness, rmse, _ = state
    return ICPResult(delta=delta, fitness=fitness, rmse=rmse, iterations=iters,
                     loops=loops)
