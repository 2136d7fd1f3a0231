"""Fused point-to-plane ICP over a batch of poses.

Counterpart of `perception_tpu/ops/pallas_icp.py` in point-to-plane mode. The
kernel (`csrc/icp_fused.cu`) and its PyTorch twin run the same Gauss-Newton
refinement per pose and return the best-so-far correction (min plane RMSE):

  * association at iterations k with k % nn_every == 0: the expanded-form
    distance max(|t|^2 + tadd - 2 t.c + |c|^2, 0) to each target and the
    packed (bits(d) & ~mask) | index minimum, which quantises d and breaks
    ties to the lowest index; the winner's plane (n, n.t) is gathered exactly;
  * weights (d + sadd <= max_correspondence^2), the 21 + 6 normal-equation
    sums, damping * trace / 6 + 1e-9 on the diagonal, identity system when
    fewer than 6 correspondences, an unrolled 6x6 Cholesky, Rodrigues step
    composed on the left;
  * exit per pose on a small step, `stagnation_streak` iterations without an
    RMSE gain of 1e-6, or too few correspondences; done poses freeze.

The d2d, symmetric, exact and adaptive (nn_every=0) modes are not ported yet.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops.numerics import div, sqrt

# Validity additive of invalid packed targets: large and finite (the same
# value as the JAX pack).
_INVALID_ADD = 1e30
# Elements of one (pose, target, point) association block in the twin.
_TWIN_BLOCK = 1 << 22
_MAX_SHARED = 227 * 1024
_THREADS = 256   # threads per block of csrc/icp_fused.cu


def pack_targets(tgt_xyz: torch.Tensor, tgt_valid: torch.Tensor,
                 tgt_normals: torch.Tensor) -> torch.Tensor:
    """[..., S, 8] packed target rows (x, y, z, nx, ny, nz, n.t, 0 or 1e30)."""
    bt = (tgt_normals[..., 0:1] * tgt_xyz[..., 0:1]
          + tgt_normals[..., 1:2] * tgt_xyz[..., 1:2]
          + tgt_normals[..., 2:3] * tgt_xyz[..., 2:3])
    tadd = torch.where(tgt_valid, 0.0, _INVALID_ADD).to(torch.float32)[..., None]
    return torch.cat([tgt_xyz, tgt_normals, bt, tadd], dim=-1).to(torch.float32)


def index_mask(s: int) -> int:
    """Low bits of the packed association key that hold the target index:
    the JAX kernel's mask for S padded to a multiple of 8."""
    s_pad = -(-s // 8) * 8
    return (1 << max(1, s_pad - 1).bit_length()) - 1


def icp_fused(
    src_xyz: torch.Tensor,      # [N, P, 3]
    src_valid: torch.Tensor,    # [N, P] bool
    tgt_packed: torch.Tensor,   # [N, S, 8] pack_targets rows
    src_normals: torch.Tensor | None = None,
    *,
    max_iterations: int = 20,
    max_correspondence: float = 0.05,
    damping: float = 1e-4,
    nn_every: int = 1,
    rotation_epsilon: float = 2e-3,
    transformation_epsilon: float = 5e-4,
    stagnation_streak: float = 8.0,
    d2d_epsilon: float = 0.0,
    exact: bool = False,
) -> torch.Tensor:
    """Camera-frame corrections [N, 4, 4] (pose' = delta @ pose). CUDA
    tensors launch the kernel; CPU tensors run the twin."""
    if src_normals is not None or d2d_epsilon > 0.0 or exact:
        raise NotImplementedError(
            "fused ICP d2d / symmetric / exact modes are not ported yet")
    if nn_every < 1:
        raise NotImplementedError(
            "adaptive association (nn_every=0) is not ported yet")
    args, kw = prepare_inputs(
        src_xyz, src_valid, tgt_packed, max_iterations=max_iterations,
        max_correspondence=max_correspondence, damping=damping,
        nn_every=nn_every, rotation_epsilon=rotation_epsilon,
        transformation_epsilon=transformation_epsilon,
        stagnation_streak=stagnation_streak)
    if src_xyz.device.type == "cpu":
        build.TWIN_CALLS["icp_fused"] += 1
        return icp_fused_twin(*args, **kw)
    return launch_kernel(*args, **kw)


def prepare_inputs(src_xyz, src_valid, tgt_packed, *, max_iterations=20,
                   max_correspondence=0.05, damping=1e-4, nn_every=1,
                   rotation_epsilon=2e-3, transformation_epsilon=5e-4,
                   stagnation_streak=8.0) -> tuple[tuple, dict]:
    """The kernel's (and the twin's) arguments: contiguous f32 sources, the
    +inf additive of invalid sources, the packed targets, squared thresholds
    and the association index mask."""
    src = src_xyz.to(torch.float32).contiguous()
    sadd = torch.where(src_valid, 0.0, float("inf")).to(torch.float32)
    tgt = tgt_packed.to(torch.float32).contiguous()
    kw = dict(max_iterations=int(max_iterations),
              max_corr_sq=max_correspondence * max_correspondence,
              damping=float(damping), nn_every=int(nn_every),
              rot_eps_sq=rotation_epsilon * rotation_epsilon,
              trn_eps_sq=transformation_epsilon * transformation_epsilon,
              stagnation_streak=float(stagnation_streak),
              idx_mask=index_mask(tgt.shape[1]))
    return (src, sadd.contiguous(), tgt), kw


def launch_kernel(src, sadd, tgt, *, max_iterations, max_corr_sq, damping,
                  nn_every, rot_eps_sq, trn_eps_sq, stagnation_streak,
                  idx_mask) -> torch.Tensor:
    """csrc/icp_fused.cu on CUDA tensors."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"icp_fused kernel: tensors on {dev}")
    n, p, _ = src.shape
    s = tgt.shape[1]
    build.check(src, "src_xyz", torch.float32, (n, p, 3), dev)
    build.check(sadd, "sadd", torch.float32, (n, p), dev)
    build.check(tgt, "tgt_packed", torch.float32, (n, s, 8), dev)
    smem = s * 32 + p * 20
    if smem > _MAX_SHARED:
        raise ValueError(f"icp_fused kernel: S={s}, P={p} need {smem} B of "
                         f"shared memory (> {_MAX_SHARED})")
    out = torch.empty((n, 4, 4), dtype=torch.float32, device=dev)
    build.launch("pt_icp_fused", build.ptr(src), build.ptr(sadd),
                 build.ptr(tgt), n, p, s, max_iterations, max_corr_sq,
                 damping, nn_every, rot_eps_sq, trn_eps_sq, stagnation_streak,
                 idx_mask, build.ptr(out))
    return out


def _associate(cx, cy, cz, tab, planes, idx_mask):
    """Packed nearest-target association of every point: (nx, ny, nz, n.t,
    quantised dmin), each [N, P]."""
    n, p = cx.shape
    s = tab.shape[1]
    out = torch.empty((5, n, p), dtype=torch.float32, device=cx.device)
    sidx = torch.arange(s, dtype=torch.int32, device=cx.device)[None, :, None]
    nb = max(1, _TWIN_BLOCK // (s * p))
    for i in range(0, n, nb):
        x, y, z = cx[i:i + nb, None], cy[i:i + nb, None], cz[i:i + nb, None]
        t = tab[i:i + nb, :, :, None]                     # [nb, S, 4, 1]
        cc = x * x + y * y + z * z
        d = t[:, :, 3] + t[:, :, 0] * x + t[:, :, 1] * y + t[:, :, 2] * z
        d = torch.clamp(d + cc, min=0.0)                  # [nb, S, P]
        pmin = ((d.view(torch.int32) & ~idx_mask) | sidx).amin(dim=1)
        win = (pmin & idx_mask).long()
        plane = torch.gather(planes[i:i + nb], 1,
                             win[..., None].expand(-1, -1, 4))   # [nb, P, 4]
        out[:4, i:i + nb] = plane.permute(2, 0, 1)
        out[4, i:i + nb] = (pmin & ~idx_mask).view(torch.float32)
    return out


def _kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (point) axis in the kernel's order: each of 256
    threads adds points p = tid, tid + 256, ... in turn, a warp sums its 32
    threads by shuffles at offsets 16, 8, 4, 2, 1, and the 8 warp sums are
    added in order. The twin's sums are then bit-identical to the kernel's."""
    p = x.shape[-1]
    rounds = -(-p // _THREADS)
    x = torch.nn.functional.pad(x, (0, rounds * _THREADS - p))
    x = x.reshape(*x.shape[:-1], rounds, _THREADS)
    acc = x[..., 0, :]
    for r in range(1, rounds):
        acc = acc + x[..., r, :]
    v = acc.reshape(*acc.shape[:-1], _THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    total = v[..., 0, 0]
    for w in range(1, _THREADS // 32):
        total = total + v[..., w, 0]
    return total


def _cholesky_solve(h, g):
    """Unrolled 6x6 Cholesky solve on per-pose tensors (h upper triangle)."""
    l = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = h[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        l[j][j] = sqrt(torch.clamp(s, min=1e-20))
        inv = 1.0 / l[j][j]
        for i in range(j + 1, 6):
            s = h[j][i]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    y = [None] * 6
    for i in range(6):
        s = g[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


def icp_fused_twin(src: torch.Tensor, sadd: torch.Tensor, tgt: torch.Tensor, *,
                   max_iterations: int, max_corr_sq: float, damping: float,
                   nn_every: int, rot_eps_sq: float, trn_eps_sq: float,
                   stagnation_streak: float, idx_mask: int,
                   return_iterations: bool = False):
    """Plain PyTorch version of the kernel, vectorised over poses; done poses
    freeze, so each pose's result is that of a solo refinement. With
    return_iterations, also the Gauss-Newton iterations each pose ran [N]."""
    n = src.shape[0]
    dev = src.device
    sx, sy, sz = src[..., 0], src[..., 1], src[..., 2]
    tx, ty, tz = tgt[..., 0], tgt[..., 1], tgt[..., 2]
    tab = torch.stack([-2.0 * tx, -2.0 * ty, -2.0 * tz,
                       tx * tx + ty * ty + tz * tz + tgt[..., 7]], dim=-1)
    planes = tgt[..., 3:7].contiguous()

    one = torch.ones((n,), dtype=torch.float32, device=dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    cur = [one, zero, zero, zero, one, zero, zero, zero, one, zero, zero, zero]
    best = list(cur)
    best_rmse = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    streak = zero
    done = zero
    iters = zero
    assoc = None
    for k in range(max_iterations):
        r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2 = (
            c[:, None] for c in cur)
        cx = r00 * sx + r01 * sy + r02 * sz + t0
        cy = r10 * sx + r11 * sy + r12 * sz + t1
        cz = r20 * sx + r21 * sy + r22 * sz + t2
        if nn_every <= 1 or k % nn_every == 0:
            assoc = _associate(cx, cy, cz, tab, planes, idx_mask)
        nx, ny, nz, nq, dmin = assoc
        w = ((dmin + sadd) <= max_corr_sq).to(torch.float32)
        e = nx * cx + ny * cy + nz * cz - nq
        js = (cy * nz - cz * ny, cz * nx - cx * nz, cx * ny - cy * nx,
              nx, ny, nz)
        terms = [js[i] * js[j] * w for i in range(6) for j in range(i, 6)]
        terms += [js[i] * e * w for i in range(6)] + [w, e * e * w]
        sums = _kernel_order_sum(torch.stack(terms))          # [29, N]
        h = [[None] * 6 for _ in range(6)]
        q = 0
        for i in range(6):
            for j in range(i, 6):
                h[i][j] = sums[q]
                q += 1
        g = [-sums[21 + i] for i in range(6)]
        count, res2 = sums[27], sums[28]

        ok = count >= 6.0
        active = done < 0.5
        iters = iters + active.to(torch.float32)
        rmse = sqrt(res2 / torch.clamp(count, min=1.0))
        improved = ok & (rmse < best_rmse) & active
        new_best_rmse = torch.where(improved, rmse, best_rmse)
        best = [torch.where(improved, c, b) for c, b in zip(cur, best)]

        trace = h[0][0] + h[1][1] + h[2][2] + h[3][3] + h[4][4] + h[5][5]
        lam = div(damping * trace, 6.0) + 1e-9
        for i in range(6):
            h[i][i] = h[i][i] + lam
        for i in range(6):
            for j in range(i, 6):
                h[i][j] = torch.where(ok, h[i][j], 1.0 if i == j else 0.0)
            g[i] = torch.where(ok, g[i], 0.0)
        xi = _cholesky_solve(h, g)

        wx, wy, wz = xi[0], xi[1], xi[2]
        theta2 = wx * wx + wy * wy + wz * wz
        theta = sqrt(torch.clamp(theta2, min=1e-24))
        # sin / cos in float64, rounded to float32: as the kernel does.
        a = torch.sin(theta.double()).float() / theta
        b = ((1.0 - torch.cos(theta.double()).float())
             / torch.clamp(theta2, min=1e-24))
        small = theta2 < 1e-12
        a = torch.where(small, 1.0, a)
        b = torch.where(small, 0.5, b)
        ex = (1.0 - b * (wy * wy + wz * wz), -a * wz + b * wx * wy,
              a * wy + b * wx * wz,
              a * wz + b * wx * wy, 1.0 - b * (wx * wx + wz * wz),
              -a * wx + b * wy * wz,
              -a * wy + b * wx * wz, a * wx + b * wy * wz,
              1.0 - b * (wx * wx + wy * wy))
        raw = [None] * 12
        for i in range(3):
            for j in range(3):
                raw[3 * i + j] = (ex[3 * i] * cur[j] + ex[3 * i + 1] * cur[3 + j]
                                  + ex[3 * i + 2] * cur[6 + j])
            raw[9 + i] = (ex[3 * i] * cur[9] + ex[3 * i + 1] * cur[10]
                          + ex[3 * i + 2] * cur[11] + xi[3 + i])
        cur = [torch.where(active, r, c) for r, c in zip(raw, cur)]

        rot_n2 = wx * wx + wy * wy + wz * wz
        trn_n2 = xi[3] * xi[3] + xi[4] * xi[4] + xi[5] * xi[5]
        step_small = (rot_n2 < rot_eps_sq) & (trn_n2 < trn_eps_sq)
        improved_sig = rmse < best_rmse - 1e-6
        new_streak = torch.where(improved_sig, 0.0, streak + 1.0)
        streak = torch.where(active, new_streak, streak)
        done_now = step_small | (streak >= stagnation_streak) | ~ok
        done = torch.where(active & done_now, 1.0, done)
        best_rmse = new_best_rmse
        if bool((done > 0.5).all()):
            break

    out = torch.zeros((n, 4, 4), dtype=torch.float32, device=dev)
    for i in range(3):
        for j in range(3):
            out[:, i, j] = best[3 * i + j]
        out[:, i, 3] = best[9 + i]
    out[:, 3, 3] = 1.0
    return (out, iters) if return_iterations else out
