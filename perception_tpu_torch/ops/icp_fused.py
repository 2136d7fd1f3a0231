"""Fused ICP over a batch of poses, in the four cost modes of the TPU kernel.

Counterpart of `perception_tpu/ops/pallas_icp.py`. The kernel
(`csrc/icp_fused.cu`) and its PyTorch twin run the same Gauss-Newton
refinement per pose and return the best-so-far correction (min RMSE):

  * association at iterations k with k % nn_every == 0, or adaptively
    (nn_every=0, below): the expanded-form distance
    max(|t|^2 + tadd - 2 t.c + |c|^2, 0) to each target and the packed
    (bits(d) & ~mask) | index minimum, which quantises d and breaks ties to
    the lowest index; the winner's plane (n, n.t), and its point q in the d2d
    modes, are gathered exactly;
  * weights (d + sadd <= max_correspondence^2) and the normal equations of
    the mode (`fused_mode`):
      p2p    point-to-plane, damping * trace / 6 + 1e-9 on the diagonal;
      d2d    (d2d_epsilon > 0) plus the point-to-point terms at weight
             eps / (1 - eps), rotating about the correspondence centroid;
      sym    (d2d with src_normals) plus the plane of the source normal
             rotated by the current estimate, the tangential weight doubled;
      exact  (sym with exact=True) the full 3x3 Mahalanobis Gauss-Newton of
             `icp_gicp_batch`, with Marquardt damping h_ii (1 + damping);
    the identity system when fewer than 6 correspondences, an unrolled 6x6
    Cholesky, Rodrigues step composed on the left;
  * exit per pose on a small step, `stagnation_streak` iterations without an
    RMSE gain of 1e-6, or too few correspondences; done poses freeze.

Adaptive association (nn_every=0) re-runs the sweep when some active pose of
the group of 8 (poses 8 * (i // 8) ... + 7, the TPU kernel's fixed group)
has moved more than `assoc_trigger` since the group's last sweep, so a pose's
result depends on its group; the fixed-period modes are per pose.
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
_THREADS = 64    # threads per pose (block) of csrc/icp_fused.cu
GROUP = 8        # poses per adaptive-association group
MODES = ("p2p", "d2d", "sym", "exact")


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


def fused_mode(src_normals: torch.Tensor | None, d2d_epsilon: float,
               exact: bool) -> str:
    """The kernel's cost mode, as icp_fused_pallas resolves its flags:
    normals matter only with d2d_epsilon > 0, exact needs both."""
    d2d = d2d_epsilon > 0.0
    sym = src_normals is not None and d2d
    if exact and not sym:
        raise ValueError("exact=True needs d2d_epsilon > 0 and src_normals")
    if exact:
        return "exact"
    if sym:
        return "sym"
    return "d2d" if d2d else "p2p"


def icp_fused(
    src_xyz: torch.Tensor,      # [N, P, 3]
    src_valid: torch.Tensor,    # [N, P] bool
    tgt_packed: torch.Tensor,   # [N, S, 8] pack_targets rows
    src_normals: torch.Tensor | None = None,   # [N, P, 3] (sym, exact)
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
    assoc_trigger: float = 0.004,
) -> torch.Tensor:
    """Camera-frame corrections [N, 4, 4] (pose' = delta @ pose). CUDA
    tensors launch the kernel; CPU tensors run the twin."""
    args, kw = prepare_inputs(
        src_xyz, src_valid, tgt_packed, src_normals,
        max_iterations=max_iterations, max_correspondence=max_correspondence,
        damping=damping, nn_every=nn_every, rotation_epsilon=rotation_epsilon,
        transformation_epsilon=transformation_epsilon,
        stagnation_streak=stagnation_streak, d2d_epsilon=d2d_epsilon,
        exact=exact, assoc_trigger=assoc_trigger)
    if src_xyz.device.type == "cpu":
        build.TWIN_CALLS["icp_fused"] += 1
        return icp_fused_twin(*args, **kw)
    return launch_kernel(*args, **kw)


def prepare_inputs(src_xyz, src_valid, tgt_packed, src_normals=None, *,
                   max_iterations=20, max_correspondence=0.05, damping=1e-4,
                   nn_every=1, rotation_epsilon=2e-3,
                   transformation_epsilon=5e-4, stagnation_streak=8.0,
                   d2d_epsilon=0.0, exact=False, assoc_trigger=0.004
                   ) -> tuple[tuple, dict]:
    """The kernel's (and the twin's) arguments: contiguous f32 sources (and
    source normals in sym / exact), the +inf additive of invalid sources, the
    packed targets, the mode, squared thresholds, the association index mask
    and the mode's weights. Adaptive association pads P to a multiple of 128
    with zero sources, as the TPU kernel's lanes: their lever arm enters the
    motion bound."""
    mode = fused_mode(src_normals, d2d_epsilon, exact)
    if nn_every < 0:
        raise ValueError(f"nn_every={nn_every} < 0")
    src = src_xyz.to(torch.float32)
    sadd = torch.where(src_valid, 0.0, float("inf")).to(torch.float32)
    snrm = (src_normals.to(torch.float32) if mode in ("sym", "exact")
            else None)
    p = src.shape[1]
    pad = -(-p // 128) * 128 - p if nn_every == 0 else 0
    if pad:
        src = torch.nn.functional.pad(src, (0, 0, 0, pad))
        sadd = torch.nn.functional.pad(sadd, (0, pad), value=float("inf"))
        if snrm is not None:
            snrm = torch.nn.functional.pad(snrm, (0, 0, 0, pad))
    tgt = tgt_packed.to(torch.float32).contiguous()
    eps = float(d2d_epsilon)
    wpp = eps / (1.0 - eps) if mode != "p2p" else 0.0
    if mode in ("sym", "exact"):
        wpp = 2.0 * wpp
    kw = dict(mode=mode, max_iterations=int(max_iterations),
              max_corr_sq=max_correspondence * max_correspondence,
              damping=float(damping), nn_every=int(nn_every),
              rot_eps_sq=rotation_epsilon * rotation_epsilon,
              trn_eps_sq=transformation_epsilon * transformation_epsilon,
              stagnation_streak=float(stagnation_streak),
              idx_mask=index_mask(tgt.shape[1]), wpp=wpp, ome=1.0 - eps,
              damp1=1.0 + float(damping), assoc_trigger=float(assoc_trigger))
    return (src.contiguous(), None if snrm is None else snrm.contiguous(),
            sadd.contiguous(), tgt), kw


def launch_kernel(src, snrm, sadd, tgt, *, mode, max_iterations, max_corr_sq,
                  damping, nn_every, rot_eps_sq, trn_eps_sq, stagnation_streak,
                  idx_mask, wpp, ome, damp1, assoc_trigger) -> torch.Tensor:
    """csrc/icp_fused.cu on CUDA tensors."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"icp_fused kernel: tensors on {dev}")
    n, p, _ = src.shape
    s = tgt.shape[1]
    build.check(src, "src_xyz", torch.float32, (n, p, 3), dev)
    build.check(sadd, "sadd", torch.float32, (n, p), dev)
    build.check(tgt, "tgt_packed", torch.float32, (n, s, 8), dev)
    if mode in ("sym", "exact"):
        build.check(snrm, "src_normals", torch.float32, (n, p, 3), dev)
    elif snrm is not None:
        raise ValueError(f"icp_fused kernel: src_normals given in mode {mode}")
    # Compacted association and plane rows with a zero row, the per-source
    # cache and the source list (16-bit indices).
    smem = (s + 1) * 32 + p * 8
    if smem > _MAX_SHARED or max(s, p) > 0xFFFF:
        raise ValueError(f"icp_fused kernel: S={s}, P={p} need {smem} B of "
                         f"shared memory (> {_MAX_SHARED}) or 16-bit indices")
    out = torch.empty((n, 4, 4), dtype=torch.float32, device=dev)
    build.launch("pt_icp_fused", build.ptr(src), build.ptr(snrm),
                 build.ptr(sadd), build.ptr(tgt), n, p, s, MODES.index(mode),
                 max_iterations, max_corr_sq, damping, nn_every, rot_eps_sq,
                 trn_eps_sq, stagnation_streak, idx_mask, wpp, ome, damp1,
                 assoc_trigger, build.ptr(out))
    return out


def _associate(cx, cy, cz, tab, attrs, idx_mask):
    """Packed nearest-target association of every point: the winner's
    attribute rows (plane n, n.t, then q in the d2d modes) and the quantised
    dmin, [A + 1, N, P]."""
    n, p = cx.shape
    s = tab.shape[1]
    a = attrs.shape[-1]
    out = torch.empty((a + 1, n, p), dtype=torch.float32, device=cx.device)
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
        rows = torch.gather(attrs[i:i + nb], 1,
                            win[..., None].expand(-1, -1, a))   # [nb, P, A]
        out[:a, i:i + nb] = rows.permute(2, 0, 1)
        out[a, i:i + nb] = (pmin & ~idx_mask).view(torch.float32)
    return out


def _kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (point) axis in the kernel's order: each of the
    _THREADS threads of a pose adds points p = tid, tid + _THREADS, ... in
    turn, a warp sums its 32 threads by shuffles at offsets 16, 8, 4, 2, 1,
    and the warp sums are added in order. The twin's sums are then
    bit-identical to the kernel's."""
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


def cholesky_solve_6x6(h, g):
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


def _point_terms(mode, w, cx, cy, cz, ax, ay, az, assoc, ns, wpp, ome):
    """The per-point terms of the mode, in the kernel's sum order
    (csrc/icp_fused.cu: H upper triangle, g, count, w res^2, then the d2d
    and sym extras)."""
    nx, ny, nz, nq = assoc[0], assoc[1], assoc[2], assoc[3]
    if mode != "p2p":
        rx, ry, rz = cx - assoc[4], cy - assoc[5], cz - assoc[6]
    if mode == "exact":
        nsx, nsy, nsz = ns
        c00 = 2.0 - ome * (nx * nx + nsx * nsx)
        c01 = -ome * (nx * ny + nsx * nsy)
        c02 = -ome * (nx * nz + nsx * nsz)
        c11 = 2.0 - ome * (ny * ny + nsy * nsy)
        c12 = -ome * (ny * nz + nsy * nsz)
        c22 = 2.0 - ome * (nz * nz + nsz * nsz)
        co00 = c11 * c22 - c12 * c12
        co01 = c02 * c12 - c01 * c22
        co02 = c01 * c12 - c02 * c11
        co11 = c00 * c22 - c02 * c02
        co12 = c01 * c02 - c00 * c12
        co22 = c00 * c11 - c01 * c01
        det = c00 * co00 + c01 * co01 + c02 * co02
        invd = w / torch.clamp(det, min=1e-20)
        m00, m01, m02 = co00 * invd, co01 * invd, co02 * invd
        m11, m12, m22 = co11 * invd, co12 * invd, co22 * invd
        us = ((-az * m01 + ay * m02, -az * m11 + ay * m12,
               -az * m12 + ay * m22),
              (az * m00 - ax * m02, az * m01 - ax * m12, az * m02 - ax * m22),
              (-ay * m00 + ax * m01, -ay * m01 + ax * m11,
               -ay * m02 + ax * m12),
              (m00, m01, m02), (m01, m11, m12), (m02, m12, m22))

        def dot_col(i, vx, vy, vz):
            if i == 0:
                return -az * vy + ay * vz
            if i == 1:
                return az * vx - ax * vz
            if i == 2:
                return -ay * vx + ax * vy
            return (vx, vy, vz)[i - 3]

        wrx = m00 * rx + m01 * ry + m02 * rz
        wry = m01 * rx + m11 * ry + m12 * rz
        wrz = m02 * rx + m12 * ry + m22 * rz
        terms = [dot_col(i, *us[j]) for i in range(6) for j in range(i, 6)]
        terms += [dot_col(i, wrx, wry, wrz) for i in range(6)]
        res2 = rx * wrx + ry * wry + rz * wrz
        return terms + [w, res2 * w]
    e = nx * cx + ny * cy + nz * cz - nq
    js = (ay * nz - az * ny, az * nx - ax * nz, ax * ny - ay * nx, nx, ny, nz)
    terms = [js[i] * js[j] * w for i in range(6) for j in range(i, 6)]
    terms += [js[i] * e * w for i in range(6)] + [w]
    res2 = e * e
    extra = []
    if mode in ("d2d", "sym"):
        extra = [ax * ax * w, ay * ay * w, az * az * w, ax * ay * w,
                 ax * az * w, ay * az * w, ax * w, ay * w, az * w,
                 (ay * rz - az * ry) * w, (az * rx - ax * rz) * w,
                 (ax * ry - ay * rx) * w, rx * w, ry * w, rz * w]
        res2 = res2 + wpp * (rx * rx + ry * ry + rz * rz)
        if mode == "sym":
            nsx, nsy, nsz = ns
            e2 = nsx * rx + nsy * ry + nsz * rz
            ks = (ay * nsz - az * nsy, az * nsx - ax * nsz,
                  ax * nsy - ay * nsx, nsx, nsy, nsz)
            extra += [ks[i] * ks[j] * w for i in range(6) for j in range(i, 6)]
            extra += [ks[i] * e2 * w for i in range(6)]
            res2 = res2 + e2 * e2
    return terms + [res2 * w] + extra


def _normal_equations(mode, sums, wpp):
    """(h upper triangle, g, count, sum w res^2) of the mode from the
    reduced sums, assembled as the kernel's solve does."""
    h = [[None] * 6 for _ in range(6)]
    q = 0
    for i in range(6):
        for j in range(i, 6):
            h[i][j] = sums[q]
            q += 1
    g = [-sums[21 + i] for i in range(6)]
    count, res2 = sums[27], sums[28]
    if mode in ("d2d", "sym"):
        cxs, cys, czs, cxy, cxz, cyz, sx, sy, sz = sums[29:38]
        for (i, j), v in (((0, 0), cys + czs), ((0, 1), -cxy),
                          ((0, 2), -cxz), ((0, 4), -sz), ((0, 5), sy),
                          ((1, 1), cxs + czs), ((1, 2), -cyz), ((1, 3), sz),
                          ((1, 5), -sx), ((2, 2), cxs + cys), ((2, 3), -sy),
                          ((2, 4), sx), ((3, 3), count), ((4, 4), count),
                          ((5, 5), count)):
            h[i][j] = h[i][j] + wpp * v
        for i in range(6):
            g[i] = g[i] + (-wpp) * sums[38 + i]
        if mode == "sym":
            q = 44
            for i in range(6):
                for j in range(i, 6):
                    h[i][j] = h[i][j] + sums[q]
                    q += 1
            for i in range(6):
                g[i] = g[i] + (-sums[65 + i])
    return h, g, count, res2


def icp_fused_twin(src: torch.Tensor, snrm: torch.Tensor | None,
                   sadd: torch.Tensor, tgt: torch.Tensor, *, mode: str,
                   max_iterations: int, max_corr_sq: float, damping: float,
                   nn_every: int, rot_eps_sq: float, trn_eps_sq: float,
                   stagnation_streak: float, idx_mask: int, wpp: float,
                   ome: float, damp1: float, assoc_trigger: float,
                   return_counts: bool = False):
    """Plain PyTorch version of the kernel, vectorised over poses; done poses
    freeze. With return_counts, also the Gauss-Newton iterations and the
    association sweeps each pose ran ([N] each)."""
    n = src.shape[0]
    dev = src.device
    d2d = mode != "p2p"
    adaptive = nn_every == 0
    sx, sy, sz = src[..., 0], src[..., 1], src[..., 2]
    tx, ty, tz = tgt[..., 0], tgt[..., 1], tgt[..., 2]
    tab = torch.stack([-2.0 * tx, -2.0 * ty, -2.0 * tz,
                       tx * tx + ty * ty + tz * tz + tgt[..., 7]], dim=-1)
    attrs = (tgt[..., [3, 4, 5, 6, 0, 1, 2]] if d2d else tgt[..., 3:7])
    attrs = attrs.contiguous()

    one = torch.ones((n,), dtype=torch.float32, device=dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    cur = [one, zero, zero, zero, one, zero, zero, zero, one, zero, zero, zero]
    best = list(cur)
    best_rmse = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    streak = zero
    done = zero
    accum = zero
    iters = zero
    sweeps = zero
    n_pad = -(-n // GROUP) * GROUP
    assoc = None
    for k in range(max_iterations):
        active = done < 0.5
        if adaptive:
            pub = torch.nn.functional.pad(accum * (1.0 - done), (0, n_pad - n))
            gmax = pub.reshape(-1, GROUP).amax(dim=1).repeat_interleave(
                GROUP)[:n]
            need = (gmax > assoc_trigger) | (k == 0)
            accum = torch.where(need, 0.0, accum)
        else:
            due = nn_every <= 1 or k % nn_every == 0
            need = torch.full((n,), due, dtype=torch.bool, device=dev)
        sweeps = sweeps + (need & active).to(torch.float32)
        r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2 = (
            c[:, None] for c in cur)
        cx = r00 * sx + r01 * sy + r02 * sz + t0
        cy = r10 * sx + r11 * sy + r12 * sz + t1
        cz = r20 * sx + r21 * sy + r22 * sz + t2
        if bool(need.any()):
            fresh = _associate(cx, cy, cz, tab, attrs, idx_mask)
            assoc = (fresh if assoc is None
                     else torch.where(need[None, :, None], fresh, assoc))
        a_n = attrs.shape[-1]
        dmin = assoc[a_n]
        w = ((dmin + sadd) <= max_corr_sq).to(torch.float32)
        cen = (zero, zero, zero)
        if d2d:
            s4 = _kernel_order_sum(torch.stack([w, cx * w, cy * w, cz * w]))
            inv_cnt = 1.0 / torch.clamp(s4[0], min=1.0)
            cen = (s4[1] * inv_cnt, s4[2] * inv_cnt, s4[3] * inv_cnt)
            ax, ay, az = cx - cen[0][:, None], cy - cen[1][:, None], \
                cz - cen[2][:, None]
        else:
            ax, ay, az = cx, cy, cz
        ns = None
        if snrm is not None:
            snx, sny, snz = snrm[..., 0], snrm[..., 1], snrm[..., 2]
            ns = (r00 * snx + r01 * sny + r02 * snz,
                  r10 * snx + r11 * sny + r12 * snz,
                  r20 * snx + r21 * sny + r22 * snz)
        terms = _point_terms(mode, w, cx, cy, cz, ax, ay, az,
                             [assoc[i] for i in range(a_n)], ns, wpp, ome)
        sums = _kernel_order_sum(torch.stack(terms))
        h, g, count, res2 = _normal_equations(mode, sums, wpp)

        ok = count >= 6.0
        iters = iters + active.to(torch.float32)
        rmse = sqrt(res2 / torch.clamp(count, min=1.0))
        improved = ok & (rmse < best_rmse) & active
        new_best_rmse = torch.where(improved, rmse, best_rmse)
        best = [torch.where(improved, c, b) for c, b in zip(cur, best)]

        if mode == "exact":
            for i in range(6):
                h[i][i] = h[i][i] * damp1 + 1e-9
        else:
            trace = h[0][0] + h[1][1] + h[2][2] + h[3][3] + h[4][4] + h[5][5]
            lam = div(damping * trace, 6.0) + 1e-9
            for i in range(6):
                h[i][i] = h[i][i] + lam
        for i in range(6):
            for j in range(i, 6):
                h[i][j] = torch.where(ok, h[i][j], 1.0 if i == j else 0.0)
            g[i] = torch.where(ok, g[i], 0.0)
        xi = cholesky_solve_6x6(h, g)

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
            if d2d:
                raw[9 + i] = raw[9 + i] + cen[i] - (
                    ex[3 * i] * cen[0] + ex[3 * i + 1] * cen[1]
                    + ex[3 * i + 2] * cen[2])
        cur = [torch.where(active, r, c) for r, c in zip(raw, cur)]

        rot_n2 = wx * wx + wy * wy + wz * wz
        trn_n2 = xi[3] * xi[3] + xi[4] * xi[4] + xi[5] * xi[5]
        if adaptive:
            ext = sqrt((ax * ax + ay * ay + az * az).amax(dim=1))
            accum = torch.where(active, accum + (theta * ext + sqrt(trn_n2)),
                                accum)
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
    return (out, iters, sweeps) if return_counts else out
