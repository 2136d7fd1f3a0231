"""Point-to-plane ICP over a batch of poses, with the observed normals and
the target crop it reads.

Frozen copies of the port's plain versions (`ops/knn.py` `knn_self`,
`ops/icp.py` `cloud_normals` and `crop_targets`, `ops/icp_fused.py` the
fused refiner's twin in its point-to-plane mode): per pose, association to
the nearest target every `nn_every` iterations by the expanded-form distance
packed with the target index (ties to the lowest index), weights within
max_correspondence, the damped 6x6 normal equations summed in a fixed order,
an unrolled Cholesky solve and a Rodrigues step; each pose exits on a small
step, a streak without RMSE gain, or too few correspondences, and returns
its best-RMSE correction.
"""

from __future__ import annotations

import torch

from portbench.reference.numerics import div, sqrt

_INVALID_ADD = 1e30
_BLOCK = 1 << 22
_KNN_BLOCK = 1 << 24
_KEY_MAX = torch.iinfo(torch.int64).max
_THREADS = 64


def knn_self(xyz, valid, k: int):
    """k nearest valid neighbours of each point in its own cloud, self
    excluded, nearest first, equal distances by lower index."""
    n, p, _ = xyz.shape
    dev = xyz.device
    dists = torch.empty((n, p, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, p, k), dtype=torch.int32, device=dev)
    cols = torch.arange(p, device=dev)
    rows = max(1, _KNN_BLOCK // max(n * p, 1))
    for lo in range(0, p, rows):
        hi = min(p, lo + rows)
        diff = xyz[:, lo:hi, None, :] - xyz[:, None, :, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        del diff
        other = cols[lo:hi, None] != cols[None, :]
        d = torch.where(valid[:, None, :] & other, d, float("inf"))
        key = (d.contiguous().view(torch.int32).to(torch.int64) << 32) | cols
        del d
        for j in range(k):
            m = key.amin(dim=-1)
            col = m & 0xFFFFFFFF
            dists[:, lo:hi, j] = (m >> 32).to(torch.int32).view(torch.float32)
            idx[:, lo:hi, j] = col.to(torch.int32)
            key.scatter_(-1, col[..., None], _KEY_MAX)
    return dists, idx


def _ordered_sum(x, dim):
    total = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        total = total + x.select(dim, i)
    return total


def _norm3(v):
    return sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                + v[..., 2:3] * v[..., 2:3])


def _matmul3(a, b):
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _matvec3(m, v):
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3])


def smallest_eigenvector_3x3(cov, iters: int = 12):
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


def cloud_normals(xyz, valid, k: int = 10):
    """Normals [B, P, 3] from the covariance of the k nearest valid
    neighbours, flipped towards the camera origin."""
    _, idx = knn_self(xyz, valid, k=k)
    idx = idx.long()
    b = torch.arange(xyz.shape[0], device=xyz.device)[:, None, None]
    neighbors = xyz[b, idx]
    wgt = valid[b, idx].to(xyz.dtype)[..., None]
    cnt = torch.clamp(_ordered_sum(wgt, 2), min=1.0)
    mean = _ordered_sum(neighbors * wgt, 2) / cnt
    centered = (neighbors - mean[:, :, None]) * wgt
    outer = centered[..., :, None] * centered[..., None, :]
    cov = _ordered_sum(outer, 2) / cnt[..., None]
    n = smallest_eigenvector_3x3(cov)
    dot = (n[..., 0:1] * xyz[..., 0:1] + n[..., 1:2] * xyz[..., 1:2]
           + n[..., 2:3] * xyz[..., 2:3])
    flip = torch.sign(-dot)
    return n * torch.where(flip == 0, 1.0, flip)


def crop_near(tgt_xyz, tgt_valid, centers, k: int):
    """Indices [N, k] of the k valid targets nearest each centre (stable)."""
    diff = tgt_xyz - centers[:, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])
    d = torch.where(tgt_valid, d, float("inf"))
    idx = torch.sort(d, dim=1, stable=True).indices
    return idx[:, :min(k, tgt_xyz.shape[1])]


def rotate_points(rot, pts):
    r = rot[:, None]
    return (pts[..., 0:1] * r[..., 0] + pts[..., 1:2] * r[..., 1]
            + pts[..., 2:3] * r[..., 2])


def pack_targets(tgt_xyz, tgt_valid, tgt_normals):
    """[..., S, 8] rows (x, y, z, nx, ny, nz, n.t, 0 or 1e30)."""
    bt = (tgt_normals[..., 0:1] * tgt_xyz[..., 0:1]
          + tgt_normals[..., 1:2] * tgt_xyz[..., 1:2]
          + tgt_normals[..., 2:3] * tgt_xyz[..., 2:3])
    tadd = torch.where(tgt_valid, 0.0, _INVALID_ADD).to(torch.float32)
    return torch.cat([tgt_xyz, tgt_normals, bt, tadd[..., None]],
                     dim=-1).to(torch.float32)


def index_mask(s: int) -> int:
    s_pad = -(-s // 8) * 8
    return (1 << max(1, s_pad - 1).bit_length()) - 1


def _associate(cx, cy, cz, tab, attrs, idx_mask):
    n, p = cx.shape
    s = tab.shape[1]
    a = attrs.shape[-1]
    out = torch.empty((a + 1, n, p), dtype=torch.float32, device=cx.device)
    sidx = torch.arange(s, dtype=torch.int32, device=cx.device)[None, :, None]
    nb = max(1, _BLOCK // (s * p))
    for i in range(0, n, nb):
        x, y, z = cx[i:i + nb, None], cy[i:i + nb, None], cz[i:i + nb, None]
        t = tab[i:i + nb, :, :, None]
        cc = x * x + y * y + z * z
        d = t[:, :, 3] + t[:, :, 0] * x + t[:, :, 1] * y + t[:, :, 2] * z
        d = torch.clamp(d + cc, min=0.0)
        pmin = ((d.view(torch.int32) & ~idx_mask) | sidx).amin(dim=1)
        win = (pmin & idx_mask).long()
        rows = torch.gather(attrs[i:i + nb], 1,
                            win[..., None].expand(-1, -1, a))
        out[:a, i:i + nb] = rows.permute(2, 0, 1)
        out[a, i:i + nb] = (pmin & ~idx_mask).view(torch.float32)
    return out


def _fixed_order_sum(x):
    """Sum over the last axis: 64 strided partial sums, then a halving
    tree over each 32, then the two halves in order."""
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


def _cholesky_solve_6x6(h, g):
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


def icp_point_to_plane(src_xyz, src_valid, tgt_packed, *, max_iterations,
                       max_correspondence, nn_every=2, damping=1e-4,
                       rotation_epsilon=2e-3, transformation_epsilon=5e-4,
                       stagnation_streak=8.0):
    """-> (delta [N, 4, 4] camera-frame correction, iterations [N],
    association sweeps [N])."""
    src = src_xyz.to(torch.float32)
    sadd = torch.where(src_valid, 0.0, float("inf")).to(torch.float32)
    tgt = tgt_packed.to(torch.float32)
    idx_mask = index_mask(tgt.shape[1])
    max_corr_sq = max_correspondence * max_correspondence
    rot_eps_sq = rotation_epsilon * rotation_epsilon
    trn_eps_sq = transformation_epsilon * transformation_epsilon
    n = src.shape[0]
    dev = src.device
    sx, sy, sz = src[..., 0], src[..., 1], src[..., 2]
    tx, ty, tz = tgt[..., 0], tgt[..., 1], tgt[..., 2]
    tab = torch.stack([-2.0 * tx, -2.0 * ty, -2.0 * tz,
                       tx * tx + ty * ty + tz * tz + tgt[..., 7]], dim=-1)
    attrs = tgt[..., 3:7].contiguous()
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    cur = [one, zero, zero, zero, one, zero, zero, zero, one, zero, zero, zero]
    best = list(cur)
    best_rmse = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    streak = zero
    done = zero
    iters = zero
    sweeps = zero
    assoc = None
    for k in range(max_iterations):
        active = done < 0.5
        due = nn_every <= 1 or k % nn_every == 0
        if due:
            sweeps = sweeps + active.to(torch.float32)
        r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2 = (
            c[:, None] for c in cur)
        cx = r00 * sx + r01 * sy + r02 * sz + t0
        cy = r10 * sx + r11 * sy + r12 * sz + t1
        cz = r20 * sx + r21 * sy + r22 * sz + t2
        if due:
            assoc = _associate(cx, cy, cz, tab, attrs, idx_mask)
        nx, ny, nz, nq, dmin = assoc[0], assoc[1], assoc[2], assoc[3], assoc[4]
        w = ((dmin + sadd) <= max_corr_sq).to(torch.float32)
        e = nx * cx + ny * cy + nz * cz - nq
        js = (cy * nz - cz * ny, cz * nx - cx * nz, cx * ny - cy * nx,
              nx, ny, nz)
        terms = [js[i] * js[j] * w for i in range(6) for j in range(i, 6)]
        terms += [js[i] * e * w for i in range(6)] + [w, e * e * w]
        sums = _fixed_order_sum(torch.stack(terms))
        h = [[None] * 6 for _ in range(6)]
        q = 0
        for i in range(6):
            for j in range(i, 6):
                h[i][j] = sums[q]
                q += 1
        g = [-sums[21 + i] for i in range(6)]
        count, res2 = sums[27], sums[28]

        ok = count >= 6.0
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
        xi = _cholesky_solve_6x6(h, g)

        wx, wy, wz = xi[0], xi[1], xi[2]
        theta2 = wx * wx + wy * wy + wz * wz
        theta = sqrt(torch.clamp(theta2, min=1e-24))
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
                raw[3 * i + j] = (ex[3 * i] * cur[j]
                                  + ex[3 * i + 1] * cur[3 + j]
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
    return out, iters, sweeps
