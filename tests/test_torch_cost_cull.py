"""The depth-only cost kernel's cull (`csrc/cost_fused.cu`), emulated in
plain PyTorch, against its twin.

Per pose the kernel compacts the valid targets (tadd == 0) and, chunk by
chunk of CHUNK points, the valid points (cadd <= 0), both in ascending order;
it cuts each chunk's compacted points into groups of GROUP consecutive
points, takes each group's bounding box and keeps, per group, the targets
whose per-axis gap g to the box (g_a = max(lo_a - t_a, t_a - hi_a, 0)) has
g_x^2 + g_y^2 + g_z^2 <= res^2, in that float32 order and with no margin.
Each point then scans only its group's survivors in ascending index order
with a strict '<'. The emulation does the same in the same float32 order and
must give the twin's three counts exactly, on the bench's own cost inputs,
on adversarial poses (no valid target, no valid point, targets at exactly res
and one ulp either side along an axis and a diagonal, exact ties, P and S not
multiples of 32, N = 1) and at a P of several chunks. The cull must also be
conservative pair by pair: every (point, target) pair whose kernel distance
is <= res^2 survives its group's test.
"""

import numpy as np
import pytest
import torch

from perception_tpu_torch.eval.bench_scene import build_bench_problem
from perception_tpu_torch.ops import cost
from perception_tpu_torch.ops import cost_fused as cf

GROUP = 16                 # csrc/cost_fused.cu kGroup
CHUNK = 2048               # csrc/cost_fused.cu kChunk, at S = 256
RES = 0.01                 # the bench's sensor_resolution


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bench_inputs():
    """The prepared inputs the depth ROI scoring batch hands the cost kernel
    (bumpy models at 256 triangles, 48 poses, CPU)."""
    bp = build_bench_problem(n_poses=48, t_cap=256, model_kind="bumpy1024",
                             device="cpu")
    args, kwargs = bp.first_call(cost, "nn_cost_fused")
    return cf.prepare_inputs(*args, **kwargs)


def _large_inputs(bench_inputs):
    """Two bench poses with P = 15000 points (7.3 chunks): each pose's cloud
    repeated, each copy shifted by a few mm along x, then cut."""
    (cloud, cadd, tgt4), kw = bench_inputs
    pick = torch.nonzero((cadd <= 0).any(dim=1)
                         & (tgt4[..., 3] == 0).any(dim=1)).flatten()[:2]
    reps = 12
    shift = torch.zeros((reps, 1, 3))
    shift[:, 0, 0] = torch.arange(reps) * 0.003
    big = (cloud[pick, None] + shift).reshape(2, -1, 3)[:, :15000]
    flags = cadd[pick].repeat(1, reps)[:, :15000]
    return (big.contiguous(), flags.contiguous(), tgt4[pick]), kw


def _edge_inputs():
    """Adversarial poses, as prepared kernel inputs (cloud, cadd, tgt4) and
    max_dist_sq, for one (N, P, S) shape."""
    rng = np.random.default_rng(3)
    n, p, s = 6, 77, 45
    cloud = rng.normal(0.0, 0.02, (n, p, 3)).astype(np.float32)
    cloud[..., 2] += 0.7
    tgt = rng.normal(0.0, 0.02, (n, s, 3)).astype(np.float32)
    tgt[..., 2] += 0.7
    cvalid = rng.random((n, p)) > 0.4
    expl = rng.random((n, p)) > 0.7
    tvalid = rng.random((n, s)) > 0.2
    tvalid[0] = False                           # pose 0: no valid target
    cvalid[1] = False                           # pose 1: no valid point
    # Pose 2: targets at res, and one ulp either side, from valid points,
    # along x and along the diagonal.
    cvalid[2, :8] = True
    expl[2, :8] = False
    res32 = np.float32(RES)
    diag = np.float32(RES / np.sqrt(3.0))
    for k, (off, nudge) in enumerate(
            [(np.array([res32, 0, 0], np.float32), 0),
             (np.array([res32, 0, 0], np.float32), 1),
             (np.array([res32, 0, 0], np.float32), -1),
             (np.array([diag, diag, diag], np.float32), 0),
             (np.array([diag, diag, diag], np.float32), 1),
             (np.array([diag, diag, diag], np.float32), -1),
             (np.array([0, -res32, 0], np.float32), 0),
             (np.array([0, 0, res32], np.float32), 0)]):
        o = off.copy()
        for _ in range(abs(nudge)):
            o = np.nextafter(o, np.float32(np.sign(nudge)) * np.inf,
                             dtype=np.float32)
        tgt[2, 2 * k] = cloud[2, k] + o
        tgt[2, 2 * k + 1] = cloud[2, k] - o
        tvalid[2, 2 * k:2 * k + 2] = True
    # Pose 3: exact ties on a 2^-10 grid (every difference and square is
    # exact): duplicated targets, and two targets mirrored about a point.
    grid = np.float32(2.0 ** -10)
    cloud[3] = np.round(cloud[3] / grid) * grid
    tgt[3] = np.round(tgt[3] / grid) * grid
    tgt[3, 1::2] = tgt[3, 0:-1:2]
    tgt[3, 40] = cloud[3, 0] + np.float32([4 * grid, 0, 0])
    tgt[3, 41] = cloud[3, 0] - np.float32([4 * grid, 0, 0])
    tvalid[3, 40:42] = True
    cvalid[3, 0], expl[3, 0] = True, False
    # Pose 4: everything far apart (nothing close, nothing culled wrongly).
    tgt[4, :, 0] += 1.0
    t = lambda a: torch.as_tensor(a)
    return cf.prepare_inputs(t(cloud), t(cvalid), t(tgt), t(tvalid), RES,
                             t(cvalid & expl))


def _emulate(cloud, cadd, tgt4, max_dist_sq):
    """The kernel's cull and scan per pose: (counts [N, 3], survivors and
    close pairs, as (kept, dense, close-dropped) pair counts)."""
    out = torch.zeros((cloud.shape[0], 3), dtype=torch.float32)
    kept_pairs = dense_pairs = dropped_close = 0
    inf = float("inf")
    for i in range(cloud.shape[0]):
        tidx = torch.nonzero(tgt4[i, :, 3] == 0.0).flatten()
        vidx = torch.nonzero(cadd[i] <= 0.0).flatten()
        t, c = tgt4[i, tidx, :3], cloud[i, vidx]
        nv, nt = len(vidx), len(tidx)
        out[i, 0] = (cadd[i] == 0.0).sum()
        if nv == 0:
            continue
        # Groups of GROUP consecutive compacted points within a chunk of
        # CHUNK points, and their boxes (fminf / fmaxf: a NaN coordinate is
        # skipped).
        part = vidx // CHUNK
        rank = torch.arange(nv) - torch.searchsorted(vidx, part * CHUNK)
        gid = torch.unique(part * (CHUNK // GROUP) + rank // GROUP,
                           return_inverse=True)[1]
        n_groups = int(gid.max()) + 1
        index = gid[:, None].expand(-1, 3)
        lo = torch.full((n_groups, 3), inf).scatter_reduce(
            0, index, torch.where(torch.isnan(c), inf, c), "amin")
        hi = torch.full((n_groups, 3), -inf).scatter_reduce(
            0, index, torch.where(torch.isnan(c), -inf, c), "amax")
        g = torch.fmax(torch.fmax(lo[:, None] - t[None], t[None] - hi[:, None]),
                       torch.zeros(()))                            # [G, nt, 3]
        keep = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
                + g[..., 2] * g[..., 2]) <= max_dist_sq
        keep = keep[gid]                                           # [nv, nt]
        dx = t[None, :, 0] - c[:, None, 0]
        dy = t[None, :, 1] - c[:, None, 1]
        dz = t[None, :, 2] - c[:, None, 2]
        d = dx * dx + dy * dy + dz * dz                            # [nv, nt]
        dropped_close += int(((d <= max_dist_sq) & ~keep).sum())
        kept_pairs += int(keep.sum())
        dense_pairs += cloud.shape[1] * tgt4.shape[1]
        # Sequential strict '<' over the survivors in ascending order: the
        # lowest surviving index attaining the minimum; (inf, 0) if none
        # (a NaN distance never wins).
        ds = torch.where(keep & ~torch.isnan(d), d, inf)
        if nt:
            dmin = ds.amin(dim=1)
            first = torch.argmax((ds == dmin[:, None]).to(torch.int8), dim=1)
            win = torch.where(dmin < inf, tidx[first], 0)
        else:
            dmin = torch.full((nv,), inf)
            win = torch.zeros(nv, dtype=torch.long)
        real = cadd[i, vidx] == 0.0
        close = dmin <= max_dist_sq
        out[i, 1] = (real & ~close).sum()
        out[i, 2] = len(torch.unique(win[close]))
    return out, (kept_pairs, dense_pairs, dropped_close)


@pytest.mark.parametrize("case", ["bench", "edges", "edges N=1", "large P"])
def test_cost_cull_gives_the_twin_counts(case, bench_inputs):
    if case == "bench":
        args, kw = bench_inputs
    elif case == "large P":
        args, kw = _large_inputs(bench_inputs)
        # Beyond what staging every point at once would fit (S = 256).
        p, s = args[0].shape[1], args[2].shape[1]
        assert p > 7 * CHUNK and s * 17 + p * 16 > cf._MAX_SHARED
    else:
        args, kw = _edge_inputs()
        if case == "edges N=1":
            args = tuple(a[:1] for a in args)
    cloud, cadd, tgt4 = args
    twin = torch.stack(cf.nn_cost_fused_twin(*args, **kw), dim=1)
    got, (kept, dense, dropped) = _emulate(cloud, cadd, tgt4,
                                           kw["max_dist_sq"])
    torch.testing.assert_close(got, twin, rtol=0, atol=0)
    assert dropped == 0               # no close pair leaves its group
    if case == "edges":
        assert twin[0, 2] == 0 and twin[1, 0] == 0   # the empty poses
        assert twin[2, 2] > 0                        # boundary targets won
    elif case == "edges N=1":                        # no valid target
        assert twin[0, 2] == 0 and twin[0, 1] == twin[0, 0] > 0
    else:
        assert (twin[:, 2] > 0).any() and (twin[:, 1] > 0).any()
        # The cull does cull: most dense pairs are never scanned.
        assert kept < 0.15 * dense


def test_edge_cases_exercise_the_boundary():
    """The pose-2 targets straddle res^2 in the kernel's own arithmetic:
    some sit at or below it, some above."""
    (cloud, _, tgt4), kw = _edge_inputs()
    d = ((tgt4[2, :16, :3] - cloud[2, :8].repeat_interleave(2, dim=0)) ** 2)
    d = d[:, 0] + d[:, 1] + d[:, 2]
    assert (d <= kw["max_dist_sq"]).any() and (d > kw["max_dist_sq"]).any()
