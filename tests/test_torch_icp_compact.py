"""The fused ICP kernel's compacted association and sum order
(`csrc/icp_fused.cu`), emulated in plain PyTorch, against its twin.

Per pose the kernel compacts the valid sources (sadd finite) and the valid
targets (tadd below the pack's invalid additive 1e30), both in ascending
order, and sweeps only valid x valid pairs. Its packed key
(bits(d) & ~mask) | j carries the compacted row j of the target, which
keeps the targets' order, so its min names the dense winner whenever the
pose has a valid target; the d2d modes read the winner's point back as
-0.5 * (-2t), which must be t exactly. Invalid
sources, and valid sources of a pose without a valid target, keep a
placeholder row (plane and point 0, distance +inf). Their weight is 0 either
way, so every term they add is a signed zero and the deltas do not change.
The emulation replaces the twin's dense `_associate` with the compacted
sweep and must give the same rows on every valid source and the same deltas,
bit for bit, in every mode, on the bench's own ICP inputs (the depth batch
scored in p2p and in the four modes of the real-sensor profile). The twin's
`_kernel_order_sum` is held against a direct emulation of the kernel's
order: two warps per pose, each thread adding its points in turn, the
shuffle tree per warp, then the warp sums in order.
"""

import dataclasses

import pytest
import torch

from perception_tpu_torch.eval.bench_scene import build_bench_problem
from perception_tpu_torch.ops import icp_fused as pfused
from perception_tpu_torch.pipeline import scorer

INF = float("inf")


# The scorer's ICP mode settings of each kernel mode (as chip_smoke.py
# scores the real-sensor batch).
MODE_CFG = {"p2p": dict(icp_mode="fused"),
            "d2d": dict(icp_mode="fused_d2d"),
            "sym": dict(icp_mode="fused_d2d", icp_d2d_symmetric=True),
            "exact": dict(icp_mode="fused_d2d_exact"),
            "adaptive": dict(icp_mode="fused_d2d", icp_nn_every=0)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def prepared():
    """Per mode, the kernel inputs the scoring batch hands the fused ICP
    (bumpy models at 256 triangles, 48 poses, CPU)."""
    bp = build_bench_problem(n_poses=48, t_cap=256, model_kind="bumpy1024",
                             device="cpu")
    out = {}
    for mode, change in MODE_CFG.items():
        args, kwargs = bp.first_call(scorer, "icp_fused",
                                     dataclasses.replace(bp.cfg, **change))
        out[mode] = pfused.prepare_inputs(*args, **kwargs)
        assert out[mode][1]["mode"] == ("d2d" if mode == "adaptive"
                                        else mode)
    return out


def _compact_associate(tgt, sadd):
    """The kernel's association as a drop-in for the twin's `_associate`:
    valid sources x valid targets only, the placeholder row elsewhere."""
    tvalid = tgt[..., 7] < 1e30
    svalid = sadd < INF

    def associate(cx, cy, cz, tab, attrs, idx_mask):
        n, p = cx.shape
        a = attrs.shape[-1]
        out = torch.zeros((a + 1, n, p), dtype=torch.float32)
        out[a] = INF
        for i in range(n):
            tv = torch.nonzero(tvalid[i]).flatten()
            sv = torch.nonzero(svalid[i]).flatten()
            if len(tv) == 0 or len(sv) == 0:
                continue
            x, y, z = cx[i, sv][None], cy[i, sv][None], cz[i, sv][None]
            t = tab[i, tv][:, :, None]                        # [nt, 4, 1]
            cc = x * x + y * y + z * z
            d = t[:, 3] + t[:, 0] * x + t[:, 1] * y + t[:, 2] * z
            d = torch.clamp(d + cc, min=0.0)                  # [nt, nv]
            rows = torch.arange(len(tv), dtype=torch.int32)[:, None]
            key = ((d.view(torch.int32) & ~idx_mask) | rows).amin(dim=0)
            out[:a, i, sv] = attrs[i, tv[(key & idx_mask).long()]].T
            out[a, i, sv] = (key & ~idx_mask).view(torch.float32)
        return out

    return associate


@pytest.mark.parametrize("mode", ["p2p", "exact"])
def test_compact_association_matches_dense(prepared, mode):
    """At the first sweep (identity) and at a moved estimate: the same row
    and quantised distance on every valid source of a pose with a valid
    target; weight 0 for every other source under both."""
    (src, _, sadd, tgt), kw = prepared[mode]
    d2d = mode != "p2p"
    tx, ty, tz = tgt[..., 0], tgt[..., 1], tgt[..., 2]
    tab = torch.stack([-2.0 * tx, -2.0 * ty, -2.0 * tz,
                       tx * tx + ty * ty + tz * tz + tgt[..., 7]], dim=-1)
    attrs = (tgt[..., [3, 4, 5, 6, 0, 1, 2]] if d2d
             else tgt[..., 3:7]).contiguous()
    compact = _compact_associate(tgt, sadd)
    assert torch.equal(-0.5 * (-2.0 * tgt[..., :3]), tgt[..., :3])
    has_target = (tgt[..., 7] < 1e30).any(dim=1)
    valid = (sadd < INF) & has_target[:, None]
    assert valid.any() and (~valid).any() and (~has_target).any()
    for shift in (0.0, 0.004):
        cx, cy, cz = src[..., 0] + shift, src[..., 1] - shift, src[..., 2]
        dense = pfused._associate(cx, cy, cz, tab, attrs, kw["idx_mask"])
        got = compact(cx, cy, cz, tab, attrs, kw["idx_mask"])
        assert torch.equal(got[:, valid], dense[:, valid])
        a = attrs.shape[-1]
        for rows in (got, dense):
            w = (rows[a] + sadd) <= kw["max_corr_sq"]
            assert not w[~valid].any()
        assert torch.equal(got[:, ~valid],
                           torch.where(torch.arange(a + 1)[:, None] == a,
                                       INF, 0.0).expand(-1, int((~valid).sum())))


@pytest.mark.parametrize("mode", ["p2p", "d2d", "sym", "exact", "adaptive"])
def test_compact_association_gives_the_twin_deltas(prepared, mode,
                                                   monkeypatch):
    pargs, pkw = prepared[mode]
    dense, iters, _ = pfused.icp_fused_twin(*pargs, **pkw, return_counts=True)
    assert iters.max() > 2 and (iters == 1).any()   # real work, empty poses
    monkeypatch.setattr(pfused, "_associate",
                        _compact_associate(pargs[3], pargs[2]))
    compact = pfused.icp_fused_twin(*pargs, **pkw)
    assert torch.equal(compact, dense)


def _thread_order_sum(x: torch.Tensor, threads: int) -> torch.Tensor:
    """The kernel's reduction of [..., P] written out thread by thread: each
    thread starts at +0 and adds p = tid, tid + threads, ...; each warp's
    lanes combine by shuffle-down at offsets 16, 8, 4, 2, 1; thread 0 adds
    the warp sums in order."""
    p = x.shape[-1]
    acc = [torch.zeros(x.shape[:-1]) for _ in range(threads)]
    for t in range(threads):
        for i in range(t, p, threads):
            acc[t] = acc[t] + x[..., i]
    warps = []
    for w in range(threads // 32):
        v = acc[32 * w:32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            v = [v[i] + v[i + off] if i + off < 32 else v[i]
                 for i in range(32)]
        warps.append(v[0])
    total = warps[0]
    for v in warps[1:]:
        total = total + v
    return total


@pytest.mark.parametrize("p", [256, 77, 300])
def test_kernel_order_sum_is_the_kernel_order(p):
    gen = torch.Generator().manual_seed(p)
    x = torch.randn((5, 3, p), generator=gen) * torch.logspace(
        -3, 3, p, dtype=torch.float32)
    want = _thread_order_sum(x, pfused._THREADS)
    assert torch.equal(pfused._kernel_order_sum(x), want)
    # The order matters at these magnitudes: a plain sum rounds otherwise.
    assert not torch.equal(x.sum(dim=-1), want)
