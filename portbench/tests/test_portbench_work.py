"""The roofline's work counts are chip_smoke.py's (`work()` and
`valid_work()`), and the reference's ICP and cost are the port's plain
twins, on a small random problem."""

import sys
from pathlib import Path

import pytest
import torch

from portbench import work
from portbench.reference import cost as ref_cost
from portbench.reference import icp as ref_icp
from portbench.reference.scorer import cost_work, icp_work

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def problem():
    g = torch.Generator().manual_seed(7)
    n, p, s = 6, 40, 24
    src = torch.rand((n, p, 3), generator=g) * 0.1 + torch.tensor(
        [0.0, 0.0, 0.6])
    src_valid = torch.rand((n, p), generator=g) < 0.8
    tgt = src[:, :s] + 0.004 * torch.randn((n, s, 3), generator=g)
    tgt_valid = torch.rand((n, s), generator=g) < 0.9
    nrm = torch.nn.functional.normalize(torch.randn((n, s, 3), generator=g),
                                        dim=-1)
    return src, src_valid, tgt, tgt_valid, nrm


def test_icp_counts_and_result_match_chip_smoke(problem):
    import chip_smoke
    from perception_tpu_torch.ops import icp_fused

    src, src_valid, tgt, tgt_valid, nrm = problem
    packed = icp_fused.pack_targets(tgt, tgt_valid, nrm)
    args, kw = icp_fused.prepare_inputs(src, src_valid, packed,
                                        max_iterations=20, nn_every=2)
    out, iters, sweeps = icp_fused.icp_fused_twin(*args, **kw,
                                                  return_counts=True)
    delta, r_iters, r_sweeps = ref_icp.icp_point_to_plane(
        src, src_valid, ref_icp.pack_targets(tgt, tgt_valid, nrm),
        max_iterations=20, max_correspondence=0.05, nn_every=2)
    assert torch.equal(delta, out)
    assert torch.equal(r_iters, iters) and torch.equal(r_sweeps, sweeps)
    w = icp_work(src, src_valid, packed, r_iters, r_sweeps)
    ops, _ = chip_smoke.valid_work("icp_fused", args, kw, (iters, sweeps))
    _, nbytes = chip_smoke.work("icp_fused", args, kw, out, (iters, sweeps))
    assert work.icp_ops(w) == ops
    assert w.icp_bytes == nbytes


def test_cost_counts_match_chip_smoke(problem):
    import chip_smoke
    from perception_tpu_torch.ops import cost_fused

    src, src_valid, tgt, tgt_valid, _ = problem
    args, kw = cost_fused.prepare_inputs(src, src_valid, tgt, tgt_valid,
                                         0.01)
    out = cost_fused.nn_cost_fused_twin(*args, **kw)
    costs = ref_cost.depth_cost(src, src_valid, None,
                                torch.zeros(src.shape[0], dtype=torch.int32),
                                tgt, tgt_valid, torch.full((6,), 30.0), 0.01)
    w = cost_work(src, src_valid, tgt, tgt_valid, costs.pairs)
    ops, _ = chip_smoke.valid_work("cost_fused", args, kw, None)
    _, nbytes = chip_smoke.work("cost_fused", args, kw, out, None)
    assert work.cost_ops(w) == ops
    assert w.cost_bytes == nbytes
    unexplained = out[1] / out[0] * 100.0
    assert torch.equal(costs.rendered, unexplained)


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
