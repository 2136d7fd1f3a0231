"""The GICP configuration's files (`ycbv6d-gicp-kinect`: its Kinect 6-DoF
scene kind, GICP reference and limits) found by name and driven through the
harness on the CPU at the tiny size: the program passes its limits, the
bfloat16 control, a GICP that leaves every pose where it was and a scorer
that leaves half of each batch out fail them; and the 1-NN's roofline share
never reads above 100%."""

import time

import numpy as np
import pytest
import torch

from portbench import calibrate, compare, harness, trace
from portbench.reference.scorer import Work
from portbench.scenes import frames
from portbench.tests.test_portbench_correct import _half_batch
from portbench.tests.tiny import tiny_cell

CELL = "ycbv6d-gicp-kinect.depth-robot"
SEED = 1017


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(details=None):
    cell = tiny_cell(CELL)
    return cell, harness.run_cell(
        cell, SEED, 0.0, False, time.perf_counter(), device="cpu",
        min_requests=cell.traffic["frames"], details=details)


@pytest.fixture(scope="module")
def sound_run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        details = {}
        cell, res = _run(details)
    finally:
        torch.set_num_threads(n)
    return cell, res, details


def test_the_cell_finds_its_files_and_the_program_passes(sound_run):
    cell, res, details = sound_run
    assert cell.config["name"] == "ycbv6d-gicp-kinect"
    assert cell.config["env"]["icp_mode"] == "gicp"
    assert cell.config["perch"]["max_icp_iterations"] == 150
    assert frames.kind(cell.config, cell.bench / "scenes")[0]
    assert type(harness.reference_for(cell, details["bank"], "cpu")
                ).__module__ == "portbench_reference_gicp"
    assert {m["name"] for m in cell.per_layer} >= {
        "scorer.icp_iters", "kernels.roofline.nn1"}
    assert {k: v["limit"] for k, v in res["checks"].items()} == (
        compare.limits("greedy", "ycbv6d-gicp-kinect"))
    assert res["correct"], res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0
    assert all(len(a.names) > 0 for a in details["answers"])
    # Every request refined by GICP: its loop iterations in the reply, the
    # reference's association work counted.
    counts = [r["stats"]["icp_iterations"] for r in details["replies"]]
    assert all(c > 0 for c in counts)
    run = type("R", (), {"served": [type("Q", (), {"reply": r})()
                                    for r in details["replies"]]})()
    assert harness.reader("scorer.icp_iters")(run) == sum(counts) / 2
    assert all(w.icp_pair_sweeps > 0 for w in _work(cell, details))


def _work(cell, details):
    ref = harness.reference_for(cell, details["bank"], "cpu")
    out = []
    for f in details["frames"]:
        ref.work = Work()
        ref.answer(f)
        out.append(ref.work)
    return out


def test_the_bfloat16_control_fails(sound_run):
    cell, _, details = sound_run
    numbers = calibrate.control_numbers(cell, details, "cpu")
    ok, _ = compare.verdict(numbers, compare.limits(
        cell.traffic["mode"], cell.config["name"]))
    assert not ok, numbers


def test_a_gicp_that_leaves_every_pose_unchanged_fails(monkeypatch):
    from perception_tpu_torch.ops.icp import ICPResult
    from perception_tpu_torch.pipeline import scorer

    def unchanged(src_xyz, *args, **kwargs):
        n = src_xyz.shape[0]
        zeros = torch.zeros((n,), device=src_xyz.device)
        return ICPResult(torch.eye(4).expand(n, 4, 4).clone(), zeros, zeros,
                         zeros.int(), 1)
    monkeypatch.setattr(scorer, "icp_gicp_batch", unchanged)
    _, res = _run()
    assert not res["correct"], res["checks"]


def test_half_of_each_batch_left_out_fails(monkeypatch):
    _half_batch(monkeypatch)
    _, res = _run()
    assert not res["correct"], res["checks"]


def _nn1_run(kernels, work):
    class R:
        trace = None
        served = []
    run = R()
    run.bench = harness.BENCH
    run.trace = trace.Trace(kernels=kernels, spans=[], window=(0.0, 1e9))
    run.work = [work]
    run.served = [type("Q", (), {"frame": 0})()]
    return run


@pytest.mark.parametrize("valid_share", [1.0, 0.6, 0.05])
def test_the_nn1_roofline_stays_at_or_below_100(valid_share):
    """A synthetic trace in which the 1-NN kernel takes the least time its
    dense sweep could take at the card's peak: the share, over the
    reference's valid pairs, is at most 100%; no kernel, no reading."""
    read = harness.reader("kernels.roofline.nn1")
    n, p, s, sweeps = 700, 256, 256, 150
    w = Work(icp_pair_sweeps=valid_share * n * p * s * sweeps,
             icp_bytes=n * (p * 3 + s * 4 + p * 2) * 4.0)
    dense_s = max(n * p * s * sweeps * 9 / 67e12, w.icp_bytes / 3.35e12)
    us = dense_s * 1e6
    kernels = [("void (anonymous namespace)::nn1_kernel(float const*)",
                1000.0, 1000.0 + us / 2),
               ("void (anonymous namespace)::nn1_kernel(float const*)",
                2000.0, 2000.0 + us / 2),
               ("icp_fused_kernel", 5000.0, 5001.0)]
    share = read(_nn1_run(kernels, w))
    assert share == pytest.approx(100.0 * valid_share)
    assert share <= 100.0 * (1 + 1e-12)     # float rounding of the sums
    assert read(_nn1_run(kernels[2:], w)) is None
    assert read(_nn1_run(kernels, Work())) is None


def test_the_iteration_reader_is_silent_without_counts():
    read = harness.reader("scorer.icp_iters")

    def run(*stats):
        return type("R", (), {"served": [type("Q", (), {"reply": {
            "stats": st}})() for st in stats]})()
    assert read(run({"expands": 0}, {"expands": 0})) is None
    assert read(run({"icp_iterations": 0})) is None
    assert read(run({"icp_iterations": 150}, {"icp_iterations": 300})) == 225
    assert np.isfinite(read(run({"icp_iterations": 7})))
