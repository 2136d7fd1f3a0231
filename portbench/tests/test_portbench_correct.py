"""What decides `correct`, driven through the harness on the CPU at a tiny
size (the program on its PyTorch twins, the reference beside it): sound runs
pass, and the control and each fault of the timed path fail."""

import time

import numpy as np
import pytest
import torch

from portbench import calibrate, compare, harness
from portbench.tests.tiny import CELLS, tiny_cell


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, seed=1017, details=None):
    cell = tiny_cell(name)
    return cell, harness.run_cell(
        cell, seed, 0.0, False, time.perf_counter(), device="cpu",
        min_requests=cell.traffic["frames"], details=details)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_agrees_with_the_reference(name):
    details = {}
    _, res = _run(name, details=details)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0
    assert all(len(a.names) > 0 for a in details["answers"])
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_fails(name):
    details = {}
    cell, _ = _run(name, details=details)
    numbers = calibrate.control_numbers(cell, details, "cpu")
    ok, _ = compare.verdict(numbers, compare.limits(
        cell.traffic["mode"], cell.config["name"]))
    assert not ok, numbers


def _identity_icp(monkeypatch):
    from perception_tpu_torch.pipeline import scorer

    def unchanged(src_xyz, *args, **kwargs):
        n = src_xyz.shape[0]
        return torch.eye(4, device=src_xyz.device).expand(n, 4, 4).clone()
    monkeypatch.setattr(scorer, "icp_fused", unchanged)


def _search_step_unchanged(monkeypatch):
    from perception_tpu_torch.core.state import GraphState

    monkeypatch.setattr(GraphState, "append", lambda self, obj: self)


def _half_batch(monkeypatch):
    from perception_tpu_torch.pipeline.env import PerceptionEnv

    orig = PerceptionEnv.score_object_states

    def half(self, states, *args, **kwargs):
        return orig(self, list(states)[:max(1, len(states) // 2)], *args,
                    **kwargs)
    monkeypatch.setattr(PerceptionEnv, "score_object_states", half)


def _altered_answer(monkeypatch):
    from perception_tpu_torch.serve import LocalizerService

    orig = LocalizerService.handle

    def altered(self, payload, *args):
        out = orig(self, payload, *args)
        if out["detections"]:
            out["detections"][0]["translation"][0] += 1e-3
        return out
    monkeypatch.setattr(LocalizerService, "handle", altered)


FAULTS = {
    "ycbv6d.depth-robot": (_identity_icp, _half_batch, _altered_answer),
    "table3dof.greedyicp-robot": (_identity_icp, _half_batch,
                                  _altered_answer),
    "table3dof.tree-robot": (_search_step_unchanged, _half_batch,
                             _altered_answer),
}


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in range(3)])
def test_each_fault_of_the_timed_path_fails(name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    _, res = _run(name)
    assert not res["correct"], res["checks"]


def test_corner_gap_is_the_largest_per_axis_corner_displacement():
    from portbench.reference.geometry import Model

    verts = np.array([[[0, 0, 0], [0.1, 0, 0], [0, 0.2, 0.05]]], np.float32)
    corners = compare._corners(Model("m", verts, np.eye(4), True))
    a, b = np.eye(4), np.eye(4)
    b[0, 3] = 0.002
    assert compare.corner_gap_mm(a, b, corners) == pytest.approx(2.0)
    b = np.eye(4)
    b[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]   # 90 degrees about z
    assert compare.corner_gap_mm(a, b, corners) == pytest.approx(300.0)
