"""A configuration brings its own scene kind, reference and limits, each
as a new file found by name: no file of the harness changes. Driven through
the harness on the CPU at the tiny size, from a benchmark directory that
holds the new files alone beside the traffic and metrics."""

import json
import shutil
import time
from pathlib import Path

import torch

from portbench import harness
from portbench.scenes import frames
from portbench.tests.tiny import tiny

BENCH = Path(harness.__file__).resolve().parent

# A Kinect-degraded 6-DoF frame kind, as a later configuration would add it.
KINECT_6DOF = '''"""6-DoF frames under the Kinect model's depth noise."""
import numpy as np

from portbench.scenes import frames, sensor

SIX_DOF = True


def make(config, traffic, bank, seed, device):
    rng = np.random.default_rng([seed, 4])
    out = []
    for _ in range(traffic["frames"]):
        _, depth, label, trio = frames.place_6dof(config, bank, rng, device)
        depth = sensor.KINECT.apply_depth(depth, rng)
        out.append(frames.request_6dof(config, traffic["mode"],
                                       np.rint(depth * 1000.0), label, trio))
    return out
'''

# A reference that swaps the scorer alone: every refined pose 1 mm off.
SHIFTED = '''"""The plain reference with every refined pose moved 1 mm along the
camera's x axis."""
from portbench.reference import env, scorer


def shifted(*args, **kwargs):
    s = scorer.score_batch(*args, **kwargs)
    s.adjusted[:, 0, 3] += 1e-3
    return s


class Reference(env.Reference):
    score_batch = staticmethod(shifted)
'''


def test_a_configuration_brings_its_own_scene_reference_and_limits(
        tmp_path):
    bench = tmp_path / "portbench"
    for sub in ("traffic", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    for sub in ("configs", "scenes", "reference", "limits"):
        (bench / sub).mkdir()
    config = json.loads((BENCH / "configs" / "ycbv6d-p2p.json").read_text())
    config.update(name="ycbv6d-kinect", reference="shifted")
    config["scene"]["kind"] = "kinect6dof"
    (bench / "configs" / "ycbv6d-kinect.json").write_text(json.dumps(config))
    (bench / "scenes" / "kinect6dof.py").write_text(KINECT_6DOF)
    (bench / "reference" / "shifted.py").write_text(SHIFTED)
    own = {"failed": 0, "missing": 0, "pose_gap_mm": 0.1, "cost_gap": 3}
    (bench / "limits" / "ycbv6d-kinect.greedy.json").write_text(
        json.dumps(own))
    bm = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "ycbv6d-kinect", "source": "x",
                          "file": "portbench/configs/ycbv6d-kinect.json",
                          "reduced": [], "why": "x"})
    bm["workloads"].append({"name": "ycbv6d.kinect", "config": "ycbv6d-kinect",
                            "traffic": "depth-robot", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    cell = tiny(harness.load_cell("ycbv6d.kinect", tmp_path / "BENCHMARK.json",
                                  bench))
    assert cell.bench == bench
    details = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = harness.run_cell(cell, 1017, 0.0, False, time.perf_counter(),
                               device="cpu", min_requests=2, details=details)
    finally:
        torch.set_num_threads(n)

    # The scene kind's file made the frames.
    six_dof, make = frames.kind(cell.config, bench / "scenes")
    assert six_dof
    again = make(cell.config, cell.traffic, details["bank"], 1017, "cpu")
    assert ([frames.encode(f) for f in details["frames"]]
            == [frames.encode(f) for f in again])
    builtin = dict(cell.config, scene=dict(cell.config["scene"], kind="6dof"))
    assert ([frames.encode(f) for f in details["frames"]]
            != [frames.encode(f) for f in frames.make_frames(
                builtin, cell.traffic, details["bank"], 1017, "cpu")])
    # The configuration's own limits were read, and its shifted reference
    # sets every reply 1 mm off: not correct.
    assert {k: v["limit"] for k, v in res["checks"].items()} == own
    assert res["checks"]["missing"]["value"] == 0
    assert res["checks"]["pose_gap_mm"]["value"] > own["pose_gap_mm"]
    assert not res["correct"]
