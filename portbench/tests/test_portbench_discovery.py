"""A configuration, traffic mix or metric dropped into its folder, with its
entry in BENCHMARK.json, is found by name: no file of the harness changes."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    bm = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "ycbv6d-p2p.json").read_text())
    config["name"] = "ycbv6d-later"
    (bench / "configs" / "ycbv6d-later.json").write_text(json.dumps(config))
    (bench / "traffic" / "two-robots.json").write_text(json.dumps(
        {"name": "two-robots", "frames": 2, "mode": "greedy",
         "why": "a later mix"}))
    (bench / "metrics" / "later.count.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bm["configs"].append({"name": "ycbv6d-later", "source": "x",
                          "file": "portbench/configs/ycbv6d-later.json",
                          "reduced": [], "why": "x"})
    bm["workloads"].append({"name": "ycbv6d.later", "config": "ycbv6d-later",
                            "traffic": "two-robots", "chips": 1, "why": "x"})
    bm["per_layer"].append({"name": "later.count", "unit": "count",
                            "better": "higher", "source": "program_counter",
                            "layer": "HTTP service", "moves": "frame_ms",
                            "workloads": ["ycbv6d.later"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    cell = harness.load_cell("ycbv6d.later", tmp_path / "BENCHMARK.json",
                             bench)
    assert cell.config["name"] == "ycbv6d-later"
    assert cell.traffic["frames"] == 2
    assert "later.count" in [m["name"] for m in cell.per_layer]
    old = harness.load_cell("ycbv6d.depth-robot", tmp_path / "BENCHMARK.json",
                            bench)
    assert "later.count" not in [m["name"] for m in old.per_layer]
    read = harness.reader("later.count", bench)
    assert read(type("R", (), {"requests": [1, 2, 3]})()) == 3


def test_every_metric_entry_has_a_reader():
    bm = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
    for w in bm["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.traffic["name"] == w["traffic"]
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert cell.per_layer


@pytest.mark.parametrize("extra", [{"clients": 4}, {"loop": "open"},
                                   {"rate_per_s": 2.0}])
def test_a_traffic_key_the_harness_does_not_implement_is_refused(
        tmp_path, extra):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH / "traffic", bench / "traffic")
    traffic = json.loads((bench / "traffic" / "depth-robot.json").read_text())
    (bench / "traffic" / "depth-robot.json").write_text(
        json.dumps({**traffic, **extra}))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "portbench" / "configs").mkdir()
    shutil.copy(BENCH / "configs" / "ycbv6d-p2p.json",
                bench / "configs" / "ycbv6d-p2p.json")
    with pytest.raises(SystemExit, match=next(iter(extra))):
        harness.load_cell("ycbv6d.depth-robot", tmp_path / "BENCHMARK.json",
                          bench)


def test_the_tree_cell_reports_its_metrics():
    cell = harness.load_cell("table3dof.tree-robot")
    assert cell.config["name"] == "table3dof-roman"
    assert cell.traffic["mode"] == "tree"
    assert [m["name"] for m in cell.end_to_end] == [
        "frame_ms", "peak_mem_mb", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "service.frame_p90_ms", "service.decode_ms", "env.input_ms",
        "env.candidates_ms", "scorer.ms", "scorer.poses_per_s",
        "kernels.roofline.cost", "device.idle_share", "search.expands"]
