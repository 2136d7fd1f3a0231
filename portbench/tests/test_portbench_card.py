"""One short run of each cell on the card (skips without a CUDA card):
the result line's keys, a correct run, every end-to-end metric reported."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", [
    w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"]])
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {
        m["name"] for m in harness.load_cell(cell).end_to_end}
    assert res["device"]["platform"] == "gpu"
