"""On the card: a short run of each cell through the command the driver
runs, and its last line.  Skips where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import pbtiny
from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(pbtiny.SEED), "--seconds", "2", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")
