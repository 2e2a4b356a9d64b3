"""On the card: each cell runs a short window correctly, and its control
comes out as not correct on the cell's own size.

``python3 -m pytest -m cuda perfbench/tests/test_perfbench_card.py``; each
test skips without a CUDA card (decided inside the test).
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import cells, readings
from perfbench.cells import ROOT

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    _need_card()
    out = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", name, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    _need_card()
    cell = cells.load_cell(name)
    line = readings.read_seed(cell, 2 ** 31 + 102, 4.0,
                              torch.device("cuda", 0), True)
    limits = cell.config["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
