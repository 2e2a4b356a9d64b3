"""The transpose probe's module (vrgdg_tpu_torch.kernels.probe_cuda) and
its tool against tools/probe_transpose.py.

The TPU probe's ``pallas_call`` has no interpret switch, so it cannot run
on the CPU; the plain ``weighted_row_sum`` is held against that probe's
own numpy oracle (tools/probe_transpose.py:62-63) on its own seeded input.
Bound: the probe's 1e-4 (sums of 24 terms of magnitude <= 24, taken in
another order than numpy's).  The kernel is held against the plain version
on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vrgdg_tpu_torch.kernels import build, probe_cuda
from vrgdg_tpu_torch.tools import probe_transpose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_plain_matches_the_tpu_probe_oracle():
    g = probe_transpose.probe_input()
    assert g.shape == (4096, 24) and g.dtype == np.float32
    # the TPU probe's input and oracle, as written there
    rng = np.random.default_rng(0)
    assert np.array_equal(g, rng.uniform(-1, 1, (4096, 24)).astype(np.float32))
    want = (g * (np.arange(24, dtype=np.float32) + 1.0)).sum(axis=1)
    want = want.reshape(4096 // (8 * 128), 8, 128)
    assert np.array_equal(probe_transpose.oracle(g), want)
    got = probe_cuda.weighted_row_sum(torch.from_numpy(g))
    got = got.reshape(-1, 8, 128).numpy()
    assert float(np.max(np.abs(got - want))) < 1e-4
    assert probe_transpose.run("cpu") < 1e-4


@pytest.mark.parametrize("rows", [1, 129, 1000])
def test_plain_on_ragged_row_counts(rows):
    g = np.random.default_rng(rows).uniform(-1, 1, (rows, 24)).astype(
        np.float32)
    build.reset_launch_counts()
    got = probe_cuda.weighted_row_sum(torch.from_numpy(g)).numpy()
    want = (g.astype(np.float64) * (np.arange(24) + 1.0)).sum(axis=1)
    assert got.shape == (rows,)
    assert float(np.max(np.abs(got - want))) < 1e-4
    assert build.LAUNCHES["weighted_row_sum"] == 0


def test_rejects_other_widths():
    with pytest.raises(ValueError, match=r"\(rows, 24\)"):
        probe_cuda.weighted_row_sum(torch.zeros((8, 23)))


def test_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    done = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.tools.probe_transpose"],
        capture_output=True, text=True, cwd=REPO, timeout=120, check=False,
        env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr and "probe OK" not in done.stdout
