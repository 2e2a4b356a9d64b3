"""The row-major transpose probe on the card.

    python -m vrgdg_tpu_torch.tools.probe_transpose

Counterpart of ``tools/probe_transpose.py``: the same seeded ``(4096, 24)``
float32 block (``np.random.default_rng(0)``, uniform in [-1, 1)) goes
through :func:`vrgdg_tpu_torch.kernels.probe_cuda.weighted_row_sum`, whose
kernel stages gather-native rows in shared memory and reads them back
transposed, one row per thread.  The result is reshaped into the TPU
probe's ``(blocks, 8, 128)`` output and held against the numpy oracle;
the run prints the max abs error and "probe OK", or exits non-zero.  It
needs a CUDA card: the point is the kernel, not its plain version.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels.probe_cuda import WIDTH, weighted_row_sum

SUB = 8              # 128-row groups per TPU probe block
BLOCKS = 4
BOUND = 1e-4


def probe_input() -> np.ndarray:
    rows = SUB * 128 * BLOCKS
    return np.random.default_rng(0).uniform(-1, 1, (rows, WIDTH)).astype(
        np.float32)


def oracle(g: np.ndarray) -> np.ndarray:
    want = (g * (np.arange(WIDTH, dtype=np.float32) + 1.0)).sum(axis=1)
    return want.reshape(-1, SUB, 128)


def run(device) -> float:
    """The probe's max abs error on ``device``."""
    g = probe_input()
    out = weighted_row_sum(torch.from_numpy(g).to(device))
    got = out.reshape(-1, SUB, 128).cpu().numpy()
    return float(np.max(np.abs(got - oracle(g))))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_transpose: no CUDA device (torch.cuda.is_available() "
              "is False); the probe runs its kernel on a card.",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    err = run(device)
    print(f"device={torch.cuda.get_device_name(device)} "
          f"max abs err: {err:.2e}")
    if not err < BOUND:
        print("row-major transpose probe diverged", file=sys.stderr)
        return 1
    print("probe OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
