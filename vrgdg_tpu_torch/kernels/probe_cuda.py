"""The transpose probe: the ``weighted_row_sum`` CUDA kernel, its wrapper
and its plain version.

Counterpart of the kernel of ``tools/probe_transpose.py`` (``main.kernel``,
``:34``): per row of a ``(rows, 24)`` float32 block in the gather's native
row-major layout, ``sum_k (k + 1) * g[r, k]``.  The CUDA kernel
(``csrc/probe.cu``) stages 128 rows per block in shared memory with
coalesced 16-byte loads and reads them back transposed, one row per
thread: the Hopper form of the question the TPU probe asked.  On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build

WIDTH = 24


def weighted_row_sum_plain(g: torch.Tensor) -> torch.Tensor:
    """``(rows,)`` float32: ``sum_k (k + 1) * g[:, k]``, summed over ``k``
    in order with a rounding after each multiply and each add, as the
    kernel and the TPU probe sum the corner planes."""
    _check(g)
    acc = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
    for k in range(WIDTH):
        acc = acc + g[:, k] * float(k + 1)
    return acc


def weighted_row_sum(g: torch.Tensor) -> torch.Tensor:
    """``weighted_row_sum`` on CUDA tensors; the plain version on CPU
    ones."""
    if g.device.type == "cpu":
        return weighted_row_sum_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    _check(g)
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous float32")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")
    out = torch.empty(g.shape[0], dtype=torch.float32, device=g.device)
    lib = build.library("probe")
    code = lib.vrgdg_weighted_row_sum(
        g.device.index, g.data_ptr(), g.shape[0], out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    build.check_launch(lib, code, "weighted_row_sum")
    return out


def _check(g: torch.Tensor) -> None:
    if g.ndim != 2 or g.shape[1] != WIDTH:
        raise ValueError(f"g must be (rows, {WIDTH}), got {tuple(g.shape)}")
