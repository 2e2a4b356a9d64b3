"""Standalone film grain: the ``film_grain`` CUDA kernel and its wrapper.

Counterpart of :mod:`vrgdg_tpu.kernels.grain_pallas` (``film_grain`` in
``csrc/grain.cu`` replaces ``vrgdg_tpu/kernels/grain_pallas.py:52``
``_grain_kernel``).  The kernel draws from the port's one Philox stream
(:mod:`vrgdg_tpu_torch.ops.grain`), so its plain version is
:func:`vrgdg_tpu_torch.ops.grain.film_grain` itself and the two agree value
for value; the TPU kernel's hardware generator, its 16-row tiles and its
128-pixel padding do not carry over.  On CPU tensors the wrapper runs the
plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.grain import check_rows, film_grain
from . import build


def film_grain_kernel(frames: torch.Tensor, intensity, saturation_mix, seed,
                      frame_start: int = 0, row_start: int = 0,
                      frame_height: int | None = None) -> torch.Tensor:
    """Seeded film grain on a ``(B, H, W, C>=3)`` float32 [0,1] batch;
    returns a new tensor.

    Same contract as :func:`~vrgdg_tpu_torch.ops.grain.film_grain`: noise
    keyed on ``(seed + frame_start + b) & 0x7FFFFFFF`` and the pixel's
    index ``y * W + x`` in the whole frame, where ``frames`` holds rows
    ``[row_start, row_start + H)`` of frames ``frame_height`` rows tall (a
    height shard; the whole frame by default); channels past the third
    copied unchanged, ``clip(x)`` at intensity 0."""
    if frames.ndim != 4 or frames.shape[-1] < 3:
        raise ValueError("film_grain_kernel needs (B, H, W, C>=3) frames, "
                         f"got {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        return film_grain(frames, intensity, saturation_mix, seed,
                          frame_start=frame_start, row_start=row_start,
                          frame_height=frame_height)
    device = frames.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError("frames must be contiguous float32")
    batch, height, width, channels = frames.shape
    frame_height = check_rows(row_start, height, frame_height)
    if frame_height * width >= 2 ** 31:
        raise ValueError("a frame must hold fewer than 2^31 pixels")
    out = torch.empty_like(frames)
    if out.numel() == 0:
        return out
    lib = build.library("grain")
    code = lib.vrgdg_film_grain(
        device.index, frames.data_ptr(), batch, height, width, channels,
        int(row_start), frame_height, float(intensity),
        float(saturation_mix), 1.0 - float(saturation_mix),
        (int(seed) + int(frame_start)) & 0xFFFFFFFF, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, code, "film_grain")
    return out
