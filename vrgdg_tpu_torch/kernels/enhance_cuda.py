"""The enhancer's whole-frame step on the card: the ``enhance_step`` CUDA
kernel and its wrapper.

``enhance_step`` (``csrc/enhance.cu``) replaces no Pallas kernel: it
computes, uint8 in and uint8 out, the chain that
:func:`vrgdg_tpu_torch.jobs.enhancer.submit_effects_batch` runs on a uint8
batch (``video_io.dequantize_on_device`` -> lanczos4 resample -> clamp ->
unsharp -> film grain -> ``video_io.quantize_on_device``), whose JAX
counterpart is left to XLA.  That chain, with ``film_grain_kernel`` for the
grain, is its plain version; the CPU, the float-output path and the
height-sharded mesh path run it.  The kernel sums each sample's nonzero
taps (:func:`tap_table`) where the chain multiplies by the dense matrices,
so a value may differ from the chain's by float32 rounding and a rare
uint8 value by one level.

:func:`enhance_step` launches the kernel on a CUDA uint8 batch or raises;
it has no CPU branch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.resize import _tap_plan
from . import build

TAPS = 8                        # a lanczos4 table row (csrc/enhance.cu)
RING_W = 64                     # ring columns a block
TILE_W = RING_W - 2             # output columns a block
TILE_HEIGHTS = (32, 16, 8, 4, 2, 1)
SMEM_BUDGET = 100 * 1024        # a block's shared memory, so two fit an SM
BORDERS = ("zero", "edge")


@functools.lru_cache(maxsize=64)
def tap_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """One axis's lanczos4 taps, ``(dst, 8)`` int32 source indices and
    float32 weights: :func:`~vrgdg_tpu_torch.ops.resize._tap_plan`'s, in
    ascending source order, each row padded to 8 taps of weight 0 on its
    last source index, so a row names no source index outside the span of
    its real taps."""
    idx, weights = _tap_plan(int(src), int(dst), "lanczos4")
    counts = np.maximum((weights != 0.0).sum(axis=1), 1)
    last = idx[np.arange(idx.shape[0]), counts - 1]
    idx = np.pad(idx, ((0, 0), (0, TAPS - idx.shape[1])))
    weights = np.pad(weights, ((0, 0), (0, TAPS - weights.shape[1])))
    pad = np.arange(TAPS)[None, :] >= counts[:, None]
    return np.where(pad, last[:, None], idx).astype(np.int32), weights


def windows(src: int, dst: int, tile: int) -> tuple[np.ndarray, int]:
    """For each block of ``tile`` outputs along one axis: the first source
    index the taps of its outputs and their one-pixel ring read, and the
    most source indices any block's taps span."""
    idx, _ = tap_table(src, dst)
    blocks = -(-int(dst) // int(tile))
    ring = np.clip(np.arange(blocks)[:, None] * tile
                   + np.arange(-1, tile + 1)[None, :], 0, int(dst) - 1)
    taps = idx[ring]
    lo = taps.min(axis=(1, 2))
    span = int((taps.max(axis=(1, 2)) - lo).max()) + 1
    return lo.astype(np.int32), span


def smem_bytes(window: int, span: int, tile_h: int) -> int:
    """A block's dynamic shared memory (``Layout`` in the source): the 256
    levels, the ring rows' taps and weights, the ring, the source window
    and the width pass."""
    return 4 * (256 + 2 * (tile_h + 2) * TAPS
                + ((tile_h + 2) * RING_W + window * (span + RING_W)) * 3)


@functools.lru_cache(maxsize=64)
def plan(src_h: int, src_w: int, dst_h: int,
         dst_w: int) -> tuple[int, int, int]:
    """``(tile_h, window, span)``: the tallest block whose shared memory
    fits :data:`SMEM_BUDGET`, its rows' source window and the columns'
    span; raises for a downscale so steep that not even a one-row block
    fits."""
    span = windows(src_w, dst_w, TILE_W)[1]
    for tile_h in TILE_HEIGHTS:
        window = windows(src_h, dst_h, tile_h)[1]
        if smem_bytes(window, span, tile_h) <= SMEM_BUDGET:
            return tile_h, window, span
    raise ValueError(f"a lanczos4 resample from {src_h}x{src_w} to "
                     f"{dst_h}x{dst_w} reads more source samples than a "
                     "block can hold")


@functools.lru_cache(maxsize=16)
def device_tables(src_h: int, src_w: int, dst_h: int, dst_w: int,
                  device: torch.device) -> dict:
    """The launch's tables on ``device``, uploaded once: the columns' and
    the rows' taps, the blocks' first source columns and rows, and the
    plan."""
    tile_h, window, span = plan(src_h, src_w, dst_h, dst_w)

    def upload(array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    col_idx, col_w = tap_table(src_w, dst_w)
    row_idx, row_w = tap_table(src_h, dst_h)
    return {"col_idx": upload(col_idx), "col_w": upload(col_w),
            "col_lo": upload(windows(src_w, dst_w, TILE_W)[0]),
            "row_idx": upload(row_idx), "row_w": upload(row_w),
            "row_lo": upload(windows(src_h, dst_h, tile_h)[0]),
            "tile_h": tile_h, "window": window, "span": span}


def enhance_step(frames: torch.Tensor, out_height: int, out_width: int, *,
                 sharpen_strength: float, border: str,
                 grain_intensity: float, saturation_mix: float, seed: int,
                 frame_start: int = 0) -> torch.Tensor:
    """The enhancer's step on a contiguous ``(B, H, W, 3)`` uint8 batch on
    the card; returns a new ``(B, out_height, out_width, 3)`` uint8
    tensor.

    ``sharpen_strength`` 0 leaves the unsharp out and ``grain_intensity`` 0
    the grain; ``border`` is the unsharp's (``"zero"`` or ``"edge"``); the
    grain is keyed on ``(seed + frame_start + b) & 0x7FFFFFFF`` and the
    pixel's index, as :func:`~vrgdg_tpu_torch.ops.grain.film_grain`."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {frames.dtype}")
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError("frames must be (B, H, W, 3), got "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    device = frames.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")
    batch, src_h, src_w, _ = frames.shape
    dst_h, dst_w = int(out_height), int(out_width)
    if min(src_h, src_w, dst_h, dst_w) < 1:
        raise ValueError(f"no resample from {src_h}x{src_w} to "
                         f"{dst_h}x{dst_w}")
    if dst_h * dst_w >= 2 ** 31:
        raise ValueError("an output frame must hold fewer than 2^31 pixels")
    out = torch.empty((batch, dst_h, dst_w, 3), dtype=torch.uint8,
                      device=device)
    if batch == 0:
        return out
    if batch > 65535:
        raise ValueError(f"at most 65535 frames a launch, got {batch}")
    tables = device_tables(src_h, src_w, dst_h, dst_w, device)
    lib = build.library("enhance")
    code = lib.vrgdg_enhance_step(
        device.index, frames.data_ptr(), batch, src_h, src_w,
        tables["col_idx"].data_ptr(), tables["col_w"].data_ptr(),
        tables["col_lo"].data_ptr(), tables["span"],
        tables["row_idx"].data_ptr(), tables["row_w"].data_ptr(),
        tables["row_lo"].data_ptr(), tables["window"], dst_h, dst_w,
        tables["tile_h"], int(border == "zero"), float(sharpen_strength),
        float(grain_intensity), float(saturation_mix),
        1.0 - float(saturation_mix),
        (int(seed) + int(frame_start)) & 0xFFFFFFFF, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, code, "enhance_step")
    return out
