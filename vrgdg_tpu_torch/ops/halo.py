"""Height windows of a frame, for the stencils of a height shard.

A spatially sharded grade or enhance step
(:mod:`vrgdg_tpu_torch.parallel.spatial`) splits each frame by rows over
the devices of a space group.  A stencil's output rows then read input
rows that a neighbour owns (the halo), and its border padding applies only
at the frame's true top and bottom edges.  :class:`RowWindow` says which
frame rows a tensor holds and which rows of the output a stencil computes
from it; the stencils of :mod:`~vrgdg_tpu_torch.ops.adjust`,
:mod:`~vrgdg_tpu_torch.ops.sharpen` and the vignette take one.  On a whole
frame (:meth:`RowWindow.whole`) the padded rows are exactly what the
unsharded stencil reads, so its output is unchanged bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PAD_MODES = ("reflect", "edge", "zero")


def pad_index(start: int, stop: int, size: int, mode: str,
              device) -> torch.Tensor:
    """Source indices of the positions ``[start, stop)`` of a 1-D axis of
    ``size`` samples padded by ``mode``: "reflect" (numpy/torch reflect,
    the edge sample not repeated), "edge" (replicate) or "zero" (-1 for a
    position outside the axis)."""
    if mode not in PAD_MODES:
        raise ValueError(f"Unknown pad mode {mode!r}; expected one of "
                         f"{PAD_MODES}.")
    index = torch.arange(start, stop, device=device)
    if mode == "reflect":
        index = index.abs()
        return torch.where(index >= size, 2 * (size - 1) - index, index)
    if mode == "edge":
        return index.clamp(0, size - 1)
    return torch.where((index < 0) | (index >= size), -1, index)


@dataclass(frozen=True)
class RowWindow:
    """Output rows ``[start, start + count)`` of a frame ``height`` rows
    tall, computed from a BHWC tensor whose row 0 is frame row ``first``
    (a height shard with its halo rows)."""

    start: int
    count: int
    height: int
    first: int = 0

    @classmethod
    def whole(cls, height: int) -> "RowWindow":
        return cls(0, int(height), int(height))

    def own(self, frames: torch.Tensor) -> torch.Tensor:
        """The window's output rows of ``frames``."""
        offset = self.start - self.first
        return frames[:, offset:offset + self.count]

    def pad(self, frames: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
        """Frame rows ``[start - pad, start + count + pad)`` of ``frames``,
        padded by ``mode`` at the frame's top and bottom edges only: the
        rows a stencil of half-height ``pad`` reads for the window."""
        index = pad_index(self.start - pad, self.start + self.count + pad,
                          self.height, mode, frames.device)
        held = frames.shape[1]
        if mode == "zero":
            zero = frames.new_zeros((frames.shape[0], 1, *frames.shape[2:]))
            frames = torch.cat([frames, zero], dim=1)
            return frames.index_select(
                1, torch.where(index < 0, held, index - self.first))
        return frames.index_select(1, index - self.first)
