"""Sharpening stencils: unsharp mask, Laplacian, Sobel.

Counterpart of :mod:`vrgdg_tpu.ops.sharpen`: each filter runs a 3x3
stencil over BHWC frames and adds ``strength * detail`` back, clamped to
[0,1].  ``border="zero"`` zero-pads, ``border="edge"`` replicates the edge.
The reference's quirks tied to the border stay tied to it: the Laplacian's
sign flips under the zero border, and Sobel adds 1e-6 inside its sqrt only
under the zero border.  The box blur always divides by 9.  Each filter
takes an optional :class:`~vrgdg_tpu_torch.ops.halo.RowWindow`, for a
height shard that carries one halo row from each neighbour.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .halo import RowWindow


def _pad_hw(frames: torch.Tensor, border: str,
            rows: RowWindow) -> torch.Tensor:
    """The rows of ``rows`` padded by one row and one column on each side;
    along the height only at the frame's true edges."""
    p = rows.pad(frames, 1, "edge" if border == "edge" else "zero")
    if border == "edge":
        w = frames.shape[2]
        cols = torch.arange(-1, w + 1, device=frames.device).clamp(0, w - 1)
        return p.index_select(2, cols)
    return F.pad(p, (0, 0, 1, 1))


def _window(frames: torch.Tensor, rows: RowWindow | None) -> RowWindow:
    return RowWindow.whole(frames.shape[1]) if rows is None else rows


def _shift(padded: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    return padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]


def box_blur_3x3(frames: torch.Tensor, border: str = "edge",
                 rows: RowWindow | None = None) -> torch.Tensor:
    """9-tap mean with the chosen border convention (always divides by 9)."""
    rows = _window(frames, rows)
    h, w = rows.count, frames.shape[2]
    p = _pad_hw(frames, border, rows)
    acc = sum(_shift(p, dy, dx, h, w)
              for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return acc / 9.0


def unsharp(frames: torch.Tensor, strength, border: str = "edge",
            rows: RowWindow | None = None) -> torch.Tensor:
    """``out = clamp(img + strength * (img - box3x3(img)))`` (strength 0-10)."""
    rows = _window(frames, rows)
    blur = box_blur_3x3(frames, border, rows)
    img = rows.own(frames)
    return torch.clamp(img + strength * (img - blur), 0.0, 1.0)


def laplacian_sharpen(frames: torch.Tensor, strength,
                      border: str = "edge",
                      rows: RowWindow | None = None) -> torch.Tensor:
    """4-neighbour Laplacian detail add (strength 0-2); the zero border
    takes ``4x - neighbours``, the edge border ``neighbours - 4x``."""
    rows = _window(frames, rows)
    h, w = rows.count, frames.shape[2]
    p = _pad_hw(frames, border, rows)
    img = rows.own(frames)
    neighbours = (_shift(p, 0, -1, h, w) + _shift(p, -1, 0, h, w)
                  + _shift(p, 1, 0, h, w) + _shift(p, 0, 1, h, w))
    lap = neighbours - 4.0 * img
    if border == "zero":
        lap = -lap
    return torch.clamp(img + strength * lap, 0.0, 1.0)


def sobel_sharpen(frames: torch.Tensor, strength,
                  border: str = "edge",
                  rows: RowWindow | None = None) -> torch.Tensor:
    """Sobel gradient-magnitude detail add (strength 0-2)."""
    rows = _window(frames, rows)
    h, w = rows.count, frames.shape[2]
    p = _pad_hw(frames, border, rows)
    gx = (-_shift(p, -1, -1, h, w) - 2.0 * _shift(p, 0, -1, h, w)
          - _shift(p, 1, -1, h, w)
          + _shift(p, -1, 1, h, w) + 2.0 * _shift(p, 0, 1, h, w)
          + _shift(p, 1, 1, h, w))
    gy = (-_shift(p, -1, -1, h, w) - 2.0 * _shift(p, -1, 0, h, w)
          - _shift(p, -1, 1, h, w)
          + _shift(p, 1, -1, h, w) + 2.0 * _shift(p, 1, 0, h, w)
          + _shift(p, 1, 1, h, w))
    eps = 1e-6 if border == "zero" else 0.0
    edges = torch.sqrt(gx * gx + gy * gy + eps)
    return torch.clamp(rows.own(frames) + strength * edges, 0.0, 1.0)
