"""Compare renders: the five comparison modes as pixel math.

Counterpart of :mod:`vrgdg_tpu.ops.compare`, as torch ops on the inputs'
device.  The reference's compare nodes (``VRGDG_ImageCompareNode.py:11-34``,
``VRGDG_VideoCompareNode.py``) render ``side_by_side / slider / overlay /
difference / blink`` in a browser widget; here they are BHWC [0,1] math so
the CLI/API can write comparison media.

All functions take two BHWC [0,1] batches on one device; mismatched
inputs are letterbox-resized to A's geometry first via :func:`align_pair`.
"""

from __future__ import annotations

import torch

from .resize import resize_batch

MODES = ("side_by_side", "slider", "overlay", "difference", "blink")


def align_pair(a: torch.Tensor,
               b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Letterbox B onto A's geometry when sizes differ; RGB only."""
    a = a[..., :3]
    b = b[..., :3]
    if a.shape[1:3] != b.shape[1:3]:
        b = resize_batch(b, int(a.shape[2]), int(a.shape[1]),
                         "letterbox", "bicubic")
    count = min(a.shape[0], b.shape[0])
    return a[:count], b[:count]


def side_by_side(a: torch.Tensor, b: torch.Tensor,
                 separator: int = 2) -> torch.Tensor:
    """A | B horizontally with a white separator column."""
    a, b = align_pair(a, b)
    sep = torch.ones((a.shape[0], a.shape[1], max(0, int(separator)), 3),
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, sep, b], dim=2)


def slider(a: torch.Tensor, b: torch.Tensor, position: float = 0.5,
           seam: int = 2) -> torch.Tensor:
    """A left of the slider position, B right of it, with a white seam."""
    a, b = align_pair(a, b)
    width = a.shape[2]
    split = int(round(max(0.0, min(1.0, float(position))) * width))
    column = torch.arange(width, device=a.device)[None, None, :, None]
    out = torch.where(column < split, a, b)
    if int(seam) <= 0:
        return out
    half = int(seam) / 2.0
    on_seam = (column + 0.5 - split).abs() <= half
    return torch.where(on_seam, 1.0, out)


def overlay(a: torch.Tensor, b: torch.Tensor,
            opacity: float = 0.5) -> torch.Tensor:
    """B blended over A at ``opacity``."""
    a, b = align_pair(a, b)
    opacity = max(0.0, min(1.0, float(opacity)))
    return a * (1.0 - opacity) + b * opacity


def difference(a: torch.Tensor, b: torch.Tensor,
               gain: float = 1.0) -> torch.Tensor:
    """Amplified absolute difference: identical inputs render black."""
    a, b = align_pair(a, b)
    return torch.clamp((a - b).abs() * max(1.0, float(gain)), 0.0, 1.0)


def blink_period(fps: float, blink_speed: float) -> int:
    """Frames per blink toggle at ``blink_speed`` Hz (clamped 0.1..8.0,
    the widget's control range)."""
    speed = max(0.1, min(8.0, float(blink_speed)))
    return max(1, int(round(float(fps) / speed)))


def blink(a: torch.Tensor, b: torch.Tensor, fps: float = 24.0,
          blink_speed: float = 1.0, frame_start: int = 0) -> torch.Tensor:
    """Per-frame A/B alternation for a batch starting at absolute frame
    ``frame_start``, so batch boundaries do not show."""
    a, b = align_pair(a, b)
    period = blink_period(fps, blink_speed)
    index = int(frame_start) + torch.arange(a.shape[0], device=a.device)
    show_a = ((index // period) % 2 == 0)[:, None, None, None]
    return torch.where(show_a, a, b)


def render_compare(a: torch.Tensor, b: torch.Tensor, mode: str, *,
                   slider_position: float = 0.5, overlay_opacity: float = 0.5,
                   difference_gain: float = 1.0, fps: float = 24.0,
                   blink_speed: float = 1.0,
                   frame_start: int = 0) -> torch.Tensor:
    mode = str(mode or "slider").lower()
    if mode == "side_by_side":
        return side_by_side(a, b)
    if mode == "slider":
        return slider(a, b, slider_position)
    if mode == "overlay":
        return overlay(a, b, overlay_opacity)
    if mode == "difference":
        return difference(a, b, difference_gain)
    if mode == "blink":
        return blink(a, b, fps, blink_speed, frame_start)
    raise ValueError(f"Unknown compare mode '{mode}'. Use one of {MODES}.")
