"""Plain reference of the grade stack with the Adjust node's spatial sliders
on: 3D LUT -> adjust (tone sliders, clarity, fine sharpen, fade, vignette)
-> colour match -> unsharp -> film grain, on one uint8 frame.

The LUT, the tone sliders' formulas, CIELAB, the unsharp mask and the
grain are :mod:`.grade`'s and :mod:`.common`'s.  The adjust stage follows
``VRGDG_LUTVideoTools.py:280-391`` (``_apply_adjust_tensor``) in its order,
on input clipped to [0, 1], with no clip between its steps:

1-5. temperature and tint, exposure, contrast, saturation, then highlights,
     shadows, whites and blacks on the Rec.709 luma taken after saturation;
6.   clarity ``c`` (``:359-368``), when ``|c| / 100 > 0.001``: ``k`` is the
     least of 9, the frame's height and its width, each made odd by taking
     1 off an even one, and clarity is skipped when ``k < 3``; ``blur`` is
     the ``k x k`` mean of the frame, reflect-padded by ``k // 2`` (the
     edge sample not repeated); ``midtone = 1 - clip(|luma - 0.5| / 0.5)``
     on the Rec.709 luma of the frame before the blur; the frame gains
     ``(x - blur) * c / 100 * 1.55 * (0.35 + 0.65 * midtone)``;
7.   fine sharpen ``s`` (``:370-373``), when ``s / 100 > 0.001``: ``blur``
     is the 3 x 3 mean of the frame, edge-padded by 1 (the edge sample
     repeated); the frame gains ``(x - blur) * s / 100 * 5.0``;
8-9. fade and the radial vignette, then the clip to [0, 1].

Departures from the pack: everything is computed in float64 (the pack
computes in float32), and each mean is taken as a mean along the rows and
then along the columns, which is the same number as the pack's ``k x k``
window summed in another order.  The reference imports nothing of the
program.  It runs no matrix product or convolution; TF32 is switched off
while it computes a frame all the same (and restored after, so the program
in the same process keeps its own setting), so none added later can run
in TF32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import common
from . import grade
from .grade import _TONE_SLIDERS, _luma, apply_lut


@contextlib.contextmanager
def _no_tf32():
    """Float32 matrix products and convolutions in IEEE float32 while the
    block runs (``allow_tf32`` False, or ``fp32_precision`` "ieee" in a
    process that used that newer switch), set back as they were after."""
    saved = []
    try:
        for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
            try:
                saved.append((flags, "allow_tf32", flags.allow_tf32))
                flags.allow_tf32 = False
            except RuntimeError:
                saved.append((flags, "fp32_precision", flags.fp32_precision))
                flags.fp32_precision = "ieee"
        yield
    finally:
        for flags, name, value in reversed(saved):
            setattr(flags, name, value)


def _tone(x: torch.Tensor, s: dict) -> torch.Tensor:
    """Steps 1-5 on ``x`` clipped to [0, 1]; the result is not clipped."""
    x = torch.clamp(x, 0.0, 1.0)
    if s["temperature"] or s["tint"]:
        t, ti = s["temperature"], s["tint"]
        offset = [t / 400.0 - ti / 900.0, ti / 450.0, -t / 400.0 - ti / 900.0]
        x = x + torch.tensor(offset, dtype=x.dtype, device=x.device)
    if s["exposure"]:
        x = x * 2.0 ** (s["exposure"] / 100.0)
    if s["contrast"]:
        x = (x - 0.5) * (1.0 + s["contrast"] / 100.0) + 0.5
    if s["saturation"]:
        gray = _luma(x)
        x = gray + (x - gray) * (1.0 + s["saturation"] / 100.0)
    luma = _luma(x)
    if s["highlights"]:
        x = x + torch.clamp((luma - 0.55) / 0.45, 0.0, 1.0) * (s["highlights"] / 220.0)
    if s["shadows"]:
        x = x + torch.clamp((0.45 - luma) / 0.45, 0.0, 1.0) * (s["shadows"] / 220.0)
    if s["whites"]:
        x = x + torch.clamp((luma - 0.75) / 0.25, 0.0, 1.0) * (s["whites"] / 240.0)
    if s["blacks"]:
        x = x + torch.clamp((0.25 - luma) / 0.25, 0.0, 1.0) * (s["blacks"] / 240.0)
    return x


def padded_positions(size: int, pad: int, mode: str, device) -> torch.Tensor:
    """The sample each position ``-pad .. size + pad - 1`` of an axis reads:
    "reflect" mirrors about the edge sample without repeating it, "edge"
    repeats the edge sample."""
    position = torch.arange(-pad, size + pad, device=device)
    if mode == "edge":
        return torch.clamp(position, 0, size - 1)
    position = torch.where(position < 0, -position, position)
    return torch.where(position > size - 1, 2 * (size - 1) - position,
                       position)


def box_mean(x: torch.Tensor, kernel: int, mode: str) -> torch.Tensor:
    """The ``kernel x kernel`` mean of each pixel's window of ``(H, W, 3)``
    ``x``, padded by ``kernel // 2`` on every side by ``mode``."""
    pad = kernel // 2
    height, width = x.shape[0], x.shape[1]
    rows = x[padded_positions(height, pad, mode, x.device)]
    x = sum(rows[i:i + height] for i in range(kernel)) / kernel
    columns = x[:, padded_positions(width, pad, mode, x.device)]
    return sum(columns[:, i:i + width] for i in range(kernel)) / kernel


def clarity_kernel(height: int, width: int) -> int:
    return min(9, height - (1 - height % 2), width - (1 - width % 2))


def adjust(x: torch.Tensor, sliders: dict, distance: torch.Tensor
           ) -> torch.Tensor:
    """The Adjust node's stack, steps 1-9 (see the module's docstring)."""
    s = {name: float(sliders.get(name, 0.0))
         for name in (*_TONE_SLIDERS, "clarity", "sharpen")}
    x = _tone(x, s)
    clarity = s["clarity"] / 100.0
    kernel = clarity_kernel(x.shape[0], x.shape[1])
    if abs(clarity) > 0.001 and kernel >= 3:
        midtone = 1.0 - torch.clamp(torch.abs(_luma(x) - 0.5) / 0.5, 0.0, 1.0)
        detail = x - box_mean(x, kernel, "reflect")
        x = x + detail * clarity * 1.55 * (0.35 + 0.65 * midtone)
    sharpen = s["sharpen"] / 100.0
    if sharpen > 0.001:
        x = x + (x - box_mean(x, 3, "edge")) * sharpen * 5.0
    fade = s["fade"] / 100.0
    if fade > 0.0:
        x = x * (1.0 - fade * 0.35) + fade * 0.18
    vignette = s["vignette"] / 100.0
    if vignette > 0.0:
        x = x * (1.0 - torch.clamp((distance - 0.35) / 1.05, 0.0, 1.0)
                 * vignette * 0.75)
    return torch.clamp(x, 0.0, 1.0)


class Reference(grade.Reference):
    """The expected uint8 frames of one run's clips: in float64, or as the
    ``control`` spec of the configuration says (its ``dtype``)."""

    def frame(self, clip, index: int, frame_u8: np.ndarray) -> np.ndarray:
        with _no_tf32():
            return self._frame(clip, index, frame_u8)

    def _frame(self, clip, index: int, frame_u8: np.ndarray) -> np.ndarray:
        s = self.stack
        x = common.dequantize(frame_u8, self.device, self.dtype)
        x = apply_lut(x, self.table, *self.domain, s["lut_strength"])
        x = adjust(x, s.get("adjust") or {}, self.distance)
        lab = common.rgb_to_lab(x)
        mean, std = common.lab_mean_std(lab)
        ref_mean, ref_std = self.ref_stats[clip.reference]
        matched = (lab - mean) / std * ref_std + ref_mean
        strength = float(s["match_strength"])
        x = common.lab_to_rgb(strength * matched + (1.0 - strength) * lab)
        if float(s.get("sharpen_strength", 0.0)) > 0.0:
            x = common.unsharp_zero(x, float(s["sharpen_strength"]))
        if float(s.get("grain_intensity", 0.0)) > 0.0:
            noise = common.grain(x.shape[0], x.shape[1], int(s["seed"]),
                                 index, float(s["saturation_mix"]),
                                 self.device, self.dtype)
            x = torch.clamp(x + noise * float(s["grain_intensity"]), 0.0, 1.0)
        return common.quantize(x)
