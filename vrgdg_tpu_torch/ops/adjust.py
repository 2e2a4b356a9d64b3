"""The 13-slider adjust stack.

Counterpart of :mod:`vrgdg_tpu.ops.adjust`, applied in the same fixed
order on clamped [0,1] BHWC frames:

1. temperature/tint RGB offset vector,
2. exposure ``x * 2^(e/100)``,
3. contrast ``(x - 0.5) * (1 + c/100) + 0.5``,
4. saturation via Rec.709-luma lerp,
5. highlights/shadows (luma masks over the 0.55/0.45 shoulders, /220) and
   whites/blacks (0.75/0.25 shoulders, /240),
6. clarity: 9-tap reflect-padded box-blur detail * 1.55 * midtone mask,
7. sharpen: 3-tap replicate-padded box-blur fine detail * 5.0,
8. fade ``x * (1 - f*0.35) + f*0.18``,
9. radial vignette ``1 - clamp((d - 0.35)/1.05) * v * 0.75``.

Each slider runs only when it is non-zero (fade and vignette only when
positive), exactly as in the JAX code.  :func:`adjust_stages` gives the
stack as stages with the halo rows each reads, for height-sharded frames
(:mod:`vrgdg_tpu_torch.parallel.spatial`).  :func:`apply_adjust` runs each
stage in a :func:`~vrgdg_tpu_torch.runtime.profiling.span`:
``grade.adjust.tone`` (steps 1-5), ``grade.adjust.clarity`` (counter
``kernel``, the blur's width), ``grade.adjust.sharpen`` and
``grade.adjust.finish`` (fade, vignette and the clamp), each counting the
batch's ``frames``.
"""

from __future__ import annotations

import torch

from ..core.colorspace import rec709_luma
from ..core.params import AdjustSettings
from ..runtime.profiling import span
from .halo import RowWindow, pad_index


def _pad_index(size: int, pad: int, mode: str, device) -> torch.Tensor:
    """Source indices of a 1-D pad: "reflect" (numpy/torch reflect, the
    edge sample not repeated) or "edge" (replicate)."""
    return pad_index(-pad, size + pad, size, mode, device)


def _box_blur(frames: torch.Tensor, kernel: int, pad_mode: str,
              rows: RowWindow | None = None) -> torch.Tensor:
    """Separable k x k mean filter, stride 1, with the given pad mode
    ("reflect" or "edge"), summed in the JAX code's order; over the rows
    of ``rows`` (the whole frame by default)."""
    pad = kernel // 2
    rows = RowWindow.whole(frames.shape[1]) if rows is None else rows
    h, w = rows.count, frames.shape[2]
    p = rows.pad(frames, pad, pad_mode)
    summed = sum(p[:, i:i + h] for i in range(kernel)) / kernel
    p = summed.index_select(2, _pad_index(w, pad, pad_mode, frames.device))
    return sum(p[:, :, i:i + w] for i in range(kernel)) / kernel


def _clarity_kernel(height: int, width: int, target: int = 9) -> int:
    """The reference's odd-kernel shrink for small frames."""
    return min(int(target),
               height if height % 2 else height - 1,
               width if width % 2 else width - 1)


def _tone(frames: torch.Tensor, s: AdjustSettings) -> torch.Tensor:
    """Steps 1-5: clamp, temperature/tint, exposure, contrast, saturation,
    highlights/shadows/whites/blacks; all per pixel."""
    out = torch.clamp(frames, 0.0, 1.0)
    if s.temperature != 0.0 or s.tint != 0.0:
        offset = torch.tensor(
            [s.temperature / 400.0 - s.tint / 900.0,
             s.tint / 450.0,
             -s.temperature / 400.0 - s.tint / 900.0],
            dtype=out.dtype, device=out.device)
        out = out + offset

    if s.exposure != 0.0:
        out = out * (2.0 ** (s.exposure / 100.0))
    if s.contrast != 0.0:
        out = (out - 0.5) * (1.0 + s.contrast / 100.0) + 0.5

    if s.saturation != 0.0:
        gray = rec709_luma(out)
        out = gray + (out - gray) * (1.0 + s.saturation / 100.0)

    if s.highlights or s.shadows or s.whites or s.blacks:
        luma = rec709_luma(out)
        if s.highlights:
            out = out + torch.clamp((luma - 0.55) / 0.45, 0.0, 1.0) * (s.highlights / 220.0)
        if s.shadows:
            out = out + torch.clamp((0.45 - luma) / 0.45, 0.0, 1.0) * (s.shadows / 220.0)
        if s.whites:
            out = out + torch.clamp((luma - 0.75) / 0.25, 0.0, 1.0) * (s.whites / 240.0)
        if s.blacks:
            out = out + torch.clamp((0.25 - luma) / 0.25, 0.0, 1.0) * (s.blacks / 240.0)
    return out


def _clarity(frames: torch.Tensor, clarity: float, kernel: int,
             rows: RowWindow) -> torch.Tensor:
    """Step 6: reflect-padded box-blur detail * 1.55 * midtone mask."""
    out = rows.own(frames)
    detail = out - _box_blur(frames, kernel, "reflect", rows)
    luma = rec709_luma(out)
    midtone = 1.0 - torch.clamp(torch.abs(luma - 0.5) / 0.5, 0.0, 1.0)
    return out + detail * clarity * 1.55 * (0.35 + midtone * 0.65)


def _fine_sharpen(frames: torch.Tensor, sharpen: float,
                  rows: RowWindow) -> torch.Tensor:
    """Step 7: 3-tap replicate-padded box-blur fine detail * 5.0."""
    out = rows.own(frames)
    fine = out - _box_blur(frames, 3, "edge", rows)
    return out + fine * sharpen * 5.0


def _fade_vignette(frames: torch.Tensor, s: AdjustSettings,
                   rows: RowWindow) -> torch.Tensor:
    """Steps 8-9 and the final clamp; the vignette's distance is taken
    from the centre of the whole frame."""
    out = frames
    fade = s.fade / 100.0
    if fade > 0.0:
        out = out * (1.0 - fade * 0.35) + fade * 0.18

    vignette = s.vignette / 100.0
    if vignette > 0.0:
        width = out.shape[2]
        yy = torch.linspace(-1.0, 1.0, rows.height, dtype=out.dtype,
                            device=out.device)
        yy = yy[rows.start:rows.start + rows.count].reshape(1, rows.count,
                                                            1, 1)
        xx = torch.linspace(-1.0, 1.0, width, dtype=out.dtype,
                            device=out.device).reshape(1, 1, width, 1)
        distance = torch.sqrt(xx * xx + yy * yy)
        mask = 1.0 - torch.clamp((distance - 0.35) / 1.05, 0.0, 1.0) * vignette * 0.75
        out = out * mask

    return torch.clamp(out, 0.0, 1.0)


def _named_stages(settings: AdjustSettings, height: int, width: int):
    """:func:`adjust_stages` with each stage's span name and counts:
    ``(name, counts, halo, stage)``."""
    s = settings
    if not s.enabled or s.is_identity:
        return [("finish", {}, 0,
                 lambda frames, rows: torch.clamp(frames, 0.0, 1.0))]
    stages = [("tone", {}, 0, lambda frames, rows: _tone(frames, s))]
    clarity = s.clarity / 100.0
    if abs(clarity) > 0.001:
        kernel = _clarity_kernel(height, width)
        if kernel >= 3:
            stages.append(("clarity", {"kernel": kernel}, kernel // 2,
                           lambda frames, rows: _clarity(
                               frames, clarity, kernel, rows)))
    sharpen = s.sharpen / 100.0
    if sharpen > 0.001:
        stages.append(("sharpen", {}, 1, lambda frames, rows: _fine_sharpen(
            frames, sharpen, rows)))
    stages.append(("finish", {}, 0,
                   lambda frames, rows: _fade_vignette(frames, s, rows)))
    return stages


def adjust_stages(settings: AdjustSettings, height: int, width: int):
    """The adjust stack as ``(halo, stage)`` pairs, in order, for frames
    ``height`` x ``width``.

    ``stage(frames, rows)`` returns the rows of ``rows`` (a
    :class:`~vrgdg_tpu_torch.ops.halo.RowWindow`) from a tensor that holds
    them plus ``halo`` more rows on each side where the frame has them:
    the clarity blur reads 4 (the kernel is sized from the whole frame),
    the sharpen slider 1, the rest 0.  :func:`apply_adjust` runs the stages
    on whole frames; a height-sharded grade exchanges ``halo`` rows between
    neighbours before each."""
    return [(halo, stage)
            for _, _, halo, stage in _named_stages(settings, height, width)]


def apply_adjust(frames: torch.Tensor, settings: AdjustSettings) -> torch.Tensor:
    """Apply the full adjust stack to a BHWC [0,1] batch, each stage in its
    span (see the module's docstring); on a CUDA batch a span that records
    also times its stage with a pair of CUDA events."""
    height, width = int(frames.shape[1]), int(frames.shape[2])
    rows = RowWindow.whole(height)
    count = int(frames.shape[0])
    out = frames
    for name, counts, _, stage in _named_stages(settings, height, width):
        with span("grade.adjust." + name, device=frames.device,
                  frames=count, **counts):
            out = stage(out, rows)
    return out
