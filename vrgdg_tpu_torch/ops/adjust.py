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
positive), exactly as in the JAX code.
"""

from __future__ import annotations

import torch

from ..core.colorspace import rec709_luma
from ..core.params import AdjustSettings


def _pad_index(size: int, pad: int, mode: str, device) -> torch.Tensor:
    """Source indices of a 1-D pad: "reflect" (numpy/torch reflect, the
    edge sample not repeated) or "edge" (replicate)."""
    index = torch.arange(-pad, size + pad, device=device)
    if mode == "reflect":
        index = index.abs()
        return torch.where(index >= size, 2 * (size - 1) - index, index)
    return index.clamp(0, size - 1)


def _box_blur(frames: torch.Tensor, kernel: int, pad_mode: str) -> torch.Tensor:
    """Separable k x k mean filter, stride 1, with the given pad mode
    ("reflect" or "edge"), summed in the JAX code's order."""
    pad = kernel // 2
    h, w = frames.shape[1], frames.shape[2]
    p = frames.index_select(1, _pad_index(h, pad, pad_mode, frames.device))
    rows = sum(p[:, i:i + h] for i in range(kernel)) / kernel
    p = rows.index_select(2, _pad_index(w, pad, pad_mode, frames.device))
    return sum(p[:, :, i:i + w] for i in range(kernel)) / kernel


def _clarity_kernel(height: int, width: int, target: int = 9) -> int:
    """The reference's odd-kernel shrink for small frames."""
    return min(int(target),
               height if height % 2 else height - 1,
               width if width % 2 else width - 1)


def apply_adjust(frames: torch.Tensor, settings: AdjustSettings) -> torch.Tensor:
    """Apply the full adjust stack to a BHWC [0,1] batch."""
    out = torch.clamp(frames, 0.0, 1.0)
    if not settings.enabled or settings.is_identity:
        return out

    s = settings
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

    clarity = s.clarity / 100.0
    sharpen = s.sharpen / 100.0
    height, width = int(frames.shape[1]), int(frames.shape[2])
    if abs(clarity) > 0.001:
        k = _clarity_kernel(height, width)
        if k >= 3:
            detail = out - _box_blur(out, k, "reflect")
            luma = rec709_luma(out)
            midtone = 1.0 - torch.clamp(torch.abs(luma - 0.5) / 0.5, 0.0, 1.0)
            out = out + detail * clarity * 1.55 * (0.35 + midtone * 0.65)
    if sharpen > 0.001:
        fine = out - _box_blur(out, 3, "edge")
        out = out + fine * sharpen * 5.0

    fade = s.fade / 100.0
    if fade > 0.0:
        out = out * (1.0 - fade * 0.35) + fade * 0.18

    vignette = s.vignette / 100.0
    if vignette > 0.0:
        yy = torch.linspace(-1.0, 1.0, height, dtype=out.dtype,
                            device=out.device).reshape(1, height, 1, 1)
        xx = torch.linspace(-1.0, 1.0, width, dtype=out.dtype,
                            device=out.device).reshape(1, 1, width, 1)
        distance = torch.sqrt(xx * xx + yy * yy)
        mask = 1.0 - torch.clamp((distance - 0.35) / 1.05, 0.0, 1.0) * vignette * 0.75
        out = out * mask

    return torch.clamp(out, 0.0, 1.0)
