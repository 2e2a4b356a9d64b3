"""Plain reference of the grade stack: 3D LUT -> adjust -> colour match ->
unsharp -> film grain, on one uint8 frame, as the pack's nodes describe it.

- LUT (``VRGDG_LUTVideoTools``): the ``.cube`` lattice indexed
  ``[blue, green, red]``; input mapped by the file's domain (span floored
  at 1e-6) onto ``[0, N - 1]``; trilinear weights of the eight corners
  around it (the upper corner held at ``N - 1``); clipped to [0, 1]; mixed
  with the input by ``strength / 10``.
- adjust (``VRGDG_IV_Adjustments``): the per-pixel sliders in their order
  on [0, 1]-clipped input, then fade and the radial vignette, clipped.
- colour match: CIELAB mean and std (``ddof=1``, plus 1e-5) of the frame
  and of the reference image; ``(lab - mean) / std * ref_std + ref_mean``
  mixed with ``lab`` by the strength; back to sRGB, clipped.
- unsharp mask, 3x3 window with a zero border; film grain (see
  :mod:`.common`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import common
from .cube import read_cube

_TONE_SLIDERS = ("temperature", "tint", "exposure", "contrast", "saturation",
                 "highlights", "shadows", "whites", "blacks", "fade",
                 "vignette")


def _luma(x: torch.Tensor) -> torch.Tensor:
    return (0.2126 * x[..., 0] + 0.7152 * x[..., 1]
            + 0.0722 * x[..., 2])[..., None]


def apply_lut(x: torch.Tensor, table: torch.Tensor, domain_min, domain_max,
              strength: float) -> torch.Tensor:
    size = table.shape[0]
    span = torch.clamp(domain_max - domain_min, min=1e-6)
    coords = torch.clamp((x - domain_min) / span, 0.0, 1.0) * (size - 1)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    flat = table.reshape(-1, 3)
    out = torch.zeros_like(x)
    for corner in range(8):
        pick = [(corner >> k) & 1 for k in range(3)]      # r, g, b
        index = [hi[..., k] if pick[k] else lo[..., k] for k in range(3)]
        weight = torch.ones_like(frac[..., 0])
        for k in range(3):
            weight = weight * (frac[..., k] if pick[k] else 1.0 - frac[..., k])
        row = (index[2] * size + index[1]) * size + index[0]
        out = out + weight[..., None] * flat[row]
    graded = torch.clamp(out, 0.0, 1.0)
    blend = min(max(float(strength), 0.0), 10.0) / 10.0
    return x * (1.0 - blend) + graded * blend


def vignette_distance(height: int, width: int, device, dtype) -> torch.Tensor:
    """Distance of each pixel from the centre, both axes spanning [-1, 1]."""
    yy = torch.linspace(-1.0, 1.0, height, dtype=torch.float64)[:, None]
    xx = torch.linspace(-1.0, 1.0, width, dtype=torch.float64)[None, :]
    return torch.sqrt(xx * xx + yy * yy)[..., None].to(device=device,
                                                      dtype=dtype)


def adjust(x: torch.Tensor, sliders: dict, distance: torch.Tensor
           ) -> torch.Tensor:
    s = {name: float(sliders.get(name, 0.0)) for name in _TONE_SLIDERS}
    if any(float(sliders.get(name, 0.0)) for name in ("clarity", "sharpen")):
        raise NotImplementedError("the reference has no spatial sliders")
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
    fade = s["fade"] / 100.0
    if fade > 0.0:
        x = x * (1.0 - fade * 0.35) + fade * 0.18
    vignette = s["vignette"] / 100.0
    if vignette > 0.0:
        x = x * (1.0 - torch.clamp((distance - 0.35) / 1.05, 0.0, 1.0)
                 * vignette * 0.75)
    return torch.clamp(x, 0.0, 1.0)


class Reference:
    """The expected uint8 frames of one run's clips: in float64, or as the
    ``control`` spec of the configuration says (its ``dtype``)."""

    def __init__(self, config: dict, inputs, root: str, device,
                 control: dict | None = None):
        dtype = getattr(torch, control["dtype"]) if control else torch.float64
        stack = config["stack"]
        if stack.get("sharpen_kind", "unsharp") != "unsharp" or \
                stack.get("sharpen_border", "zero") != "zero":
            raise NotImplementedError("the reference sharpens by unsharp "
                                      "with a zero border only")
        self.stack, self.device, self.dtype = stack, device, dtype
        cube = read_cube(os.path.join(root, stack["lut"]))
        self.table = torch.from_numpy(cube.table).to(device=device,
                                                     dtype=dtype)
        self.domain = [torch.from_numpy(d).to(device=device, dtype=dtype)
                       for d in (cube.domain_min, cube.domain_max)]
        self.ref_stats = [common.lab_mean_std(common.rgb_to_lab(
            torch.from_numpy(image[0].astype(np.float64)).to(
                device=device, dtype=dtype)))
            for image in inputs.references]
        height, width = inputs.pool.shape[1:3]
        self.distance = vignette_distance(height, width, device, dtype)

    def frame(self, clip, index: int, frame_u8: np.ndarray) -> np.ndarray:
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
