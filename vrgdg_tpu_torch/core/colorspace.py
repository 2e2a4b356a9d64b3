"""Color-space primitives on torch tensors.

Counterpart of :mod:`vrgdg_tpu.core.colorspace`: the same D65 CIELAB
pipeline with kornia's truncated constants, the same Rec.709 luma.  All
functions take float32 tensors with RGB in the trailing axis, values in
[0, 1] (LAB in its natural L:[0,100], a/b:[-128,127] ranges), and are shape
polymorphic over leading axes.

The 3x3 colour-matrix products are written as explicit three-term linear
combinations (:func:`_matmul3`), never ``torch.matmul``: a matmul on the
card may run in TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import torch

# Rec.709 / sRGB luma coefficients.
LUMA_R = 0.2126
LUMA_G = 0.7152
LUMA_B = 0.0722

# sRGB D65 reference white.
_XYZ_WHITE = (0.95047, 1.0, 1.08883)

# Linear sRGB -> CIE XYZ (same matrix kornia uses for rgb_to_xyz).
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)

# CIE XYZ -> linear sRGB (inverse of the above).
_XYZ2RGB = (
    (3.2404813432005266, -1.5371515162713185, -0.4985363261688878),
    (-0.9692549499965682, 1.8759900014898907, 0.0415559265582928),
    (0.0556466391351772, -0.2040413383665112, 1.0573110696453443),
)

# CIELAB nonlinearity constants.
_LAB_EPS = 0.008856        # (6/29)^3
_LAB_KAPPA = 7.787         # (1/3) * (29/6)^2, kornia's truncated constant
_LAB_OFFSET = 4.0 / 29.0
_LAB_FT_CUT = 0.2068966    # 6/29, cube-root domain threshold


def rec709_luma(rgb: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Rec.709 luma of an ``(..., 3)`` RGB tensor."""
    luma = rgb[..., 0] * LUMA_R + rgb[..., 1] * LUMA_G + rgb[..., 2] * LUMA_B
    return luma[..., None] if keepdims else luma


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB electro-optical transfer: gamma-encoded -> linear light."""
    return torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4,
                       srgb / 12.92)


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Linear light -> gamma-encoded sRGB."""
    safe = torch.clamp(linear, min=0.0)
    return torch.where(linear > 0.0031308,
                       1.055 * safe ** (1.0 / 2.4) - 0.055,
                       12.92 * linear)


def _matmul3(rgb: torch.Tensor, m) -> torch.Tensor:
    c0, c1, c2 = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([c0 * row[0] + c1 * row[1] + c2 * row[2] for row in m],
                       dim=-1)


def rgb_to_xyz(linear_rgb: torch.Tensor) -> torch.Tensor:
    return _matmul3(linear_rgb, _RGB2XYZ)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _matmul3(xyz, _XYZ2RGB)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative float32 tensor.

    torch has no ``cbrt``; ``pow(x, 1/3)`` in float32 is up to an ulp off.
    The power is taken in float64 and rounded once, which is the correctly
    rounded cube root for all but a vanishing set of inputs.
    """
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


def lab_f(t: torch.Tensor) -> torch.Tensor:
    """The CIELAB cube-root spline ``f(t)``."""
    return torch.where(t > _LAB_EPS, cbrt(torch.clamp(t, min=0.0)),
                       _LAB_KAPPA * t + _LAB_OFFSET)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """Gamma-encoded sRGB in [0,1] -> CIELAB (L in [0,100], a/b signed):
    sRGB linearize -> XYZ -> D65 normalize -> cube-root spline -> Lab."""
    xyz = rgb_to_xyz(srgb_to_linear(rgb))
    white = torch.tensor(_XYZ_WHITE, dtype=rgb.dtype, device=rgb.device)
    ft = lab_f(xyz / white)
    fx, fy, fz = ft[..., 0], ft[..., 1], ft[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def lab_f_inverse(f: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`lab_f` (``f**3`` above the cut, linear below)."""
    return torch.where(f > _LAB_FT_CUT, f * f * f,
                       (f - _LAB_OFFSET) / _LAB_KAPPA)


def lab_to_rgb(lab: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """CIELAB -> gamma-encoded sRGB, mirroring kornia's ``lab_to_rgb``
    including its out-of-gamut handling (fz floor at 0, linear RGB floor at
    0, optional final clip)."""
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = lab[..., 1] / 500.0 + fy
    fz = torch.clamp(fy - lab[..., 2] / 200.0, min=0.0)
    t = lab_f_inverse(torch.stack([fx, fy, fz], dim=-1))
    xyz = t * torch.tensor(_XYZ_WHITE, dtype=lab.dtype, device=lab.device)
    rgb = linear_to_srgb(torch.clamp(xyz_to_rgb(xyz), min=0.0))
    if clip:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    return rgb
