"""Trilinear 3D LUT application.

Counterpart of :mod:`vrgdg_tpu.ops.lut`: domain normalization with a 1e-6
span floor, lattice coordinates ``norm * (N-1)``, floor/ceil corner indices
(``hi = min(lo+1, N-1)``), eight corners from a table indexed
``[b, g, r]``, and a three-stage lerp over the blue, green, then red
fractions.  Strength 0-10 maps to a 0-1 source/graded blend; alpha
channels pass through.

Two implementations of the same math, bit-identical to each other:

- :func:`apply_lut` reads the eight corners from the raw ``(N^3, 3)``
  table;
- :func:`apply_lut_bundle` reads all eight in one row gather from the
  ``(N^3, 24)`` corner bundle (:func:`vrgdg_tpu_torch.core.cube.corner_bundle`).

:func:`lut_identity_error` runs a dense identity probe through
:func:`apply_lut` and returns its max abs error.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.cube import LutData


def _as_tensor(value, device, default: float) -> torch.Tensor:
    if value is None:
        return torch.full((3,), default, dtype=torch.float32, device=device)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def _coords(source: torch.Tensor, dmin, dmax, max_index: int):
    span = torch.clamp(dmax - dmin, min=1e-6)
    coords = torch.clamp((source - dmin) / span, 0.0, 1.0) * max_index
    lo = torch.floor(coords)
    frac = coords - lo
    return lo.to(torch.int64), frac


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``a * (1 - f) + b * f`` in float32 with the JAX package's CPU
    rounding: XLA fuses the sum into one multiply-add,
    ``fma(a, 1 - f, fl(b * f))``.  The product ``a * (1 - f)`` of two
    float32 values is exact in float64, so the float64 sum rounded to
    float32 is that multiply-add, but where the float64 rounding lands on
    a float32 halfway point (rare).  Each step is its own torch op, so a
    card gives the CPU's bits."""
    tail = (b * f).to(torch.float64)
    return (a.to(torch.float64) * (1.0 - f).to(torch.float64)
            + tail).to(torch.float32)


def _trilerp(corners, frac: torch.Tensor) -> torch.Tensor:
    """``corners[k]`` is the ``(..., 3)`` value at corner k in the order
    ``[c000, c100, c010, c110, c001, c101, c011, c111]`` (digits blue,
    green, red; 0 = lo, 1 = hi)."""
    fr, fg, fb = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    c00 = _lerp(corners[0], corners[1], fb)
    c01 = _lerp(corners[2], corners[3], fb)
    c10 = _lerp(corners[4], corners[5], fb)
    c11 = _lerp(corners[6], corners[7], fb)
    c0 = _lerp(c00, c01, fg)
    c1 = _lerp(c10, c11, fg)
    return torch.clamp(_lerp(c0, c1, fr), 0.0, 1.0)


def _finish(frames: torch.Tensor, source: torch.Tensor, graded: torch.Tensor,
            strength) -> torch.Tensor:
    # the blend factor is rounded to float32 before 1 - blend is taken,
    # as in the reference's eager path
    blend = torch.clamp(torch.tensor(float(strength), dtype=torch.float32,
                                     device=frames.device), 0.0, 10.0) / 10.0
    mixed = _lerp(source, graded, blend).to(frames.dtype)
    if frames.shape[-1] > 3:
        out = frames.clone()
        out[..., :3] = mixed
        return out
    return mixed


def apply_lut(frames: torch.Tensor, lut, domain_min=None, domain_max=None,
              strength: float = 10.0) -> torch.Tensor:
    """Apply a 3D LUT to a ``(..., C>=3)`` [0,1] tensor with trilinear
    interpolation and 0-10 strength blending."""
    device = frames.device
    if isinstance(lut, LutData):
        table = torch.as_tensor(lut.table, device=device)
        domain_min = lut.domain_min if domain_min is None else domain_min
        domain_max = lut.domain_max if domain_max is None else domain_max
    else:
        table = torch.as_tensor(lut, device=device)
    dmin = _as_tensor(domain_min, device, 0.0)
    dmax = _as_tensor(domain_max, device, 1.0)

    source = frames[..., :3].to(torch.float32)
    size = table.shape[0]
    lo, frac = _coords(source, dmin, dmax, size - 1)
    hi = torch.clamp(lo + 1, max=size - 1)
    flat = table.reshape(-1, 3).to(torch.float32)

    def corner(b, g, r):
        return flat[((b * size + g) * size + r)]

    r0, g0, b0 = lo[..., 0], lo[..., 1], lo[..., 2]
    r1, g1, b1 = hi[..., 0], hi[..., 1], hi[..., 2]
    corners = [corner(b0, g0, r0), corner(b1, g0, r0),
               corner(b0, g1, r0), corner(b1, g1, r0),
               corner(b0, g0, r1), corner(b1, g0, r1),
               corner(b0, g1, r1), corner(b1, g1, r1)]
    return _finish(frames, source, _trilerp(corners, frac), strength)


def apply_lut_bundle(frames: torch.Tensor, bundle: torch.Tensor,
                     domain_min=None, domain_max=None,
                     strength: float = 10.0) -> torch.Tensor:
    """Apply a 3D LUT via its ``(N^3, 24)`` corner bundle; bit-identical to
    :func:`apply_lut` for arbitrary inputs."""
    device = frames.device
    size = round(bundle.shape[0] ** (1.0 / 3.0))
    dmin = _as_tensor(domain_min, device, 0.0)
    dmax = _as_tensor(domain_max, device, 1.0)
    source = frames[..., :3].to(torch.float32)
    lo, frac = _coords(source, dmin, dmax, size - 1)
    cell = (lo[..., 2] * size + lo[..., 1]) * size + lo[..., 0]
    rows = bundle.to(torch.float32)[cell]                 # (..., 24)
    corners = [rows[..., 3 * k:3 * k + 3] for k in range(8)]
    return _finish(frames, source, _trilerp(corners, frac), strength)


def lut_identity_error(lut, size_probe: int = 64, device="cuda") -> float:
    """Max abs error of a LUT applied to a dense identity probe, a cheap
    property check that an identity lattice grades to identity.  The probe
    (``size_probe^3`` colours) runs through :func:`apply_lut` on
    ``device``."""
    axis = np.linspace(0.0, 1.0, size_probe, dtype=np.float32)
    rgb = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1)
    rgb = rgb.reshape(1, size_probe, size_probe * size_probe, 3)
    probe = torch.from_numpy(rgb).to(device)
    out = apply_lut(probe, lut)
    return float(torch.max(torch.abs(out - probe)))
