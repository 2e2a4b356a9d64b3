"""The fused grade stack: LUT -> adjust -> color match -> sharpen -> grain.

Counterpart of :mod:`vrgdg_tpu.ops.grade`.  Two modes run the same math:

- ``fused_mode="eager"`` (the counterpart of ``"xla"``): the chain of torch
  ops in :mod:`vrgdg_tpu_torch.ops`, on any device;
- ``fused_mode="fused"`` (the counterpart of ``"pallas"``): the two
  hand-written CUDA kernels of :mod:`vrgdg_tpu_torch.kernels.grade_cuda`
  around the colour-match stats barrier.  On CUDA tensors it launches the
  kernels or raises; on CPU tensors it runs their plain versions.

In the eager mode the grain stage runs by ``grain_mode``:

- ``grain_mode="eager"`` (the counterpart of ``"threefry"``, the default):
  :func:`vrgdg_tpu_torch.ops.grain.film_grain` in torch ops;
- ``grain_mode="kernel"`` (the counterpart of ``"pallas"``): the standalone
  ``film_grain`` CUDA kernel of :mod:`vrgdg_tpu_torch.kernels.grain_cuda`
  on CUDA tensors, its plain version (the same ``film_grain``) on CPU ones.

The fused mode draws its grain inside phase 2 and ignores ``grain_mode``,
as the JAX package does.  Every path draws from the one Philox stream of
:mod:`vrgdg_tpu_torch.ops.grain`, so all of them agree with grain on.  The
frames' device decides where the work runs; operands are moved there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.cube import LutData, corner_bundle
from ..core.params import (AdjustSettings, ColorMatchParams, GrainParams,
                           LUTParams, SharpenParams)
from ..runtime.profiling import span
from .adjust import apply_adjust
from .color_match import lab_statistics, transfer_lab_statistics
from .grain import film_grain
from .lut import apply_lut, apply_lut_bundle
from .sharpen import laplacian_sharpen, sobel_sharpen, unsharp

_SHARPEN_FNS = {
    "unsharp": unsharp,
    "laplacian": laplacian_sharpen,
    "sobel": sobel_sharpen,
}
FUSED_MODES = ("eager", "fused")
GRAIN_MODES = ("eager", "kernel")

# Corner-bundle tables (~3.4 MB each for N=33) cached device-resident per
# (source table object, device).  Entries hold the source object itself:
# while an entry is alive its id() cannot be recycled by another table.
_BUNDLE_CACHE: dict[tuple[int, str], tuple[object, torch.Tensor]] = {}


def _bundle_for(lut, device) -> torch.Tensor:
    source = lut.table if isinstance(lut, LutData) else lut
    key = (id(source), str(torch.device(device)))
    entry = _BUNDLE_CACHE.get(key)
    if entry is not None and entry[0] is source:
        return entry[1]
    if len(_BUNDLE_CACHE) >= 8:
        _BUNDLE_CACHE.pop(next(iter(_BUNDLE_CACHE)))
    table = source.cpu().numpy() if isinstance(source, torch.Tensor) else source
    bundle = torch.from_numpy(corner_bundle(np.asarray(table, np.float32)))
    bundle = bundle.to(device)
    _BUNDLE_CACHE[key] = (source, bundle)
    return bundle


@dataclass(frozen=True)
class GradeConfig:
    """Which stages run and with what parameters; ``None`` disables a
    stage.  The LUT table and colour-match reference statistics are
    passed to :func:`grade` separately.

    ``lut_mode``: "bundle" (one ``(N^3, 24)`` corner-bundle row per pixel)
    or "reference" (eight corner reads from the raw table); bit-identical.
    ``fused_mode``: "eager" or "fused"; ``grain_mode``: "eager" or
    "kernel" (see the module docstring).  The fused mode needs LUT
    (bundle) + colour match + unsharp/zero, 3-channel frames, and adjust
    only with clarity and sharpen at zero.
    """

    lut: LUTParams | None = None
    adjust: AdjustSettings | None = None
    color_match: ColorMatchParams | None = None
    sharpen: SharpenParams | None = None
    grain: GrainParams | None = None
    lut_mode: str = "bundle"
    fused_mode: str = "eager"
    grain_mode: str = "eager"

    @property
    def any_enabled(self) -> bool:
        return any((self.lut, self.adjust, self.color_match,
                    self.sharpen, self.grain))


def _active_adjust(config: GradeConfig) -> AdjustSettings | None:
    """The adjust settings the fused phase 1 must apply, or None (a
    disabled or all-zero adjust stage is a no-op on [0,1] inputs)."""
    adjust = config.adjust
    if adjust is None or not adjust.enabled or adjust.is_identity:
        return None
    return adjust


def fused_supported(config: GradeConfig, frames: torch.Tensor) -> str:
    """Empty string when the fused mode can run, else why not.

    The JAX package's 16-frame cap is not carried over: it came from
    packing per-frame partial sums into TPU lanes, and the CUDA phase 1
    writes one partials row per (frame, block)."""
    if config.lut is None or config.lut_mode != "bundle":
        return "fused_mode='fused' needs the bundle LUT stage enabled"
    adjust = _active_adjust(config)
    if adjust is not None and (abs(adjust.clarity) > 0.1
                               or adjust.sharpen > 0.1):
        return ("fused_mode='fused' supports adjust only with the "
                "spatial sliders (clarity, sharpen) at zero")
    if config.color_match is None:
        return "fused_mode='fused' needs the color-match stage enabled"
    if (config.sharpen is None or config.sharpen.kind != "unsharp"
            or config.sharpen.border != "zero"):
        return "fused_mode='fused' needs sharpen kind='unsharp' border='zero'"
    if frames.ndim != 4 or frames.shape[-1] != 3:
        return "fused_mode='fused' needs (B, H, W, 3) frames"
    if frames.shape[1] < 1 or frames.shape[2] < 1:
        return "fused_mode='fused' needs positive frame dimensions"
    return ""


def _run_fused(frames, config: GradeConfig, table, dmin, dmax, ref_mean,
               ref_std, frame_start: int) -> torch.Tensor:
    from ..kernels.grade_cuda import fused_post_gather

    reason = fused_supported(config, frames)
    if reason:
        raise ValueError(reason)
    grain = config.grain if (config.grain is not None
                             and config.grain.intensity > 0) else None
    return fused_post_gather(
        frames, table, dmin, dmax, ref_mean, ref_std,
        (0 if grain is None else grain.seed) + int(frame_start),
        blend=min(max(float(config.lut.strength), 0.0), 10.0) / 10.0,
        match_strength=float(config.color_match.match_strength),
        sharpen_strength=float(config.sharpen.strength),
        grain_intensity=0.0 if grain is None else float(grain.intensity),
        saturation_mix=(0.5 if grain is None
                        else float(grain.saturation_mix)),
        adjust=_active_adjust(config))


def grade_prepared(frames: torch.Tensor, config: GradeConfig, table, dmin,
                   dmax, ref_mean, ref_std,
                   frame_start: int = 0) -> torch.Tensor:
    """Run the stack on operands already resolved by
    :func:`prepare_operands` (or :func:`from_reference`).

    In the eager mode each stage that runs is a
    :func:`~vrgdg_tpu_torch.runtime.profiling.span` (``grade.lut``,
    ``grade.adjust``, ``grade.match``, ``grade.sharpen``, ``grade.grain``)
    counting the batch's ``frames``, and ``grade.lut`` the lattice's
    ``lut_size``; on a CUDA device each also times the stage with a pair of
    CUDA events.  They record only while a profiler records."""
    # reject typos loudly: a silent fallback would hand someone measuring
    # the kernels the wrong numbers
    if config.fused_mode not in FUSED_MODES:
        raise ValueError(f"Unknown fused_mode {config.fused_mode!r}; "
                         "expected 'eager' or 'fused'.")
    if config.grain_mode not in GRAIN_MODES:
        raise ValueError(f"Unknown grain_mode {config.grain_mode!r}; "
                         "expected 'eager' or 'kernel'.")
    if config.fused_mode == "fused":
        return _run_fused(frames, config, table, dmin, dmax, ref_mean,
                          ref_std, frame_start)
    out = frames
    count = math.prod(frames.shape[:-3]) if frames.ndim > 3 else 1

    def stage(name, **counts):
        return span(name, device=frames.device, frames=count, **counts)

    if config.lut is not None:
        bundled = config.lut_mode == "bundle"
        with stage("grade.lut", lut_size=_lut_size(table, bundled)):
            fn = apply_lut_bundle if bundled else apply_lut
            out = fn(out, table, dmin, dmax, strength=config.lut.strength)
    if config.adjust is not None:
        with stage("grade.adjust"):
            out = apply_adjust(out, config.adjust)
    if config.color_match is not None:
        with stage("grade.match"):
            out = transfer_lab_statistics(out, ref_mean, ref_std,
                                          config.color_match.match_strength)
    if config.sharpen is not None and config.sharpen.strength > 0:
        with stage("grade.sharpen"):
            fn = _SHARPEN_FNS[config.sharpen.kind]
            out = fn(out, config.sharpen.strength, config.sharpen.border)
    if config.grain is not None and config.grain.intensity > 0:
        with stage("grade.grain"):
            if config.grain_mode == "kernel":
                from ..kernels.grain_cuda import film_grain_kernel as grain_fn
                # a grain-only stack passes frames as given
                out = out.contiguous()
            else:
                grain_fn = film_grain
            out = grain_fn(out, config.grain.intensity,
                           config.grain.saturation_mix, config.grain.seed,
                           frame_start=frame_start)
    return out


def _lut_size(table, bundled: bool) -> int:
    """The lattice's N of a corner bundle ``(N^3, 24)`` or a raw table."""
    return round(table.shape[0] ** (1.0 / 3.0)) if bundled else table.shape[0]


def grade(frames: torch.Tensor, config: GradeConfig, *, lut=None,
          reference=None, ref_stats=None, frame_start: int = 0) -> torch.Tensor:
    """Run the configured grade stack over a BHWC [0,1] batch on the
    frames' device.

    Args:
      frames: ``(B, H, W, C>=3)`` float32 batch.
      config: :class:`GradeConfig`.
      lut: :class:`~vrgdg_tpu_torch.core.cube.LutData` or ``(N,N,N,3)``
        table (required when ``config.lut`` is set).
      reference: reference image batch for color match; or pass
        precomputed ``ref_stats=(mean, std)`` from
        :func:`~vrgdg_tpu_torch.ops.color_match.lab_statistics`.
      frame_start: absolute index of ``frames[0]`` for seeded grain.
    """
    if not config.any_enabled:
        return frames
    operands = prepare_operands(config, lut=lut, reference=reference,
                                ref_stats=ref_stats, device=frames.device)
    return grade_prepared(frames, config, *operands, frame_start=frame_start)


def _f32(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(value, np.float32), device=device)


def prepare_operands(config: GradeConfig, *, lut=None, reference=None,
                     ref_stats=None, device):
    """Resolve the device tensors a config needs: the LUT table (the corner
    bundle in bundle mode) with its domain, and the colour-match reference
    statistics."""
    if config.lut is not None:
        if lut is None:
            raise ValueError("config.lut is set but no LUT was provided.")
        if isinstance(lut, LutData):
            dmin = _f32(lut.domain_min, device)
            dmax = _f32(lut.domain_max, device)
        else:
            dmin = torch.zeros(3, dtype=torch.float32, device=device)
            dmax = torch.ones(3, dtype=torch.float32, device=device)
        if config.lut_mode == "bundle":
            table = _bundle_for(lut, device)
        else:
            table = _f32(lut.table if isinstance(lut, LutData) else lut,
                         device)
    else:
        table = torch.zeros((2, 2, 2, 3), dtype=torch.float32, device=device)
        dmin = torch.zeros(3, dtype=torch.float32, device=device)
        dmax = torch.ones(3, dtype=torch.float32, device=device)

    if config.color_match is not None:
        if ref_stats is not None:
            ref_mean, ref_std = ref_stats
        elif reference is not None:
            ref_mean, ref_std = lab_statistics(_f32(reference, device))
        else:
            raise ValueError(
                "config.color_match is set but neither reference nor "
                "ref_stats was provided.")
        ref_mean, ref_std = _f32(ref_mean, device), _f32(ref_std, device)
    else:
        ref_mean = torch.zeros((1, 1, 1, 3), dtype=torch.float32,
                               device=device)
        ref_std = torch.ones((1, 1, 1, 3), dtype=torch.float32, device=device)
    return table, dmin, dmax, ref_mean, ref_std


def _port_params(value, cls):
    """A JAX-package parameter dataclass -> its twin here, by attribute
    access only (so nothing of ``vrgdg_tpu`` is imported)."""
    if value is None:
        return None
    names = [f for f in cls.__dataclass_fields__]
    return cls(**{name: getattr(value, name) for name in names})


def from_reference(config, *, lut_table, domain_min, domain_max, ref_mean,
                   ref_std, device):
    """Carry a ``vrgdg_tpu`` grade config and its operands across.

    ``config`` is a ``vrgdg_tpu.ops.grade.GradeConfig``, read by duck
    typing; the operands are numpy arrays as ``vrgdg_tpu``'s
    ``prepare_operands`` resolves them (``lut_table`` is the corner bundle
    in bundle mode; a raw ``(N,N,N,3)`` table is bundled here).  The fused
    mode ``"xla"`` maps to ``"eager"`` and ``"pallas"`` to ``"fused"``; the
    grain mode ``"threefry"`` maps to ``"eager"`` and ``"pallas"`` to
    ``"kernel"``.  Other values pass through, and :func:`grade_prepared`
    rejects them.  Returns ``(config, (table, dmin, dmax, ref_mean,
    ref_std))`` ready for :func:`grade_prepared`."""
    mode = {"xla": "eager", "pallas": "fused"}.get(config.fused_mode,
                                                   config.fused_mode)
    grain_mode = {"threefry": "eager", "pallas": "kernel"}.get(
        config.grain_mode, config.grain_mode)
    port = GradeConfig(
        lut=_port_params(config.lut, LUTParams),
        adjust=_port_params(config.adjust, AdjustSettings),
        color_match=_port_params(config.color_match, ColorMatchParams),
        sharpen=_port_params(config.sharpen, SharpenParams),
        grain=_port_params(config.grain, GrainParams),
        lut_mode=config.lut_mode, fused_mode=mode, grain_mode=grain_mode)
    table = np.asarray(lut_table, np.float32)
    if port.lut_mode == "bundle" and table.ndim == 4:
        table = corner_bundle(table)
    operands = (_f32(table, device), _f32(domain_min, device),
                _f32(domain_max, device), _f32(ref_mean, device),
                _f32(ref_std, device))
    return port, operands
