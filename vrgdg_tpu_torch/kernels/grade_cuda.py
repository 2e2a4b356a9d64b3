"""The fused grade stack's two hand-written CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of :func:`vrgdg_tpu.kernels.grade_pallas.fused_post_gather`
(``layout="flat"``).  The colour-match statistics force a full-frame
barrier, so the stack after the LUT runs as two kernels around it:

- **phase 1** (``grade_phase1`` in ``csrc/grade.cu``; replaces
  ``vrgdg_tpu/kernels/grade_pallas.py:297`` ``_phase1_rowmajor_kernel``):
  per pixel, the trilerp from the ``(N^3, 24)`` corner bundle, the strength
  blend, the elementwise adjust sliders, RGB -> LAB, and per-block float64
  sums of L, a, b and their squares;
- **the stats barrier** (:func:`stats_barrier`, torch ops on the device,
  no host sync): the block sums, reduced in a fixed order, become one
  affine LAB map per frame, ``lab' = A * lab + B``;
- **phase 2** (``grade_phase2``; replaces
  ``vrgdg_tpu/kernels/grade_pallas.py:453`` ``_phase2_flat_kernel``): the
  affine transfer, LAB -> RGB, the 3x3 zero-border unsharp and the Philox
  grain of :mod:`vrgdg_tpu_torch.ops.grain`.

Both kernels take and give BHWC float32 of any ``H x W``; none of the
TPU's tiling, padding or lane packing carries over, so nothing caps the
batch.  Each wrapper runs its plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises.  ``LAUNCHES`` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.colorspace import lab_to_rgb, rgb_to_lab
from ..core.params import AdjustSettings
from ..ops.adjust import apply_adjust
from ..ops.grain import grain_field
from ..ops.lut import _trilerp
from ..ops.sharpen import unsharp
from . import build

PHASE1_BLOCK = 256      # pixels per phase-1 block: one partials row each
LAUNCHES = {"grade_phase1": 0, "grade_phase2": 0}

# slider bits of csrc/grade.cu
_TEMP_TINT, _EXPOSURE, _CONTRAST, _SATURATION = 1, 2, 4, 8
_HIGHLIGHTS, _SHADOWS, _WHITES, _BLACKS = 16, 32, 64, 128
_FADE, _VIGNETTE, _ADJUST_ON = 256, 512, 1024


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    lib = build.load_library().lib
    if lib.vrgdg_phase1_block_size() != PHASE1_BLOCK:
        raise build.KernelBuildError(
            "csrc/grade.cu and grade_cuda.PHASE1_BLOCK disagree on the "
            "phase-1 block size")
    return lib


def _check_launch(lib, code: int, name: str) -> None:
    if code != 0:
        message = lib.vrgdg_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({message})")
    LAUNCHES[name] += 1


def _check_adjust(adjust: AdjustSettings | None) -> None:
    if adjust is not None and (abs(adjust.clarity) / 100.0 > 0.001
                               or adjust.sharpen / 100.0 > 0.001):
        raise ValueError("the fused phase 1 runs only the elementwise adjust "
                         "sliders; clarity and sharpen must be zero")


def _adjust_args(adjust: AdjustSettings | None):
    """Slider mask and values for ``csrc/grade.cu``, folded from Python
    doubles to float32 as :func:`vrgdg_tpu_torch.ops.adjust.apply_adjust`
    folds them."""
    params = build.AdjustParams()
    if adjust is None:
        return 0, params
    s = adjust
    flags = _ADJUST_ON
    if s.temperature != 0.0 or s.tint != 0.0:
        flags |= _TEMP_TINT
        params.offset[0] = s.temperature / 400.0 - s.tint / 900.0
        params.offset[1] = s.tint / 450.0
        params.offset[2] = -s.temperature / 400.0 - s.tint / 900.0
    if s.exposure != 0.0:
        flags |= _EXPOSURE
        params.exposure = 2.0 ** (s.exposure / 100.0)
    if s.contrast != 0.0:
        flags |= _CONTRAST
        params.contrast = 1.0 + s.contrast / 100.0
    if s.saturation != 0.0:
        flags |= _SATURATION
        params.saturation = 1.0 + s.saturation / 100.0
    for bit, name, divisor in ((_HIGHLIGHTS, "highlights", 220.0),
                               (_SHADOWS, "shadows", 220.0),
                               (_WHITES, "whites", 240.0),
                               (_BLACKS, "blacks", 240.0)):
        if getattr(s, name):
            flags |= bit
            setattr(params, name, getattr(s, name) / divisor)
    fade = s.fade / 100.0
    if fade > 0.0:
        flags |= _FADE
        params.fade_scale = 1.0 - fade * 0.35
        params.fade_lift = fade * 0.18
    vignette = s.vignette / 100.0
    if vignette > 0.0:
        flags |= _VIGNETTE
        params.vignette = vignette
    return flags, params


def _require(condition: bool, message: str) -> None:
    if not condition:
        raise ValueError(message)


def _check_cuda_f32(name: str, tensor: torch.Tensor, device) -> None:
    _require(tensor.device == device,
             f"{name} is on {tensor.device}, expected {device}")
    _require(tensor.dtype == torch.float32, f"{name} must be float32")
    _require(tensor.is_contiguous(), f"{name} must be contiguous")


def _lut_size(bundle: torch.Tensor) -> int:
    size = round(bundle.shape[0] ** (1.0 / 3.0))
    _require(bundle.ndim == 2 and bundle.shape[1] == 24
             and size ** 3 == bundle.shape[0],
             "bundle must be the (N^3, 24) corner bundle")
    return size


def _check_adjust_and_bhwc(src: torch.Tensor, adjust) -> None:
    _check_adjust(adjust)
    _require(src.ndim == 4 and src.shape[-1] == 3,
             f"expected a (B, H, W, 3) batch, got {tuple(src.shape)}")


# --------------------------------------------------------------------------
# phase 1: trilerp + blend + adjust + LAB + block partial sums
# --------------------------------------------------------------------------

def phase1_plain(src: torch.Tensor, bundle: torch.Tensor,
                 domain: torch.Tensor, *, blend: float,
                 adjust: AdjustSettings | None = None):
    """Plain version of ``grade_phase1``.

    ``src`` ``(B, H, W, 3)`` float32 in [0,1]; ``bundle`` ``(N^3, 24)``;
    ``domain`` ``(2, 3)`` rows ``[dmin, 1/span]``.  Returns LAB
    ``(B, H, W, 3)`` float32 and partials ``(B, ceil(H*W/256), 6)`` float64:
    per block of 256 consecutive pixels, the sums of L, a, b, L^2, a^2,
    b^2."""
    _check_adjust_and_bhwc(src, adjust)
    size = _lut_size(bundle)
    coords = torch.clamp((src - domain[0]) * domain[1], 0.0, 1.0) * (size - 1)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.to(torch.int64)
    rows = bundle[(lo[..., 2] * size + lo[..., 1]) * size + lo[..., 0]]
    graded = _trilerp([rows[..., 3 * k:3 * k + 3] for k in range(8)], frac)
    color = src * (1.0 - blend) + graded * blend
    if adjust is not None:
        color = apply_adjust(color, adjust)
    lab = rgb_to_lab(color)

    batch, height, width, _ = lab.shape
    pixels = height * width
    blocks = math.ceil(pixels / PHASE1_BLOCK)
    flat = F.pad(lab.reshape(batch, pixels, 3).double(),
                 (0, 0, 0, blocks * PHASE1_BLOCK - pixels))
    flat = flat.reshape(batch, blocks, PHASE1_BLOCK, 3)
    partials = torch.cat([flat.sum(2), (flat * flat).sum(2)], dim=-1)
    return lab, partials


def phase1(src: torch.Tensor, bundle: torch.Tensor, domain: torch.Tensor,
           *, blend: float, adjust: AdjustSettings | None = None):
    """``grade_phase1`` on CUDA tensors; :func:`phase1_plain` on CPU ones."""
    if src.device.type == "cpu":
        return phase1_plain(src, bundle, domain, blend=blend, adjust=adjust)
    _require(src.device.type == "cuda", f"no kernel for device {src.device}")
    _check_adjust_and_bhwc(src, adjust)
    for name, tensor in (("src", src), ("bundle", bundle),
                         ("domain", domain)):
        _check_cuda_f32(name, tensor, src.device)
    size = _lut_size(bundle)
    _require(tuple(domain.shape) == (2, 3), "domain must be (2, 3)")
    _require(bundle.data_ptr() % 16 == 0, "bundle must be 16-byte aligned")
    batch, height, width, _ = src.shape
    blocks = math.ceil(height * width / PHASE1_BLOCK)
    lab = torch.empty_like(src)
    partials = torch.empty((batch, blocks, 6), dtype=torch.float64,
                           device=src.device)
    flags, params = _adjust_args(adjust)
    lib = _library()
    code = lib.vrgdg_grade_phase1(
        src.device.index, src.data_ptr(), bundle.data_ptr(), size,
        domain.data_ptr(), blend, 1.0 - blend, flags, params, batch, height,
        width, lab.data_ptr(), partials.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    _check_launch(lib, code, "grade_phase1")
    return lab, partials


# --------------------------------------------------------------------------
# the stats barrier: block sums -> per-frame affine LAB transfer
# --------------------------------------------------------------------------

def stats_barrier(partials: torch.Tensor, pixels: int,
                  ref_mean: torch.Tensor, ref_std: torch.Tensor,
                  match_strength: float) -> torch.Tensor:
    """``(B, 6)`` float32 ``[A_L, A_a, A_b, B_L, B_a, B_b]``.

    Formulas of ``vrgdg_tpu/kernels/grade_pallas.py:771-781``:
    ``var = max(S2 - n mu^2, 0) / (n - 1)``, ``std = sqrt(var) + 1e-5``,
    ``A = s sigma_ref / sigma + (1 - s)``, ``B = s (mu_ref - mu sigma_ref /
    sigma)``, with ``n`` the real pixels of a frame.  Runs in float64 on
    the device (the block sums reduce in a fixed order, so reruns are
    bit-identical) and never syncs with the host."""
    sums = partials.sum(dim=1)
    n = float(pixels)
    mean = sums[:, 0:3] / n
    var = torch.clamp(sums[:, 3:6] - n * mean * mean, min=0.0) / (n - 1.0)
    std = torch.sqrt(var) + 1e-5
    rmean = ref_mean.reshape(-1, 3).to(torch.float64)
    rstd = ref_std.reshape(-1, 3).to(torch.float64)
    gain = rstd / std
    a_coef = match_strength * gain + (1.0 - match_strength)
    b_coef = match_strength * (rmean - mean * gain)
    return torch.cat([a_coef, b_coef], dim=1).to(torch.float32).contiguous()


# --------------------------------------------------------------------------
# phase 2: affine transfer -> RGB -> 3x3 zero-border unsharp -> grain
# --------------------------------------------------------------------------

def phase2_plain(lab: torch.Tensor, coeff: torch.Tensor, *,
                 sharpen_strength: float, grain_intensity: float,
                 saturation_mix: float, seed_base: int) -> torch.Tensor:
    """Plain version of ``grade_phase2``: ``(B, H, W, 3)`` LAB and ``(B, 6)``
    coefficients in, ``(B, H, W, 3)`` RGB out.  Grain for frame ``b`` is
    keyed on ``(seed_base + b) & 0x7FFFFFFF``."""
    batch, height, width, _ = lab.shape
    rgb = lab_to_rgb(lab * coeff[:, None, None, 0:3]
                     + coeff[:, None, None, 3:6])
    sharp = unsharp(rgb, sharpen_strength, "zero")
    if grain_intensity <= 0.0:
        return sharp
    grain = grain_field(torch.arange(batch), height, width, saturation_mix,
                        int(seed_base), lab.device)
    return torch.clamp(sharp + grain * grain_intensity, 0.0, 1.0)


def phase2(lab: torch.Tensor, coeff: torch.Tensor, *,
           sharpen_strength: float, grain_intensity: float,
           saturation_mix: float, seed_base: int) -> torch.Tensor:
    """``grade_phase2`` on CUDA tensors; :func:`phase2_plain` on CPU ones."""
    kwargs = dict(sharpen_strength=sharpen_strength,
                  grain_intensity=grain_intensity,
                  saturation_mix=saturation_mix, seed_base=seed_base)
    if lab.device.type == "cpu":
        return phase2_plain(lab, coeff, **kwargs)
    _require(lab.device.type == "cuda", f"no kernel for device {lab.device}")
    _require(lab.ndim == 4 and lab.shape[-1] == 3,
             f"expected a (B, H, W, 3) batch, got {tuple(lab.shape)}")
    _check_cuda_f32("lab", lab, lab.device)
    _check_cuda_f32("coeff", coeff, lab.device)
    batch, height, width, _ = lab.shape
    _require(tuple(coeff.shape) == (batch, 6), "coeff must be (B, 6)")
    out = torch.empty_like(lab)
    lib = _library()
    code = lib.vrgdg_grade_phase2(
        lab.device.index, lab.data_ptr(), coeff.data_ptr(), batch, height,
        width, sharpen_strength, grain_intensity, saturation_mix,
        1.0 - saturation_mix, int(seed_base) & 0xFFFFFFFF, out.data_ptr(),
        torch.cuda.current_stream(lab.device).cuda_stream)
    _check_launch(lib, code, "grade_phase2")
    return out


# --------------------------------------------------------------------------
# the whole post-LUT stack
# --------------------------------------------------------------------------

def lut_domain(domain_min: torch.Tensor,
               domain_max: torch.Tensor) -> torch.Tensor:
    """Phase 1's ``(2, 3)`` domain rows ``[dmin, 1/span]``, the span
    floored at 1e-6 as in ``vrgdg_tpu/kernels/grade_pallas.py:645``."""
    dmin = domain_min.to(torch.float32)
    inv_span = 1.0 / torch.clamp(domain_max.to(torch.float32) - dmin,
                                 min=1e-6)
    return torch.stack([dmin, inv_span]).contiguous()


def _post_gather(first, second, frames, bundle, domain_min, domain_max,
                 ref_mean, ref_std, seed_plus_start, *, blend,
                 match_strength, sharpen_strength, grain_intensity,
                 saturation_mix, adjust):
    _require(frames.ndim == 4 and frames.shape[-1] == 3,
             "the fused grade needs (B, H, W, 3) frames")
    src = frames.to(torch.float32).contiguous()
    lab, partials = first(src, bundle, lut_domain(domain_min, domain_max),
                          blend=blend, adjust=adjust)
    coeff = stats_barrier(partials, src.shape[1] * src.shape[2], ref_mean,
                          ref_std, match_strength)
    return second(lab, coeff, sharpen_strength=sharpen_strength,
                  grain_intensity=grain_intensity,
                  saturation_mix=saturation_mix, seed_base=seed_plus_start)


def fused_post_gather(frames, bundle, domain_min, domain_max, ref_mean,
                      ref_std, seed_plus_start: int, *, blend: float,
                      match_strength: float, sharpen_strength: float,
                      grain_intensity: float, saturation_mix: float,
                      adjust: AdjustSettings | None = None) -> torch.Tensor:
    """The post-LUT stack for a BHWC [0,1] batch: :func:`phase1`, the
    barrier, :func:`phase2`.  ``seed_plus_start`` is ``seed +
    frame_start`` of ``frames[0]``.  Returns BHWC float32."""
    return _post_gather(phase1, phase2, frames, bundle, domain_min,
                        domain_max, ref_mean, ref_std, seed_plus_start,
                        blend=blend, match_strength=match_strength,
                        sharpen_strength=sharpen_strength,
                        grain_intensity=grain_intensity,
                        saturation_mix=saturation_mix, adjust=adjust)


def fused_post_gather_plain(frames, bundle, domain_min, domain_max,
                            ref_mean, ref_std, seed_plus_start: int, *,
                            blend: float, match_strength: float,
                            sharpen_strength: float, grain_intensity: float,
                            saturation_mix: float,
                            adjust: AdjustSettings | None = None
                            ) -> torch.Tensor:
    """:func:`fused_post_gather` through the plain versions, on any device."""
    return _post_gather(phase1_plain, phase2_plain, frames, bundle,
                        domain_min, domain_max, ref_mean, ref_std,
                        seed_plus_start, blend=blend,
                        match_strength=match_strength,
                        sharpen_strength=sharpen_strength,
                        grain_intensity=grain_intensity,
                        saturation_mix=saturation_mix, adjust=adjust)
