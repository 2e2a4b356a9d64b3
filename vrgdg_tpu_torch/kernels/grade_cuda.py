"""The fused grade stack's hand-written CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of :func:`vrgdg_tpu.kernels.grade_pallas.fused_post_gather`.
The colour-match statistics force a full-frame barrier, so the stack after
the LUT runs as two kernels around it:

- **phase 1** (``grade_phase1`` in ``csrc/grade.cu``; replaces
  ``vrgdg_tpu/kernels/grade_pallas.py:297`` ``_phase1_rowmajor_kernel``):
  per pixel, the trilerp from the ``(N^3, 24)`` corner bundle, the strength
  blend, the elementwise adjust sliders, RGB -> LAB, and per-chunk float64
  sums of L, a, b and their squares;
- **the stats barrier** (:func:`stats_barrier`, torch ops on the device,
  no host sync): the chunk sums, reduced in a fixed order, become one
  affine LAB map per frame, ``lab' = A * lab + B``;
- **phase 2** (``grade_phase2``; replaces
  ``vrgdg_tpu/kernels/grade_pallas.py:453`` ``_phase2_flat_kernel``): the
  affine transfer, LAB -> RGB, the 3x3 zero-border unsharp and the Philox
  grain of :mod:`vrgdg_tpu_torch.ops.grain`.

What bounds them on an H100, and the design (the source note of
``csrc/grade.cu`` has the reasons): each moves 24 bytes of HBM a pixel,
the larger term of its bound (``chip_smoke.py`` prices the floating-point
work of each kernel's per-pixel code below it), but runs that work on
dependent chains, and phase 1 gathers a 96-byte bundle row a pixel from
L2; their time is set by how many warps an SM holds to cover that
latency.  Phase 1 gives each block a fixed chunk of :data:`PHASE1_BLOCK`
pixels of one frame, walked one pixel a thread at a time at 32 warps an
SM, with its float64 sums in registers over the chunk and one partials
row per chunk.  Phase 2 filters 32 x 64 output tiles (1.10 LAB -> RGB
conversions per output pixel) with a 3 x 3 window sliding down 8-row
column strips.  All four kernels share ``csrc/common.h``'s conversions,
which take ``powf`` as ``exp2f``/``log2f`` and keep the divisions by
constants that phase 1's frame sums see exactly rounded.  The
asynchronous-copy designs that lost to these on the card are kept, and
timed, in ``kernel_variants/``.

Both kernels take and give BHWC float32 of any ``H x W``; none of the
TPU's tiling, padding or lane packing carries over, so nothing caps the
batch.  The A/B layouts of the TPU package run the same phases over
channel planes ``(B, 3, H, W)``:

- **phase 1 on planes** (``grade_phase1_planes``; replaces
  ``vrgdg_tpu/kernels/grade_pallas.py:218`` ``_phase1_kernel``): phase 1
  without adjust, fed by corner-major planes ``(24, B, H, W)`` that
  :func:`corner_planes` gathers with torch indexing outside the kernel;
  it writes phase 1's partials rows;
- **phase 2 on planes** (``grade_phase2_planes``; replaces
  ``vrgdg_tpu/kernels/grade_pallas.py:380`` ``_phase2_kernel``): phase 2's
  own body (one template in ``csrc/grade.cu``) reading and writing
  ``(B, 3, H, W)`` planes, so it gives ``grade_phase2``'s bits, permuted.

:func:`fused_post_gather` picks them with ``layout``: ``"flat"`` (phase 1
-> phase 2, all BHWC), ``"rowmajor"`` (phase 1 -> planes -> phase 2 on
planes) or ``"plane"`` (corner gather -> both planes kernels).  Each
wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  :data:`LAUNCHES` (shared with
the other kernel modules, see :mod:`.build`) counts the kernel launches of
each wrapper.
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
from ..runtime.profiling import span
from . import build
from .build import LAUNCHES, reset_launch_counts  # noqa: F401 (re-exported)

# pixels per phase-1 block (its chunk of one frame): one partials row each;
# csrc/grade.cu exports the same constant
PHASE1_BLOCK = 8192
LAYOUTS = ("flat", "rowmajor", "plane")
EMITS = ("bhwc", "planes")

# slider bits of csrc/grade.cu
_TEMP_TINT, _EXPOSURE, _CONTRAST, _SATURATION = 1, 2, 4, 8
_HIGHLIGHTS, _SHADOWS, _WHITES, _BLACKS = 16, 32, 64, 128
_FADE, _VIGNETTE, _ADJUST_ON = 256, 512, 1024


def _library():
    lib = build.library("grade")
    if lib.vrgdg_phase1_block_size() != PHASE1_BLOCK:
        raise build.KernelBuildError(
            "csrc/grade.cu and grade_cuda.PHASE1_BLOCK disagree on the "
            "phase-1 chunk size")
    return lib


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
# phase 1: trilerp + blend + adjust + LAB + chunk partial sums
# --------------------------------------------------------------------------

def phase1_plain(src: torch.Tensor, bundle: torch.Tensor,
                 domain: torch.Tensor, *, blend: float,
                 adjust: AdjustSettings | None = None):
    """Plain version of ``grade_phase1``.

    ``src`` ``(B, H, W, 3)`` float32 in [0,1]; ``bundle`` ``(N^3, 24)``;
    ``domain`` ``(2, 3)`` rows ``[dmin, 1/span]``.  Returns LAB
    ``(B, H, W, 3)`` float32 and partials ``(B, ceil(H*W/PHASE1_BLOCK), 6)``
    float64: per chunk of :data:`PHASE1_BLOCK` consecutive pixels of a
    frame (the last one shorter), the sums of L, a, b, L^2, a^2, b^2."""
    _check_adjust_and_bhwc(src, adjust)
    cell, frac = _lattice(src, domain, _lut_size(bundle))
    return _phase1_from_rows(src, bundle[cell], frac, blend=blend,
                             adjust=adjust)


def _lattice(src: torch.Tensor, domain: torch.Tensor, size: int):
    """Bundle row and lattice fractions of each pixel of a BHWC ``src``,
    from the coordinate expression the kernels use."""
    coords = torch.clamp((src - domain[0]) * domain[1], 0.0, 1.0) * (size - 1)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.to(torch.int64)
    return (lo[..., 2] * size + lo[..., 1]) * size + lo[..., 0], frac


def _phase1_from_rows(src, rows, frac, *, blend: float,
                      adjust: AdjustSettings | None):
    """Phase 1's math on BHWC ``src``, its ``(B, H, W, 24)`` bundle rows
    and lattice fractions: LAB and the per-chunk float64 partials."""
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
    build.check_launch(lib, code, "grade_phase1")
    return lab, partials


# --------------------------------------------------------------------------
# phase 1 on channel planes: the corner gather outside, no adjust
# --------------------------------------------------------------------------

def corner_planes(src_planes: torch.Tensor, bundle: torch.Tensor,
                  domain: torch.Tensor) -> torch.Tensor:
    """The corner-major gather of the ``"plane"`` layout, in torch ops:
    ``(24, B, H, W)`` float32, plane ``3j + c`` holding channel ``c`` of
    lattice corner ``j`` of each pixel (the bundle's column order), as XLA
    gathers it at ``vrgdg_tpu/kernels/grade_pallas.py:725-731``.  One
    ``index_select`` on the transposed ``(24, N^3)`` bundle writes the
    planes directly, 96 bytes per pixel, with no second relayout copy."""
    src = src_planes.permute(1, 2, 3, 0)
    cell, _ = _lattice(src, domain, _lut_size(bundle))
    table = bundle.t().contiguous()
    return torch.index_select(table, 1, cell.reshape(-1)).reshape(
        24, *cell.shape)


def _check_planes(name: str, tensor: torch.Tensor, leading: int) -> None:
    _require(tensor.ndim == 4 and tensor.shape[0] == leading,
             f"{name} must be ({leading}, B, H, W), got {tuple(tensor.shape)}")


def phase1_planes_plain(src_planes: torch.Tensor, planes: torch.Tensor,
                        domain: torch.Tensor, *, blend: float,
                        lut_size: int):
    """Plain version of ``grade_phase1_planes``.

    ``src_planes`` ``(3, B, H, W)``, ``planes`` the ``(24, B, H, W)``
    corner planes of :func:`corner_planes`, ``domain`` ``(2, 3)``.  Returns
    LAB planes ``(B, 3, H, W)`` and the partials of :func:`phase1_plain`.
    Runs phase 1's BHWC math on contiguous BHWC copies, so its numbers are
    :func:`phase1_plain`'s."""
    _check_planes("src_planes", src_planes, 3)
    _check_planes("planes", planes, 24)
    src = src_planes.permute(1, 2, 3, 0).contiguous()
    _, frac = _lattice(src, domain, lut_size)
    lab, partials = _phase1_from_rows(
        src, planes.permute(1, 2, 3, 0).contiguous(), frac, blend=blend,
        adjust=None)
    return lab.permute(0, 3, 1, 2).contiguous(), partials


def phase1_planes(src_planes: torch.Tensor, planes: torch.Tensor,
                  domain: torch.Tensor, *, blend: float, lut_size: int):
    """``grade_phase1_planes`` on CUDA tensors; :func:`phase1_planes_plain`
    on CPU ones."""
    if src_planes.device.type == "cpu":
        return phase1_planes_plain(src_planes, planes, domain, blend=blend,
                                   lut_size=lut_size)
    device = src_planes.device
    _require(device.type == "cuda", f"no kernel for device {device}")
    _check_planes("src_planes", src_planes, 3)
    _check_planes("planes", planes, 24)
    _require(planes.shape[1:] == src_planes.shape[1:],
             "planes and src_planes must cover the same (B, H, W)")
    _require(tuple(domain.shape) == (2, 3), "domain must be (2, 3)")
    _require(lut_size >= 2, "lut_size must be at least 2")
    for name, tensor in (("src_planes", src_planes), ("planes", planes),
                         ("domain", domain)):
        _check_cuda_f32(name, tensor, device)
    _, batch, height, width = src_planes.shape
    lab = torch.empty((batch, 3, height, width), dtype=torch.float32,
                      device=device)
    partials = torch.empty((batch, math.ceil(height * width / PHASE1_BLOCK),
                            6), dtype=torch.float64, device=device)
    lib = _library()
    code = lib.vrgdg_grade_phase1_planes(
        device.index, src_planes.data_ptr(), planes.data_ptr(), lut_size,
        domain.data_ptr(), blend, 1.0 - blend, batch, height, width,
        lab.data_ptr(), partials.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, code, "grade_phase1_planes")
    return lab, partials


# --------------------------------------------------------------------------
# the stats barrier: chunk sums -> per-frame affine LAB transfer
# --------------------------------------------------------------------------

def frame_statistics(partials: torch.Tensor, pixels: int):
    """Float64 ``(B, 3)`` mean and ``(B, 3)`` std (``ddof=1``, plus 1e-5)
    of each frame's L, a, b, from phase 1's ``(B, chunks, 6)`` partials
    of a frame of ``pixels`` pixels."""
    sums = partials.sum(dim=1)
    n = float(pixels)
    mean = sums[:, 0:3] / n
    var = torch.clamp(sums[:, 3:6] - n * mean * mean, min=0.0) / (n - 1.0)
    return mean, torch.sqrt(var) + 1e-5


def stats_barrier(partials: torch.Tensor, pixels: int,
                  ref_mean: torch.Tensor, ref_std: torch.Tensor,
                  match_strength: float) -> torch.Tensor:
    """``(B, 6)`` float32 ``[A_L, A_a, A_b, B_L, B_a, B_b]``.

    Formulas of ``vrgdg_tpu/kernels/grade_pallas.py:771-781``:
    ``var = max(S2 - n mu^2, 0) / (n - 1)``, ``std = sqrt(var) + 1e-5``,
    ``A = s sigma_ref / sigma + (1 - s)``, ``B = s (mu_ref - mu sigma_ref /
    sigma)``, with ``n`` the real pixels of a frame.  Runs in float64 on
    the device (the chunk sums reduce in a fixed order, so reruns are
    bit-identical) and never syncs with the host."""
    mean, std = frame_statistics(partials, pixels)
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
    build.check_launch(lib, code, "grade_phase2")
    return out


def _check_lab_planes(lab: torch.Tensor) -> None:
    _require(lab.ndim == 4 and lab.shape[1] == 3,
             f"lab must be (B, 3, H, W) planes, got {tuple(lab.shape)}")


def phase2_planes_plain(lab: torch.Tensor, coeff: torch.Tensor, *,
                        sharpen_strength: float, grain_intensity: float,
                        saturation_mix: float, seed_base: int
                        ) -> torch.Tensor:
    """Plain version of ``grade_phase2_planes``: ``(B, 3, H, W)`` LAB planes
    and ``(B, 6)`` coefficients in, ``(B, 3, H, W)`` RGB planes out.  Runs
    :func:`phase2_plain` on a contiguous BHWC copy, so every layout draws
    the same grain and gives the same numbers."""
    _check_lab_planes(lab)
    rgb = phase2_plain(lab.permute(0, 2, 3, 1).contiguous(), coeff,
                       sharpen_strength=sharpen_strength,
                       grain_intensity=grain_intensity,
                       saturation_mix=saturation_mix, seed_base=seed_base)
    return rgb.permute(0, 3, 1, 2).contiguous()


def phase2_planes(lab: torch.Tensor, coeff: torch.Tensor, *,
                  sharpen_strength: float, grain_intensity: float,
                  saturation_mix: float, seed_base: int) -> torch.Tensor:
    """``grade_phase2_planes`` on CUDA tensors; :func:`phase2_planes_plain`
    on CPU ones."""
    kwargs = dict(sharpen_strength=sharpen_strength,
                  grain_intensity=grain_intensity,
                  saturation_mix=saturation_mix, seed_base=seed_base)
    if lab.device.type == "cpu":
        return phase2_planes_plain(lab, coeff, **kwargs)
    _require(lab.device.type == "cuda", f"no kernel for device {lab.device}")
    _check_lab_planes(lab)
    _check_cuda_f32("lab", lab, lab.device)
    _check_cuda_f32("coeff", coeff, lab.device)
    batch, _, height, width = lab.shape
    _require(tuple(coeff.shape) == (batch, 6), "coeff must be (B, 6)")
    out = torch.empty_like(lab)
    lib = _library()
    code = lib.vrgdg_grade_phase2_planes(
        lab.device.index, lab.data_ptr(), coeff.data_ptr(), batch, height,
        width, sharpen_strength, grain_intensity, saturation_mix,
        1.0 - saturation_mix, int(seed_base) & 0xFFFFFFFF, out.data_ptr(),
        torch.cuda.current_stream(lab.device).cuda_stream)
    build.check_launch(lib, code, "grade_phase2_planes")
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


def _post_gather(phases, frames, bundle, domain_min, domain_max, ref_mean,
                 ref_std, seed_plus_start, *, blend, match_strength,
                 sharpen_strength, grain_intensity, saturation_mix, adjust,
                 layout, emit):
    first, second, first_planes, second_planes = phases
    if layout not in LAYOUTS:
        raise ValueError(f"Unknown layout {layout!r}")
    if emit not in EMITS:
        raise ValueError(f"Unknown emit {emit!r}; expected 'bhwc' or "
                         "'planes'")
    if adjust is not None and layout == "plane":
        # the TPU package's plane phase 1 never grew the adjust chain
        # (vrgdg_tpu/kernels/grade_pallas.py:616-619); neither does this one
        raise ValueError("adjust requires layout='flat' or 'rowmajor'")
    _require(frames.ndim == 4 and frames.shape[-1] == 3,
             "the fused grade needs (B, H, W, 3) frames")
    src = frames.to(torch.float32).contiguous()
    domain = lut_domain(domain_min, domain_max)
    with span("grade.phase1"):
        if layout == "plane":
            src_planes = src.permute(3, 0, 1, 2).contiguous()
            # the corner planes are a temporary: freed once phase 1 returns
            lab, partials = first_planes(
                src_planes, corner_planes(src_planes, bundle, domain),
                domain, blend=blend, lut_size=_lut_size(bundle))
        else:
            lab, partials = first(src, bundle, domain, blend=blend,
                                  adjust=adjust)
            if layout == "rowmajor":
                lab = lab.permute(0, 3, 1, 2).contiguous()
    with span("grade.stats"):
        coeff = stats_barrier(partials, src.shape[1] * src.shape[2],
                              ref_mean, ref_std, match_strength)
    kwargs = dict(sharpen_strength=sharpen_strength,
                  grain_intensity=grain_intensity,
                  saturation_mix=saturation_mix, seed_base=seed_plus_start)
    with span("grade.phase2"):
        if layout == "flat":
            out = second(lab, coeff, **kwargs)
            return (out.permute(0, 3, 1, 2).contiguous() if emit == "planes"
                    else out)
        out = second_planes(lab, coeff, **kwargs)
        return (out if emit == "planes"
                else out.permute(0, 2, 3, 1).contiguous())


def fused_post_gather(frames, bundle, domain_min, domain_max, ref_mean,
                      ref_std, seed_plus_start: int, *, blend: float,
                      match_strength: float, sharpen_strength: float,
                      grain_intensity: float, saturation_mix: float,
                      adjust: AdjustSettings | None = None,
                      layout: str = "flat", emit: str = "bhwc"
                      ) -> torch.Tensor:
    """The post-LUT stack for a BHWC [0,1] batch: phase 1, the barrier,
    phase 2.  ``seed_plus_start`` is ``seed + frame_start`` of
    ``frames[0]``.

    ``layout`` picks the data movement between the phases, as in
    :func:`vrgdg_tpu.kernels.grade_pallas.fused_post_gather`: ``"flat"``
    (:func:`phase1` -> :func:`phase2`, all BHWC), ``"rowmajor"``
    (:func:`phase1`, a permute to planes, :func:`phase2_planes`) or
    ``"plane"`` (:func:`corner_planes`, :func:`phase1_planes`,
    :func:`phase2_planes`; no adjust).  All three compute the same numbers.
    ``emit="planes"`` returns ``(B, 3, H, W)`` instead of BHWC float32; the
    TPU package honours it on the flat layout only, here every layout
    does."""
    return _post_gather((phase1, phase2, phase1_planes, phase2_planes),
                        frames, bundle, domain_min, domain_max, ref_mean,
                        ref_std, seed_plus_start, blend=blend,
                        match_strength=match_strength,
                        sharpen_strength=sharpen_strength,
                        grain_intensity=grain_intensity,
                        saturation_mix=saturation_mix, adjust=adjust,
                        layout=layout, emit=emit)


def fused_post_gather_plain(frames, bundle, domain_min, domain_max,
                            ref_mean, ref_std, seed_plus_start: int, *,
                            blend: float, match_strength: float,
                            sharpen_strength: float, grain_intensity: float,
                            saturation_mix: float,
                            adjust: AdjustSettings | None = None,
                            layout: str = "flat", emit: str = "bhwc"
                            ) -> torch.Tensor:
    """:func:`fused_post_gather` through the plain versions, on any device."""
    return _post_gather((phase1_plain, phase2_plain, phase1_planes_plain,
                         phase2_planes_plain),
                        frames, bundle, domain_min, domain_max, ref_mean,
                        ref_std, seed_plus_start, blend=blend,
                        match_strength=match_strength,
                        sharpen_strength=sharpen_strength,
                        grain_intensity=grain_intensity,
                        saturation_mix=saturation_mix, adjust=adjust,
                        layout=layout, emit=emit)
