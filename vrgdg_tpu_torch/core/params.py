"""Typed parameter schemas for every grading/enhancement op.

The reference pack encodes its parameter contracts twice: once in ComfyUI
``INPUT_TYPES`` widget schemas and once in server-side clamp-normalizers
(``VRGDG_StandaloneVideoEnhancerNodes.py:142-180`` and
``VRGDG_LUTVideoTools.py:280-304``).  Here each op gets exactly one frozen
dataclass whose ``normalize``/``clamped`` constructors reproduce the
reference's clamping semantics, so the dataclass is the single source of
truth for names, ranges and defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping


def _clampf(value: Any, lo: float, hi: float, default: float = 0.0) -> float:
    try:
        v = float(value)
    except (TypeError, ValueError):
        v = float(default)
    if v != v:  # NaN
        v = float(default)
    return max(lo, min(hi, v))


def _clampi(value: Any, lo: int, hi: int, default: int = 0) -> int:
    try:
        v = int(round(float(value)))
    except (TypeError, ValueError):
        v = int(default)
    return max(lo, min(hi, v))


@dataclass(frozen=True)
class GrainParams:
    """Film grain controls (reference: ``nodes.py:24-32`` widget ranges and
    ``VRGDG_LUTVideoTools.py:262-277`` runtime clamping).

    ``intensity`` scales the noise field, ``saturation_mix`` blends between
    chromatic grain (1.0) and monochrome grain derived from the green
    channel (0.0).  ``seed`` drives the per-frame deterministic generator;
    grain for absolute frame index ``i`` depends only on ``seed + i`` so the
    output is invariant to batch and shard boundaries
    (``VRGDG_StandaloneVideoEnhancerNodes.py:261-275``).
    """

    intensity: float = 0.04
    saturation_mix: float = 0.5
    seed: int = 0

    @classmethod
    def normalize(cls, intensity: Any = 0.04, saturation_mix: Any = 0.5,
                  seed: Any = 0) -> "GrainParams":
        return cls(
            intensity=_clampf(intensity, 0.0, 1.0, 0.04),
            saturation_mix=_clampf(saturation_mix, 0.0, 1.0, 0.5),
            seed=_clampi(seed, 0, 2**31 - 1, 0),
        )


@dataclass(frozen=True)
class LUTParams:
    """3D LUT application controls (reference: ``VRGDG_IV_Adjustments.py:155``
    strength widget 0-10, mapped to a 0-1 blend at ``:355``)."""

    strength: float = 10.0

    @classmethod
    def normalize(cls, strength: Any = 10.0) -> "LUTParams":
        return cls(strength=_clampf(strength, 0.0, 10.0, 10.0))

    @property
    def blend(self) -> float:
        return self.strength / 10.0


@dataclass(frozen=True)
class ColorMatchParams:
    """LAB statistics transfer controls (reference: ``nodes.py:70-124``)."""

    match_strength: float = 1.0

    @classmethod
    def normalize(cls, match_strength: Any = 1.0) -> "ColorMatchParams":
        return cls(match_strength=_clampf(match_strength, 0.0, 1.0, 1.0))


@dataclass(frozen=True)
class SharpenParams:
    """Sharpening controls.

    ``strength`` range mirrors the widget: 0-10 for unsharp
    (``nodes.py:136-142``), 0-2 for laplacian/sobel (``nodes.py:218-221``).
    ``border`` selects the reference's two padding conventions: the GPU
    paths zero-pad via ``avg_pool2d``/``conv2d(padding=1)`` while the CPU
    paths edge-replicate (``nodes.py:166-209``).
    """

    strength: float = 0.5
    border: str = "edge"  # "edge" (CPU parity) | "zero" (GPU parity)
    kind: str = "unsharp"  # "unsharp" | "laplacian" | "sobel"

    @classmethod
    def normalize(cls, strength: Any = 0.5, border: str = "edge",
                  kind: str = "unsharp",
                  max_strength: float | None = None) -> "SharpenParams":
        border = border if border in ("edge", "zero") else "edge"
        kind = kind if kind in ("unsharp", "laplacian", "sobel") else "unsharp"
        if max_strength is None:
            max_strength = 10.0 if kind == "unsharp" else 2.0
        return cls(strength=_clampf(strength, 0.0, max_strength, 0.5),
                   border=border, kind=kind)


# The 13 adjust sliders with their reference ranges
# (VRGDG_LUTVideoTools.py:282-296): every slider is bipolar +/-100
# except the three intensity-only effects, which run 0..100.
_ADJUST_SLIDERS = ("temperature", "tint", "saturation", "exposure",
                   "contrast", "highlights", "shadows", "whites",
                   "blacks", "sharpen", "clarity", "vignette", "fade")
_INTENSITY_ONLY = frozenset({"sharpen", "vignette", "fade"})
_ADJUST_RANGES: dict[str, tuple[float, float]] = {
    name: ((0.0, 100.0) if name in _INTENSITY_ONLY else (-100.0, 100.0))
    for name in _ADJUST_SLIDERS}


@dataclass(frozen=True)
class AdjustSettings:
    """The 13-slider adjust stack (reference: ``VRGDG_LUTVideoTools.py:280-391``).

    Applied in the reference's fixed order: temperature/tint, exposure,
    contrast, saturation, highlights/shadows/whites/blacks, clarity,
    sharpen, fade, vignette.
    """

    enabled: bool = True
    temperature: float = 0.0
    tint: float = 0.0
    saturation: float = 0.0
    exposure: float = 0.0
    contrast: float = 0.0
    highlights: float = 0.0
    shadows: float = 0.0
    whites: float = 0.0
    blacks: float = 0.0
    sharpen: float = 0.0
    clarity: float = 0.0
    vignette: float = 0.0
    fade: float = 0.0

    @classmethod
    def normalize(cls, settings: Mapping[str, Any] | None = None,
                  **overrides: Any) -> "AdjustSettings":
        """Clamp a loose settings mapping exactly like the reference's
        ``_normalize_adjust_settings`` (``VRGDG_LUTVideoTools.py:280-304``)."""
        merged: dict[str, Any] = {}
        if isinstance(settings, Mapping):
            merged.update(settings)
        merged.update(overrides)
        fields = {"enabled": merged.get("enabled", True) is not False}
        for key, (lo, hi) in _ADJUST_RANGES.items():
            fields[key] = _clampf(merged.get(key, 0.0), lo, hi, 0.0)
        return cls(**fields)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def is_identity(self) -> bool:
        return all(getattr(self, k) == 0.0 for k in _ADJUST_RANGES)


_ENCODE_PRESETS = {"ultrafast", "superfast", "veryfast", "faster", "fast",
                   "medium", "slow"}
_UPSCALE_CHOICES = {"original", "2k", "3k", "4k"}


def _safe_name(value: Any, fallback: str) -> str:
    """Reference output-name sanitizer
    (``VRGDG_StandaloneVideoEnhancerNodes.py:26-31``): basename, stem
    charset + strip, extension charset, length caps."""
    import os
    import re

    name = os.path.basename(str(value or "").strip()) or fallback
    stem, ext = os.path.splitext(name)
    stem = re.sub(r"[^A-Za-z0-9._-]+", "_", stem).strip("._") or fallback
    ext = re.sub(r"[^A-Za-z0-9.]+", "", ext)
    return stem[:100] + ext[:12]


@dataclass(frozen=True)
class EnhancerSettings:
    """Standalone Video Enhancer settings schema (reference:
    ``VRGDG_StandaloneVideoEnhancerNodes.py:142-180``)."""

    upscale_resolution: str = "original"
    sharpen_enabled: bool = True
    sharpen_strength: float = 0.5
    grain_enabled: bool = False
    grain_intensity: float = 0.04
    saturation_mix: float = 0.5
    seed: int = 42
    use_accelerator: bool = True
    batch_size: int = 0
    segment_seconds: int = 30
    encode_crf: int = 18
    encode_preset: str = "medium"
    preserve_audio: bool = True
    output_name: str = "enhanced_video.mp4"
    # TPU-native additions (no reference analog — the reference is
    # single-GPU): number of mesh devices to shard frame batches over
    # (0 = all visible devices, 1 = single-device), and how many of them
    # cooperate on each frame via height-axis spatial sharding (for
    # frames too large per chip; output matches single-device to float
    # tolerance — stencil halos are exact, resize matmuls reassociate).
    data_parallel: int = 0
    spatial_parallel: int = 1
    # parallel host decode threads per segment (SURVEY section 7: a single
    # sequential cv2 read loop starves the accelerator at high device
    # speed). 0 = auto, which currently means sequential — the chunked
    # reader's seek redundancy loses below ~3 cores (BASELINE.md), so
    # parallel decode is opt-in via an explicit value >= 2.
    decode_workers: int = 0

    @classmethod
    def normalize(cls, payload: Mapping[str, Any] | None = None) -> "EnhancerSettings":
        p = payload if isinstance(payload, Mapping) else {}
        preset = str(p.get("encode_preset") or "medium").strip().lower()
        if preset not in _ENCODE_PRESETS:
            preset = "medium"
        upscale = str(p.get("upscale_resolution") or "original").strip().lower()
        if upscale not in _UPSCALE_CHOICES:
            upscale = "original"
        use_accel = p.get("use_accelerator", p.get("use_gpu", True))
        return cls(
            upscale_resolution=upscale,
            sharpen_enabled=bool(p.get("sharpen_enabled", True)),
            sharpen_strength=_clampf(p.get("sharpen_strength", 0.5), 0.0, 10.0, 0.5),
            grain_enabled=bool(p.get("grain_enabled", False)),
            grain_intensity=_clampf(p.get("grain_intensity", 0.04), 0.0, 1.0, 0.04),
            saturation_mix=_clampf(p.get("saturation_mix", 0.5), 0.0, 1.0, 0.5),
            seed=_clampi(p.get("seed", 42), 0, 2**31 - 1, 42),
            use_accelerator=bool(use_accel),
            batch_size=_clampi(p.get("batch_size", 0), 0, 128, 0),
            segment_seconds=_clampi(p.get("segment_seconds", 30), 5, 300, 30),
            encode_crf=_clampi(p.get("encode_crf", 18), 12, 35, 18),
            encode_preset=preset,
            preserve_audio=bool(p.get("preserve_audio", True)),
            output_name=_safe_name(p.get("output_name") or "enhanced_video.mp4",
                                   "enhanced_video"),
            data_parallel=_clampi(p.get("data_parallel", 0), 0, 4096, 0),
            spatial_parallel=_clampi(p.get("spatial_parallel", 1), 1, 64, 1),
            decode_workers=_clampi(p.get("decode_workers", 0), 0, 32, 0),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def output_dimensions(width: int, height: int, upscale_resolution: str) -> tuple[int, int]:
    """"Fake upscale" target dims: scale the long edge to 2560/3072/3840,
    never downscale, round to even (reference:
    ``VRGDG_StandaloneVideoEnhancerNodes.py:183-197``)."""
    width = max(1, int(width))
    height = max(1, int(height))
    target = {"2k": 2560, "3k": 3072, "4k": 3840}.get(
        str(upscale_resolution or "original").strip().lower(), 0)
    long_edge = max(width, height)
    if target <= 0 or long_edge >= target:
        return width, height
    scale = target / long_edge
    out_w = max(2, int(round((width * scale) / 2.0)) * 2)
    out_h = max(2, int(round((height * scale) / 2.0)) * 2)
    return out_w, out_h


def auto_batch_size(width: int, height: int) -> int:
    """Resolution-tiered frame batch size (reference:
    ``VRGDG_StandaloneVideoEnhancerNodes.py:200-210``)."""
    pixels = max(1, int(width) * int(height))
    for tier_pixels, batch in ((1280 * 720, 16), (1920 * 1080, 8),
                               (2560 * 1440, 4), (3200 * 1800, 2)):
        if pixels <= tier_pixels:
            return batch
    return 1


def round_dimension(value: int, multiple: int) -> int:
    """Round a requested dimension to a model-friendly multiple with an
    8px floor (reference: ``VRGDG_VideoEnhanceNodes.py:39-42``)."""
    value = max(8, int(value))
    multiple = max(1, int(multiple))
    return max(multiple, int(round(value / multiple)) * multiple)
