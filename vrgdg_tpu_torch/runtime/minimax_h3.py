"""MiniMax H3 support math: scene timing plans + reference-media parsing.

A copy of :mod:`vrgdg_tpu.runtime.minimax_h3` (which cannot be imported
without JAX): every function keeps its original's source, except that
:func:`load_reference_images` decodes through
:func:`vrgdg_tpu_torch.runtime.image_io.read_rgb_exif_transposed` (cv2
with Pillow's ``exif_transpose(...).convert("RGB")`` pixels).

MiniMax H3 renders on a fixed 24 fps clock and only accepts frame
counts on the ``17n + 5`` grid (5, 22, 39, ... 362).  The reference
ships two ComfyUI-free helpers for it that this module re-derives:

* ``VRGDG_MiniMaxH3Timing.py:1-186`` — the exact
  render/trim timing plan for one Builder scene (warm-up / cool-down
  context handles clamped to the available source audio, frame-grid
  alignment, and the post-render trim window).  Computed in
  ``decimal.Decimal`` at the default 28-digit context ON PURPOSE: the
  frame ceiling is taken on the rounded division results, so a context
  of exactly 71/24 s counts as 72 frames (`28/24` rounds up at digit
  28).  An exact-rational (Fraction) formulation gives 71 there — the
  oracle fuzz caught that one-frame divergence, and interchangeable
  plans matter more than prettier arithmetic.
* ``VRGDG_MiniMaxH3ReferenceMedia.py:17-100`` — the
  ordered reference-media path parsing (JSON list / object / one per
  line), the per-video window math, and multi-root path resolution.
  The tensor loading half of that module targets ComfyUI latents and
  VHS loader nodes; here images load into numpy and videos
  resolve to (skip, cap) windows for :mod:`vrgdg_tpu_torch.runtime.video_io`.

The prompt-instruction constants the reference pairs with these
(``VRGDG_MiniMaxH3PromptInstructions.py``) are LLM prompt text; the
instruction *store* that serves and overrides them is ported in
:mod:`vrgdg_tpu_torch.api.instructions`.  ``VRGDG_MiniMaxH3AudioDrive.py``
swaps the audio half of a nested ComfyUI AV latent and has no meaning
outside that model graph (documented exclusion, docs/API.md).
"""

from __future__ import annotations

import json
import math
import os
import re
from decimal import Decimal, InvalidOperation, ROUND_CEILING

H3_FPS = 24
H3_FRAME_STEP = 17
H3_FRAME_OFFSET = 5
H3_MIN_FRAME_COUNT = 5
H3_MAX_FRAME_COUNT = 362

MAX_REFERENCE_IMAGES = 9
MAX_REFERENCE_VIDEOS = 3
REFERENCE_VIDEO_FPS = 24
REFERENCE_VIDEO_MAX_FRAMES = 15 * REFERENCE_VIDEO_FPS

_EMIT_SCALE = 10 ** 9


# ------------------------------------------------------------------
# timing plans (ref VRGDG_MiniMaxH3Timing.py)
# ------------------------------------------------------------------

def _exact(value, name: str) -> Decimal:
    """Decimal from any numeric-ish input (rejects inf/nan)."""
    try:
        number = Decimal(str(value))
    except (InvalidOperation, ValueError, TypeError) as exc:
        raise ValueError(f"{name} must be a finite number") from exc
    if not number.is_finite():
        raise ValueError(f"{name} must be a finite number")
    return number


def _whole(value, name: str) -> int:
    number = _exact(value, name)
    if number < 0 or number != number.to_integral_value():
        raise ValueError(f"{name} must be a non-negative whole number")
    return int(number)


def _emit(value: Decimal) -> float:
    """Seconds as a JSON-stable float, half-even quantized to 1e-9."""
    return float(value.quantize(Decimal("0.000000001")))


def align_h3_frame_count(frame_count) -> int:
    """Smallest ``17n + 5`` frame count >= the request (>= 5)
    (ref ``align_h3_frame_count``, ``:42-45``)."""
    frames = max(H3_MIN_FRAME_COUNT, _whole(frame_count, "frame_count"))
    return frames + (H3_FRAME_OFFSET - frames) % H3_FRAME_STEP


def frames_covering_duration(duration_seconds, fps=H3_FPS) -> int:
    """Whole frames needed to cover a duration, rounded up
    (ref ``frames_covering_duration``, ``:48-56``)."""
    duration = _exact(duration_seconds, "duration_seconds")
    rate = _whole(fps, "fps")
    if duration < 0:
        raise ValueError("duration_seconds must not be negative")
    if rate <= 0:
        raise ValueError("fps must be greater than zero")
    return math.ceil(duration * rate)


def calculate_minimax_h3_timing(
        timeline_start_seconds, timeline_end_seconds,
        warmup_frames=0, cooldown_frames=0, *,
        source_start_seconds=None, source_duration_seconds=None,
        fps=H3_FPS, max_frame_count=H3_MAX_FRAME_COUNT) -> dict:
    """Complete render/trim plan for one Builder scene
    (ref ``calculate_minimax_h3_timing``, ``:86-186``).

    The timeline window is authoritative; warm-up/cool-down are context
    frames that extend the *render* but never the final trim.  Handles
    are clamped to what the source audio can actually supply, the
    context is rounded up onto the 17n+5 grid, and the plan records
    both the audio slice to feed the model and the trim window that
    recovers exactly the requested scene afterwards.  Field names match
    the reference's ``MiniMaxH3TimingPlan`` so plans interchange.
    """
    rate = _whole(fps, "fps")
    if rate != H3_FPS:
        raise ValueError(f"MiniMax H3 timing requires {H3_FPS} fps")
    start = _exact(timeline_start_seconds, "timeline_start_seconds")
    end = _exact(timeline_end_seconds, "timeline_end_seconds")
    if start < 0:
        raise ValueError("timeline_start_seconds must not be negative")
    if end <= start:
        raise ValueError("timeline_end_seconds must be greater than "
                         "timeline_start_seconds")
    scene = end - start

    warm_frames = _whole(warmup_frames, "warmup_frames")
    cool_frames = _whole(cooldown_frames, "cooldown_frames")

    src_start = (start if source_start_seconds is None
                 else _exact(source_start_seconds,
                             "source_start_seconds"))
    if src_start < 0:
        raise ValueError("source_start_seconds must not be negative")
    src_total = None
    if source_duration_seconds is not None:
        src_total = _exact(source_duration_seconds,
                           "source_duration_seconds")
        if src_total < 0:
            raise ValueError("source_duration_seconds must not be "
                             "negative")
        if src_start + scene > src_total:
            raise ValueError("the selected scene extends beyond the "
                             "available source audio")

    # each handle shrinks to the audio actually available on its side
    warmup = min(Decimal(warm_frames) / rate, src_start)
    cooldown = Decimal(cool_frames) / rate
    if src_total is not None:
        tail = src_total - (src_start + scene)
        cooldown = min(cooldown, max(Decimal(0), tail))

    context = warmup + scene + cooldown
    context_frames = frames_covering_duration(context, rate)
    h3_frames = align_h3_frame_count(context_frames)
    ceiling = _whole(max_frame_count, "max_frame_count")
    if h3_frames > ceiling:
        raise ValueError(
            f"the scene plus available warm-up/cool-down needs "
            f"{h3_frames} H3 frames; the configured maximum is {ceiling}")

    render = Decimal(h3_frames) / rate
    return {
        "timeline_start_seconds": _emit(start),
        "timeline_end_seconds": _emit(end),
        "scene_duration_seconds": _emit(scene),
        "source_start_seconds": _emit(src_start),
        "source_duration_seconds":
            None if src_total is None else _emit(src_total),
        "requested_warmup_frames": warm_frames,
        "requested_cooldown_frames": cool_frames,
        "actual_warmup_seconds": _emit(warmup),
        "actual_cooldown_seconds": _emit(cooldown),
        "audio_trim_start_seconds": _emit(src_start - warmup),
        "audio_trim_duration_seconds": _emit(context),
        "context_duration_seconds": _emit(context),
        "context_frame_count": context_frames,
        # intentionally the ceiling frame count: a seconds->frames
        # expression downstream can never render short of the context
        "workflow_duration_input_seconds":
            _emit(Decimal(context_frames) / rate),
        "h3_frame_count": h3_frames,
        "h3_render_duration_seconds": _emit(render),
        "alignment_padding_seconds": _emit(render - context),
        "final_trim_start_seconds": _emit(warmup),
        "final_trim_duration_seconds": _emit(scene),
        "discard_after_scene_seconds": _emit(render - (warmup + scene)),
    }


# ------------------------------------------------------------------
# reference media parsing (ref VRGDG_MiniMaxH3ReferenceMedia.py)
# ------------------------------------------------------------------

def parse_path_values(raw, collection_keys=()) -> list:
    """Raw UI text -> ordered value list: a JSON list passes through, a
    JSON object yields the first matching collection key (else its
    values), anything else splits on newlines
    (ref ``_parse_path_values``, ``:17-40``)."""
    text = str(raw or "").strip()
    if not text:
        return []
    try:
        decoded = json.loads(text)
    except (ValueError, TypeError):
        decoded = None
    if isinstance(decoded, list):
        return decoded
    if isinstance(decoded, dict):
        for key in collection_keys:
            if isinstance(decoded.get(key), list):
                return decoded[key]
        return list(decoded.values())
    return re.split(r"[\r\n]+", text)


def clean_media_path(value) -> str:
    """One path from a string or a {path|file|image|video: ...} dict,
    with surrounding quotes stripped (ref ``_clean_path``, ``:43-46``)."""
    if isinstance(value, dict):
        for key in ("path", "file", "image", "video"):
            if value.get(key):
                value = value[key]
                break
        else:
            value = ""
    return str(value or "").strip().strip('"').strip("'")


def parse_image_paths(raw) -> list[str]:
    """Ordered non-empty image paths (ref ``_parse_image_paths``)."""
    values = parse_path_values(raw, ("image_paths", "images"))
    return [p for p in (clean_media_path(v) for v in values) if p]


def _as_bool(value, default=False) -> bool:
    if isinstance(value, bool):
        return value
    if value is None:
        return default
    return str(value).strip().lower() in {"1", "true", "yes", "on"}


def _as_nonneg_float(value, default=0.0) -> float:
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return max(0.0, float(default))


def parse_video_references(raw) -> list[dict]:
    """Ordered video references with window metadata; bare strings get
    the defaults (ref ``_parse_video_references``, ``:71-100``)."""
    out = []
    for item in parse_path_values(raw, ("video_references", "videos")):
        record = {"path": clean_media_path(item), "start_seconds": 0.0,
                  "duration": 0.0, "use_audio": False}
        if isinstance(item, dict):
            record["start_seconds"] = _as_nonneg_float(
                item.get("start_seconds",
                         item.get("start", item.get("seek_seconds", 0))))
            record["duration"] = _as_nonneg_float(
                item.get("duration_seconds", item.get("duration", 0)))
            record["use_audio"] = _as_bool(
                item.get("use_audio",
                         item.get("include_audio",
                                  item.get("reference_audio", False))))
        if record["path"]:
            out.append(record)
    return out


def video_reference_window(reference: dict) -> tuple[int, int]:
    """(frames to skip, frame cap) for a reference's 24 fps window,
    capped at 15 s (ref ``_load_video_reference``, ``:152-163``)."""
    fps = REFERENCE_VIDEO_FPS
    skip = max(0, round(_as_nonneg_float(
        reference.get("start_seconds", 0)) * fps))
    duration = _as_nonneg_float(reference.get("duration", 0))
    if duration > 0:
        cap = min(REFERENCE_VIDEO_MAX_FRAMES,
                  max(1, round(duration * fps)))
    else:
        cap = REFERENCE_VIDEO_MAX_FRAMES
    return skip, cap


def resolve_media_path(raw_path, roots: tuple[str, ...] = ()) -> str:
    """First existing file among the path itself, its cwd-absolute
    form, and each supplied root (generalizing the reference's
    input/output/temp directories, ``:101-127``)."""
    text = clean_media_path(raw_path)
    if not text:
        raise FileNotFoundError("reference media path was empty")
    if os.path.isabs(text):
        candidates = [text]
    else:
        candidates = [text, os.path.abspath(text)]
        candidates += [os.path.join(root, text) for root in roots if root]
    unique = dict.fromkeys(os.path.normpath(os.path.abspath(c))
                           for c in candidates)
    for normalized in unique:
        if os.path.isfile(normalized):
            return normalized
    raise FileNotFoundError(f"reference media was not found: {text}")


def load_reference_images(raw, roots: tuple[str, ...] = ()) -> list:
    """Resolve + decode the ordered reference images to float32 RGB
    numpy arrays in [0, 1] (EXIF-transposed, like the reference's
    tensor loader ``:130-136``); raises if more than
    :data:`MAX_REFERENCE_IMAGES` are supplied."""
    import numpy as np

    from .image_io import read_rgb_exif_transposed

    paths = parse_image_paths(raw)
    if len(paths) > MAX_REFERENCE_IMAGES:
        raise ValueError(f"MiniMax H3 supports at most "
                         f"{MAX_REFERENCE_IMAGES} reference images; "
                         f"received {len(paths)}")
    images = []
    for path in paths:
        rgb = read_rgb_exif_transposed(resolve_media_path(path, roots))
        images.append(np.asarray(rgb, dtype=np.float32) / 255.0)
    return images
