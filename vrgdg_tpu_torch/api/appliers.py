"""Library API: apply LUT / film grain / adjust / the fused grade to media.

Counterpart of :mod:`vrgdg_tpu.api.appliers`: same parameter names and
result-dict fields (``elapsed_seconds``, ``processed_fps``, codec fallback
and ffmpeg re-encode status, ``stage_seconds``), with the pixel math
running as torch batches on an explicit device.  Still images (the image
appliers, the before/after previews) are read and written through
:mod:`vrgdg_tpu_torch.runtime.image_io`, which gives Pillow's pixels.

The per-batch loop lives in :func:`stream_graded_batches`, a generator over
uint8 ``(B, H, W, 3)`` host batches through
:mod:`vrgdg_tpu_torch.runtime.batch_stream`: uint8 upload, dequantize, the
effect, quantize, uint8 download.  :func:`_apply_effect_to_video` wraps it
with the video reader and writer; it runs as well over in-memory batches.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..core.cube import GLOBAL_LUT_CACHE
from ..core.params import (AdjustSettings, ColorMatchParams, GrainParams,
                           LUTParams, SharpenParams)
from ..ops.color_match import lab_statistics
from ..ops.grade import GradeConfig, grade_prepared, prepare_operands
from ..runtime import batch_stream, image_io, profiling, video_io
from ..runtime.batch_stream import resolve_device
from . import paths

Effect = Callable[[torch.Tensor, int], torch.Tensor]


def device_name(device) -> str:
    """The torch device, with the card's name for CUDA devices."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _normalize_crf(value, default):
    try:
        return max(12, min(35, int(round(float(value)))))
    except (TypeError, ValueError):
        return default


def _normalize_preset(value, default):
    value = str(value or "").strip().lower()
    return value if value in {"ultrafast", "superfast", "veryfast", "faster",
                              "fast", "medium", "slow"} else default


def _default_output_path(input_path: str, tag: str) -> str:
    stem, ext = os.path.splitext(input_path)
    safe_tag = os.path.splitext(os.path.basename(tag))[0] if tag else "graded"
    return f"{stem}_{safe_tag}{ext}"


def _write_thumbnail(video_path: str, thumbnail_path: str = "") -> str:
    import cv2

    if not thumbnail_path:
        thumbnail_path = os.path.splitext(video_path)[0] + "_thumb.jpg"
    capture = cv2.VideoCapture(video_path)
    try:
        ok, frame = capture.read()
    finally:
        capture.release()
    if not ok:
        return ""
    height, width = frame.shape[:2]
    scale = min(1.0, 320.0 / max(1, width))
    if scale < 1.0:
        frame = cv2.resize(frame, (int(width * scale), int(height * scale)))
    return thumbnail_path if cv2.imwrite(thumbnail_path, frame) else ""


def ffmpeg_browser_encode(video_path: str, audio_source: str = "",
                          crf: int = 23, preset: str = "medium") -> dict:
    """Re-encode in place to browser-friendly H.264 + remux audio when the
    ffmpeg binary exists; reports rather than fails when it does not."""
    ffmpeg = video_io.find_ffmpeg()
    if not ffmpeg:
        return {"ok": False, "error": "ffmpeg is not available",
                "audio_preserved": False}
    folder = os.path.dirname(os.path.abspath(video_path))
    fd, temp_out = tempfile.mkstemp(prefix="vrgdg_enc_", suffix=".mp4",
                                    dir=folder)
    os.close(fd)
    command = [ffmpeg, "-y", "-i", video_path]
    if audio_source:
        command += ["-i", audio_source, "-map", "0:v:0", "-map", "1:a?",
                    "-c:a", "aac", "-b:a", "192k"]
    else:
        command += ["-an"]
    command += ["-c:v", "libx264", "-preset",
                _normalize_preset(preset, "medium"),
                "-crf", str(_normalize_crf(crf, 23)), "-pix_fmt", "yuv420p",
                "-movflags", "+faststart", temp_out]
    result = subprocess.run(command, capture_output=True, text=True,
                            errors="replace", check=False)
    if result.returncode != 0 or not os.path.isfile(temp_out):
        with contextlib.suppress(OSError):
            os.remove(temp_out)
        return {"ok": False, "error": (result.stderr or "ffmpeg failed")[-1000:],
                "audio_preserved": False}
    os.replace(temp_out, video_path)
    return {"ok": True, "encoder": "ffmpeg:libx264",
            "audio_preserved": bool(audio_source)}


def stream_graded_batches(batches: Iterable[tuple[int, np.ndarray]],
                          effect: Effect, *, batch_size: int, device,
                          dispatch_depth: int = 2,
                          timer: profiling.StageTimer | None = None,
                          stats: dict | None = None) -> Iterator[np.ndarray]:
    """Run ``effect`` over ``(first_frame_index, uint8 (B, H, W, 3))`` host
    batches and yield the uint8 results, in order: each batch, at its own
    length, is uploaded, dequantized, run, quantized and downloaded by
    :mod:`~vrgdg_tpu_torch.runtime.batch_stream` with up to
    ``dispatch_depth`` in flight, so host decode and encode overlap device
    work; on CUDA at a depth of 2 or more each batch is staged one ahead
    on native threads
    (:func:`~vrgdg_tpu_torch.runtime.batch_stream.look_ahead`), and the
    wait for it is part of ``decode``.  ``stats`` (optional) receives
    ``frames``, ``batches`` and, on CUDA, ``device_ms``; the batch spans
    nest under ``timer``'s ``device`` stage."""
    device = resolve_device(device)
    timer = timer or profiling.StageTimer()
    in_flight = batch_stream.InFlight(dispatch_depth, stats, device)
    stream = in_flight.stream

    def step(frame_index: int) -> Callable:
        return lambda on_device: video_io.quantize_on_device(effect(
            video_io.dequantize_on_device(on_device), frame_index))

    def force() -> np.ndarray:
        pending, ids, _ = in_flight.popleft()
        return in_flight.wait(pending, ids)

    with contextlib.closing(
            batch_stream.look_ahead(batches, in_flight)) as pulled:
        while True:
            with timer.stage("decode", stream):
                item = next(pulled, None)
            if item is None:
                break
            ids = in_flight.next_ids()
            with timer.stage("device", *ids):
                pending = batch_stream.submit(
                    item.frames, step(int(item.first)), device, batch_size,
                    item.pinned)
                if not in_flight.push(pending, ids):
                    continue
                out = force()
            with timer.stage("encode", stream):
                yield out
    while in_flight:
        with timer.stage("device", stream):
            out = force()
        with timer.stage("encode", stream):
            yield out


def _apply_effect_to_video(input_path, effect: Effect, *, tag: str, device,
                           output_path="", batch_size=8,
                           replace_source=False, thumbnail_path="",
                           preserve_audio=True, encode_crf=23,
                           encode_preset="medium", dispatch_depth=2,
                           extra_fields: dict | None = None) -> dict:
    """Decode -> :func:`stream_graded_batches` -> encode, with the
    reference's codec fallback, browser re-encode and telemetry."""
    device = resolve_device(device)
    input_path = paths.resolve_media_path(input_path, "Input video")
    if os.path.splitext(input_path)[1].lower() not in paths.SUPPORTED_VIDEO_EXTENSIONS:
        raise ValueError("Input video type is not supported.")
    output_path = os.path.abspath(
        str(output_path or "").strip().strip('"')
        or _default_output_path(input_path, tag))
    if replace_source:
        output_path = input_path

    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    tmp_output = output_path
    if replace_source:
        fd, tmp_output = tempfile.mkstemp(
            prefix="vrgdg_tpu_", suffix=".mp4",
            dir=os.path.dirname(input_path))
        os.close(fd)

    metadata = video_io.probe_video(input_path)
    fps, width, height = metadata["fps"], metadata["width"], metadata["height"]
    dispatch_depth = batch_stream.dispatch_depth(dispatch_depth)
    started = time.perf_counter()
    stats: dict = {}
    timer = profiling.StageTimer()

    def producer():
        reader = video_io.VideoReader(input_path, batch_size=batch_size,
                                      as_float=False)
        with reader, video_io.PrefetchingReader(reader) as prefetch:
            yield from stream_graded_batches(
                prefetch, effect, batch_size=batch_size, device=device,
                dispatch_depth=dispatch_depth, timer=timer, stats=stats)

    with profiling.maybe_trace(tag):
        selected_codec = video_io.write_video_with_fallback(
            tmp_output, fps, width, height, producer)
    processed_frames = stats.get("frames", 0)

    ffmpeg_result = ffmpeg_browser_encode(
        tmp_output, input_path if preserve_audio else "",
        encode_crf, encode_preset)
    encoder = (ffmpeg_result.get("encoder") if ffmpeg_result.get("ok")
               else f"cv2:{selected_codec}")
    if replace_source:
        os.replace(tmp_output, output_path)

    thumbnail_path = _write_thumbnail(output_path, thumbnail_path)
    elapsed = time.perf_counter() - started
    result = {
        "input": input_path,
        "output": output_path,
        "device": device_name(device),
        "replace_source": bool(replace_source),
        "width": width,
        "height": height,
        "fps": fps,
        "reported_frames": metadata["frame_count"],
        "processed_frames": processed_frames,
        "elapsed_seconds": elapsed,
        "processed_fps": processed_frames / elapsed if elapsed > 0 else 0.0,
        "audio_preserved": bool(ffmpeg_result.get("audio_preserved")),
        "source_had_audio": metadata["has_audio"],
        "preserve_audio": bool(preserve_audio),
        "encode_crf": _normalize_crf(encode_crf, 23),
        "encode_preset": _normalize_preset(encode_preset, "medium"),
        "thumbnail_path": thumbnail_path,
        "encoder": encoder,
        "browser_friendly": bool(ffmpeg_result.get("ok")),
        "ffmpeg_encode": ffmpeg_result,
        "dispatch_depth": dispatch_depth,
        # decode = waiting on the prefetching reader, device = upload +
        # effect + download, encode = cv2 write (downstream of yield)
        "stage_seconds": timer.seconds(),
    }
    if "device_ms" in stats:
        result["device_ms"] = stats["device_ms"]
    result.update(extra_fields or {})
    return result


def _read_image(path) -> np.ndarray:
    """An image file -> (1, H, W, 3) float32 RGB in [0,1], divided on the
    host as the JAX package does."""
    return image_io.read_rgb(path).astype(np.float32)[None] / 255.0


def _run_effect(effect: Effect, array: np.ndarray, device) -> np.ndarray:
    """``effect`` on one float32 (1, H, W, 3) host array at frame 0, on
    ``device``; the result back on the host."""
    out = effect(torch.from_numpy(array).to(device), 0)
    return out.cpu().numpy()


def _apply_effect_to_image(input_path, effect: Effect, *, tag: str, device,
                           output_path="", replace_source=False,
                           extra_fields: dict | None = None) -> dict:
    """Read -> effect on ``device`` -> write, with the JAX applier's
    result fields plus ``stage_seconds`` (decode = read and divide on the
    host, device = upload, effect and download, encode = quantize and
    write)."""
    device = resolve_device(device)
    input_path = paths.resolve_media_path(input_path, "Input image")
    if os.path.splitext(input_path)[1].lower() not in paths.SUPPORTED_IMAGE_EXTENSIONS:
        raise ValueError("Input image type is not supported.")
    output_path = os.path.abspath(
        str(output_path or "").strip().strip('"')
        or _default_output_path(input_path, tag))
    if replace_source:
        output_path = input_path
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    tmp_output = output_path
    if replace_source:
        fd, tmp_output = tempfile.mkstemp(
            prefix="vrgdg_tpu_", suffix=os.path.splitext(input_path)[1],
            dir=os.path.dirname(input_path))
        os.close(fd)

    started = time.perf_counter()
    timer = profiling.StageTimer()
    with timer.stage("decode"):
        array = _read_image(input_path)
    with timer.stage("device"):
        out = _run_effect(effect, array, device)
    with timer.stage("encode"):
        u8 = np.clip(out[0] * 255.0, 0, 255).astype(np.uint8)
        image_io.write_rgb(tmp_output, u8)
    if replace_source:
        os.replace(tmp_output, output_path)
    elapsed = time.perf_counter() - started
    result = {
        "input": input_path,
        "output": output_path,
        "device": device_name(device),
        "replace_source": bool(replace_source),
        "elapsed_seconds": elapsed,
        "stage_seconds": timer.seconds(),
    }
    result.update(extra_fields or {})
    return result


# --------------------------------------------------------------------------
# Effect builders: operands resolved on the device once per video
# --------------------------------------------------------------------------

def grade_effect(config: GradeConfig, device, *, lut=None,
                 ref_stats=None) -> Effect:
    """``effect(batch, first_frame_index)`` running ``config`` on
    ``device``, with the LUT and reference statistics resolved there
    once."""
    operands = prepare_operands(config, lut=lut, ref_stats=ref_stats,
                                device=resolve_device(device))

    def effect(batch: torch.Tensor, frame_index: int) -> torch.Tensor:
        return grade_prepared(batch, config, *operands,
                              frame_start=frame_index)

    return effect


def _lut_effect(lut_name, strength, luts_dir, device) -> tuple[Effect, str]:
    lut = GLOBAL_LUT_CACHE.load(paths.safe_lut_path(lut_name, luts_dir))
    effect = grade_effect(GradeConfig(lut=LUTParams.normalize(strength)),
                          device, lut=lut)
    return effect, os.path.basename(str(lut_name))


def _grain_effect(grain_intensity, saturation_mix, seed, device) -> Effect:
    params = GrainParams.normalize(grain_intensity, saturation_mix, seed or 0)
    return grade_effect(GradeConfig(grain=params), device)


def _adjust_effect(settings, device) -> Effect:
    return grade_effect(
        GradeConfig(adjust=AdjustSettings.normalize(settings)), device)


def _load_reference_image(reference_image) -> np.ndarray:
    """A reference image path (read as Pillow reads it) or array ->
    (1, H, W, 3) float32 RGB in [0,1]."""
    if isinstance(reference_image, (str, os.PathLike)):
        return _read_image(paths.resolve_media_path(reference_image,
                                                    "Reference image"))
    ref = np.asarray(reference_image, np.float32)
    return ref[None] if ref.ndim == 3 else ref


# --------------------------------------------------------------------------
# Public appliers (reference-parity surface)
# --------------------------------------------------------------------------

def apply_lut_to_video(input_path, lut_name, output_path="", strength=10.0,
                       batch_size=8, replace_source=False, thumbnail_path="",
                       preserve_audio=True, encode_crf=23,
                       encode_preset="medium", luts_dir=None, *,
                       device="cuda") -> dict:
    effect, lut_base = _lut_effect(lut_name, strength, luts_dir, device)
    return _apply_effect_to_video(
        input_path, effect, tag=lut_base, device=device,
        output_path=output_path, batch_size=batch_size,
        replace_source=replace_source, thumbnail_path=thumbnail_path,
        preserve_audio=preserve_audio, encode_crf=encode_crf,
        encode_preset=encode_preset,
        extra_fields={"lut": lut_base, "strength": float(strength)})


def apply_lut_to_image(input_path, lut_name, output_path="", strength=10.0,
                       replace_source=False, luts_dir=None, *,
                       device="cuda") -> dict:
    effect, lut_base = _lut_effect(lut_name, strength, luts_dir, device)
    return _apply_effect_to_image(
        input_path, effect, tag=lut_base, device=device,
        output_path=output_path, replace_source=replace_source,
        extra_fields={"lut": lut_base, "strength": float(strength)})


def apply_film_grain_to_video(input_path, output_path="",
                              grain_intensity=0.04, saturation_mix=0.5,
                              seed=None, batch_size=8, replace_source=False,
                              thumbnail_path="", preserve_audio=True,
                              encode_crf=26, encode_preset="medium", *,
                              device="cuda") -> dict:
    effect = _grain_effect(grain_intensity, saturation_mix, seed, device)
    return _apply_effect_to_video(
        input_path, effect, tag="grain", device=device,
        output_path=output_path, batch_size=batch_size,
        replace_source=replace_source, thumbnail_path=thumbnail_path,
        preserve_audio=preserve_audio, encode_crf=encode_crf,
        encode_preset=encode_preset,
        extra_fields={"grain_intensity": float(grain_intensity),
                      "saturation_mix": float(saturation_mix),
                      "seed": seed})


def apply_film_grain_to_image(input_path, output_path="",
                              grain_intensity=0.04, saturation_mix=0.5,
                              seed=None, replace_source=False, *,
                              device="cuda") -> dict:
    effect = _grain_effect(grain_intensity, saturation_mix, seed, device)
    return _apply_effect_to_image(
        input_path, effect, tag="grain", device=device,
        output_path=output_path, replace_source=replace_source,
        extra_fields={"grain_intensity": float(grain_intensity),
                      "saturation_mix": float(saturation_mix),
                      "seed": seed})


def apply_adjust_to_video(input_path, output_path="", settings=None,
                          batch_size=8, replace_source=False,
                          thumbnail_path="", preserve_audio=True,
                          encode_crf=23, encode_preset="medium", *,
                          device="cuda") -> dict:
    effect = _adjust_effect(settings, device)
    normalized = AdjustSettings.normalize(settings)
    return _apply_effect_to_video(
        input_path, effect, tag="adjust", device=device,
        output_path=output_path, batch_size=batch_size,
        replace_source=replace_source, thumbnail_path=thumbnail_path,
        preserve_audio=preserve_audio, encode_crf=encode_crf,
        encode_preset=encode_preset,
        extra_fields={"settings": normalized.to_dict()})


def apply_adjust_to_image(input_path, output_path="", settings=None,
                          replace_source=False, *, device="cuda") -> dict:
    effect = _adjust_effect(settings, device)
    normalized = AdjustSettings.normalize(settings)
    return _apply_effect_to_image(
        input_path, effect, tag="adjust", device=device,
        output_path=output_path, replace_source=replace_source,
        extra_fields={"settings": normalized.to_dict()})


def grade_config(*, lut=None, lut_strength=10.0, adjust=None,
                 ref_stats=None, match_strength=1.0, sharpen_strength=0.0,
                 sharpen_kind="unsharp", sharpen_border="zero",
                 grain_intensity=0.0, saturation_mix=0.5, seed=0,
                 fused_mode="eager") -> GradeConfig:
    """The :class:`GradeConfig` :func:`grade_video` builds from its
    arguments: a stage is on when its operand or strength is given."""
    return GradeConfig(
        lut=LUTParams.normalize(lut_strength) if lut is not None else None,
        adjust=(AdjustSettings.normalize(adjust)
                if adjust is not None else None),
        color_match=(ColorMatchParams.normalize(match_strength)
                     if ref_stats is not None else None),
        sharpen=(SharpenParams.normalize(sharpen_strength,
                                         border=sharpen_border,
                                         kind=sharpen_kind)
                 if sharpen_strength and sharpen_strength > 0 else None),
        grain=(GrainParams.normalize(grain_intensity, saturation_mix, seed)
               if grain_intensity and grain_intensity > 0 else None),
        fused_mode=str(fused_mode or "eager"),
    )


def grade_video(input_path, output_path="", *, lut_name=None,
                lut_strength=10.0, adjust=None, reference_image=None,
                match_strength=1.0, sharpen_strength=0.0,
                sharpen_kind="unsharp", sharpen_border="zero",
                grain_intensity=0.0, saturation_mix=0.5, seed=0,
                batch_size=8, replace_source=False, thumbnail_path="",
                preserve_audio=True, encode_crf=23, encode_preset="medium",
                luts_dir=None, fused_mode="eager", device="cuda") -> dict:
    """The full-stack video grade: every enabled stage per frame batch on
    ``device``.  ``fused_mode="fused"`` runs the two CUDA kernels (needs
    LUT + colour match + unsharp/zero enabled)."""
    device = resolve_device(device)
    lut = None
    lut_base = None
    if lut_name:
        lut = GLOBAL_LUT_CACHE.load(paths.safe_lut_path(lut_name, luts_dir))
        lut_base = os.path.basename(str(lut_name))

    ref_stats = None
    if reference_image is not None:
        reference = torch.from_numpy(_load_reference_image(reference_image))
        ref_stats = lab_statistics(reference.to(device))

    config = grade_config(
        lut=lut, lut_strength=lut_strength, adjust=adjust,
        ref_stats=ref_stats, match_strength=match_strength,
        sharpen_strength=sharpen_strength, sharpen_kind=sharpen_kind,
        sharpen_border=sharpen_border, grain_intensity=grain_intensity,
        saturation_mix=saturation_mix, seed=seed, fused_mode=fused_mode)
    effect = grade_effect(config, device, lut=lut, ref_stats=ref_stats)
    return _apply_effect_to_video(
        input_path, effect, tag="graded", device=device,
        output_path=output_path, batch_size=batch_size,
        replace_source=replace_source, thumbnail_path=thumbnail_path,
        preserve_audio=preserve_audio, encode_crf=encode_crf,
        encode_preset=encode_preset,
        extra_fields={"lut": lut_base,
                      "fused_mode": config.fused_mode,
                      "stages": [name for name, on in [
                          ("lut", config.lut), ("adjust", config.adjust),
                          ("color_match", config.color_match),
                          ("sharpen", config.sharpen),
                          ("grain", config.grain)] if on is not None]})


# --------------------------------------------------------------------------
# Previews (first frame of a video, or the image itself -> JPEG pair)
# --------------------------------------------------------------------------

def _preview_media(input_path, effect: Effect, device, base=None) -> dict:
    input_path = paths.resolve_media_path(input_path, "Media")
    ext = os.path.splitext(input_path)[1].lower()
    if ext in paths.SUPPORTED_VIDEO_EXTENSIONS:
        import cv2

        capture = cv2.VideoCapture(input_path)
        try:
            ok, frame = capture.read()
        finally:
            capture.release()
        if not ok:
            raise RuntimeError("Could not decode the first video frame.")
        array = frame[..., ::-1].astype(np.float32)[None] / 255.0
    elif ext in paths.SUPPORTED_IMAGE_EXTENSIONS:
        array = _read_image(input_path)
    else:
        raise ValueError("Unsupported media type for preview.")

    out = _run_effect(effect, array, device)
    token = f"preview_{int(time.time() * 1000)}"
    folder = paths.preview_root(base)
    before = os.path.join(folder, f"{token}_before.jpg")
    after = os.path.join(folder, f"{token}_after.jpg")
    image_io.write_rgb(before, (np.clip(array[0], 0, 1) * 255).astype(np.uint8))
    image_io.write_rgb(after, (np.clip(out[0], 0, 1) * 255).astype(np.uint8))
    return {"before": before, "after": after}


def preview_lut_on_media(input_path, lut_name, strength=10.0, luts_dir=None,
                         base=None, *, device="cuda") -> dict:
    effect, _ = _lut_effect(lut_name, strength, luts_dir, device)
    return _preview_media(input_path, effect, device, base)


def preview_film_grain_on_media(input_path, grain_intensity=0.04,
                                saturation_mix=0.5, seed=None, base=None, *,
                                device="cuda") -> dict:
    return _preview_media(
        input_path,
        _grain_effect(grain_intensity, saturation_mix, seed, device),
        device, base)


def preview_adjust_on_media(input_path, settings=None, base=None, *,
                            device="cuda") -> dict:
    return _preview_media(input_path, _adjust_effect(settings, device),
                          device, base)


def delete_preview(path, base=None) -> bool:
    folder = paths.preview_root(base)
    path = os.path.abspath(str(path or ""))
    if os.path.commonpath([folder, path]) != folder or not os.path.isfile(path):
        return False
    os.remove(path)
    return True
