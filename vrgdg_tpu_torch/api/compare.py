"""Compare appliers: render A/B comparison media to disk.

Counterpart of :mod:`vrgdg_tpu.api.compare`: the same parameters and
result fields, with the five modes of :mod:`vrgdg_tpu_torch.ops.compare`
running on an explicit device.  Images are read and written as Pillow
would (:mod:`vrgdg_tpu_torch.runtime.image_io`); clips are frame-paired,
truncated to the shorter input, uploaded as uint8 and converted on the
device.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.compare import MODES, render_compare
from ..runtime import image_io, profiling, video_io
from . import paths
from .appliers import (_read_image, _write_thumbnail, device_name,
                       ffmpeg_browser_encode, resolve_device)


def _default_output(path_a: str, mode: str, ext: str) -> str:
    stem = os.path.splitext(path_a)[0]
    return f"{stem}_compare_{mode}{ext}"


def _check_mode(mode) -> str:
    mode = str(mode or "slider").lower()
    if mode not in MODES:
        raise ValueError(f"Unknown compare mode '{mode}'. Use one of {MODES}.")
    return mode


def compare_images(input_a, input_b, mode: str = "slider", output_path="",
                   slider_position: float = 0.5, overlay_opacity: float = 0.5,
                   difference_gain: float = 1.0, *, device="cuda") -> dict:
    """Render one comparison image from two input images."""
    device = resolve_device(device)
    path_a = paths.resolve_media_path(input_a, "Compare input A")
    path_b = paths.resolve_media_path(input_b, "Compare input B")
    mode = _check_mode(mode)
    output_path = os.path.abspath(
        str(output_path or "").strip().strip('"')
        or _default_output(path_a, mode, ".png"))
    os.makedirs(os.path.dirname(output_path), exist_ok=True)

    started = time.perf_counter()
    a, b = (torch.from_numpy(_read_image(p)).to(device)
            for p in (path_a, path_b))
    # blink has no single-image rendering: fall back to side_by_side
    render_mode = "side_by_side" if mode == "blink" else mode
    out = render_compare(a, b, render_mode,
                         slider_position=slider_position,
                         overlay_opacity=overlay_opacity,
                         difference_gain=difference_gain)
    u8 = np.clip(out.cpu().numpy()[0] * 255.0, 0, 255).astype(np.uint8)
    image_io.write_rgb(output_path, u8)
    return {
        "input_a": path_a,
        "input_b": path_b,
        "mode": mode,
        "output": output_path,
        "device": device_name(device),
        "width": int(u8.shape[1]),
        "height": int(u8.shape[0]),
        "elapsed_seconds": time.perf_counter() - started,
    }


def compare_videos(input_a, input_b, mode: str = "slider", output_path="",
                   slider_position: float = 0.5, overlay_opacity: float = 0.5,
                   difference_gain: float = 1.0, blink_speed: float = 1.0,
                   batch_size: int = 8, encode_crf: int = 23,
                   encode_preset: str = "medium", *, device="cuda") -> dict:
    """Render one comparison clip from two input videos (frame-paired,
    truncated to the shorter input).  ``stage_seconds`` splits the wall
    time into decode, device (upload, render, quantize, download) and
    encode."""
    device = resolve_device(device)
    path_a = video_io.normalize_video_path(input_a)
    path_b = video_io.normalize_video_path(input_b)
    mode = _check_mode(mode)
    output_path = os.path.abspath(
        str(output_path or "").strip().strip('"')
        or _default_output(path_a, mode, ".mp4"))
    os.makedirs(os.path.dirname(output_path), exist_ok=True)

    meta_a = video_io.probe_video(path_a)
    meta_b = video_io.probe_video(path_b)
    fps = meta_a["fps"]
    frame_count = min(meta_a["frame_count"], meta_b["frame_count"])
    started = time.perf_counter()
    counters = {"frames": 0}
    timer = profiling.StageTimer()

    # output geometry is analytic (B letterboxes onto A's geometry):
    # side_by_side adds B's width plus the 2px separator
    out_h = int(meta_a["height"])
    out_w = int(meta_a["width"]) * 2 + 2 if mode == "side_by_side" \
        else int(meta_a["width"])

    def upload(batch: np.ndarray) -> torch.Tensor:
        return video_io.dequantize_on_device(torch.from_numpy(batch).to(device))

    def producer():
        counters["frames"] = 0
        reader_a = video_io.VideoReader(path_a, batch_size=batch_size,
                                        end_frame=frame_count, as_float=False)
        reader_b = video_io.VideoReader(path_b, batch_size=batch_size,
                                        end_frame=frame_count, as_float=False)
        with reader_a, reader_b:
            pairs = zip(iter(reader_a), iter(reader_b))
            while True:
                with timer.stage("decode"):
                    item = next(pairs, None)
                if item is None:
                    break
                (start_a, batch_a), (_, batch_b) = item
                with timer.stage("device"):
                    out = render_compare(
                        upload(batch_a), upload(batch_b), mode,
                        slider_position=slider_position,
                        overlay_opacity=overlay_opacity,
                        difference_gain=difference_gain, fps=fps,
                        blink_speed=blink_speed, frame_start=start_a)
                    u8 = video_io.quantize_on_device(out).cpu().numpy()
                counters["frames"] += u8.shape[0]
                with timer.stage("encode"):
                    yield u8

    codec = video_io.write_video_with_fallback(output_path, fps, out_w,
                                               out_h, producer)
    ffmpeg_result = ffmpeg_browser_encode(output_path, "", encode_crf,
                                          encode_preset)
    elapsed = time.perf_counter() - started
    return {
        "input_a": path_a,
        "input_b": path_b,
        "mode": mode,
        "output": output_path,
        "device": device_name(device),
        "width": out_w,
        "height": out_h,
        "fps": fps,
        "processed_frames": counters["frames"],
        "elapsed_seconds": elapsed,
        "processed_fps": counters["frames"] / elapsed if elapsed else 0.0,
        "encoder": (ffmpeg_result.get("encoder") if ffmpeg_result.get("ok")
                    else f"cv2:{codec}"),
        "browser_friendly": bool(ffmpeg_result.get("ok")),
        "thumbnail_path": _write_thumbnail(output_path),
        "stage_seconds": timer.seconds(),
    }
