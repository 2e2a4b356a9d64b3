"""Guided-enhancement prepare/restore math (the LTX "anchor" pipeline).

Counterpart of the math of :mod:`vrgdg_tpu.jobs.prepare_restore`, over
BHWC float32 torch tensors on their own device.  The reference wraps an
external diffusion model with deterministic prepare/restore stages
(``VRGDG_VideoEnhanceNodes.py:170-419``); the model in the middle is a
pluggable callback:

- anchor index selection ``range(0, N, interval)`` plus a forced final
  frame (``:210-213``),
- dimension rounding to a model-friendly multiple (``:39-42``),
- the LTX-forbidden conditioning rule: indices with ``index % 8 == 1`` are
  replaced by the nearest free in-range index within ±8 (``:336-349``),
- restore with ±7 frame-count tolerance, inverse letterbox back to the
  exact source resolution, source-tail preservation, and an
  ``enhancement_strength`` blend with the untouched originals (``:394-419``).

The anchor PNG helpers read and write as the original's Pillow calls do,
through :mod:`vrgdg_tpu_torch.runtime.image_io`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.params import round_dimension
from ..ops.resize import resize_batch, restore_batch
from ..runtime import image_io

FRAME_COUNT_TOLERANCE = 7


def anchor_indices(frame_count: int, interval: int) -> list[int]:
    """Evenly spaced anchors with the final frame always included
    (``VRGDG_VideoEnhanceNodes.py:210-213``)."""
    frame_count = int(frame_count)
    interval = max(1, int(interval))
    indices = list(range(0, frame_count, interval))
    if not indices or indices[-1] != frame_count - 1:
        indices.append(frame_count - 1)
    return indices


def safe_conditioning_indices(indices: list[int], frame_count: int) -> list[int]:
    """Adjust LTX-incompatible positions (``index % 8 == 1``) to the nearest
    unused legal index within ±8 (``VRGDG_VideoEnhanceNodes.py:336-349``)."""
    safe: list[int] = []
    used: set[int] = set()
    for original in indices:
        candidates = [original]
        for distance in range(1, 9):
            candidates.extend((original - distance, original + distance))
        chosen = next(
            (c for c in candidates
             if 0 <= c < frame_count and c not in used and c % 8 != 1),
            None)
        if chosen is None:
            raise ValueError(
                f"Could not find a safe LTX conditioning position near "
                f"anchor {original}.")
        safe.append(chosen)
        used.add(chosen)
    return safe


@dataclass
class EnhanceContext:
    """The ``VIDEO_ENHANCE_CONTEXT`` equivalent: everything restore needs,
    including the untouched originals (``VRGDG_VideoEnhanceNodes.py:231-249``)."""

    original_frames: torch.Tensor
    source_width: int
    source_height: int
    frame_count: int
    fps: float
    anchor_indices: list[int]
    anchor_width: int
    anchor_height: int
    working_width: int
    working_height: int
    fit_mode: str
    resize_method: str
    extras: dict = field(default_factory=dict)


def prepare(video_frames: torch.Tensor, *, anchor_interval: int = 16,
            anchor_width: int = 768, anchor_height: int = 432,
            working_width: int = 960, working_height: int = 544,
            dimension_multiple: int = 32,
            fit_mode: str = "letterbox", resize_method: str = "bicubic",
            fps: float = 24.0) -> tuple[torch.Tensor, torch.Tensor, EnhanceContext]:
    """Build working frames + anchors and the restore context.

    Returns ``(working_frames, anchor_images, context)``; the caller runs
    its enhancement model on these and hands the result to :func:`restore`.
    """
    if video_frames.ndim != 4 or video_frames.shape[0] < 1:
        raise ValueError("prepare requires a non-empty BHWC frame batch.")
    frame_count, source_height, source_width = map(int, video_frames.shape[:3])
    anchor_width = round_dimension(anchor_width, dimension_multiple)
    anchor_height = round_dimension(anchor_height, dimension_multiple)
    working_width = round_dimension(working_width, dimension_multiple)
    working_height = round_dimension(working_height, dimension_multiple)

    indices = anchor_indices(frame_count, anchor_interval)
    working = resize_batch(video_frames, working_width, working_height,
                           fit_mode, resize_method)
    anchor_source = video_frames[torch.tensor(indices,
                                              device=video_frames.device)]
    anchors = resize_batch(anchor_source, anchor_width, anchor_height,
                           fit_mode, resize_method)
    context = EnhanceContext(
        original_frames=video_frames,
        source_width=source_width, source_height=source_height,
        frame_count=frame_count, fps=float(fps),
        anchor_indices=indices,
        anchor_width=anchor_width, anchor_height=anchor_height,
        working_width=working_width, working_height=working_height,
        fit_mode=fit_mode, resize_method=resize_method)
    return working, anchors, context


def restore(enhanced_frames: torch.Tensor, context: EnhanceContext,
            resize_method: str | None = None,
            enhancement_strength: float = 1.0) -> torch.Tensor:
    """Restore model output to the exact source resolution and frame count
    (``VRGDG_VideoEnhanceNodes.py:394-419``): tolerate up to ±7 frames of
    drift, inverse-letterbox, preserve unmatched source-tail frames, and
    blend with the originals by ``enhancement_strength``."""
    originals = context.original_frames
    frame_count = context.frame_count
    delta = frame_count - int(enhanced_frames.shape[0])
    if abs(delta) > FRAME_COUNT_TOLERANCE:
        raise ValueError(
            f"The model returned {enhanced_frames.shape[0]} frames for "
            f"{frame_count} source frames.")
    restored = restore_batch(
        enhanced_frames, context.source_width, context.source_height,
        context.fit_mode, resize_method or context.resize_method)
    usable = min(frame_count, int(restored.shape[0]))
    strength = float(enhancement_strength)
    blended = (originals[:usable, ..., :3] * (1.0 - strength)
               + restored[:usable, ..., :3] * strength)
    output = originals.clone()
    output[:usable, ..., :3] = blended
    return torch.clamp(output, 0.0, 1.0)


IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def _host(images) -> np.ndarray:
    """A BHWC batch (torch tensor on any device, or array) as numpy."""
    if isinstance(images, torch.Tensor):
        return images.detach().cpu().numpy()
    return np.asarray(images)


def save_image_batch(images, folder: str, prefix: str) -> list[str]:
    """Persist a BHWC [0,1] batch as deterministic-order PNGs, clearing any
    previous media files first (``VRGDG_VideoEnhanceNodes.py:109-118``).

    Names are ``{prefix}_{index:06d}.png`` so lexical order == batch order.
    Values are rounded to the nearest level (the appliers truncate).
    """
    os.makedirs(folder, exist_ok=True)
    for name in os.listdir(folder):
        if os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS:
            os.remove(os.path.join(folder, name))
    paths = []
    array = np.clip(_host(images)[..., :3], 0.0, 1.0)
    for index in range(array.shape[0]):
        u8 = np.round(array[index] * 255.0).astype("uint8")
        path = os.path.join(folder, f"{prefix}_{index:06d}.png")
        image_io.write_rgb(path, u8)
        paths.append(path)
    return paths


def iter_anchor_images(directory: str):
    """Incremental anchor loading (``VRGDG_VideoEnhanceNodes.py:143-167``):
    returns ``(width, height, count, frames)`` where ``frames`` is a lazy
    generator of HWC float32 [0,1] arrays in deterministic (sorted) order,
    each EXIF-transposed and resized with Pillow's LANCZOS to the first
    image's size (taken after its transpose).
    """
    files = sorted(
        os.path.join(directory, name) for name in os.listdir(directory)
        if os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS)
    if not files:
        raise FileNotFoundError(
            f"No Video Enhance anchor images were found in {directory}")
    height, width = image_io.read_rgb_exif_transposed(files[0]).shape[:2]

    def frames():
        for path in files:
            image = image_io.pil_lanczos_resize(
                image_io.read_rgb_exif_transposed(path), width, height)
            yield image.astype(np.float32) / 255.0

    return width, height, len(files), frames()


def load_anchor_batches(directory: str, batch_size: int):
    """Meta-batch-style chunked loading: yields BHWC float32 arrays of up
    to ``batch_size`` anchors in deterministic order, decoding lazily (the
    VHS BatchManager pattern, ``VRGDG_VideoEnhanceNodes.py:272-292``)."""
    import itertools

    _, _, _, frames = iter_anchor_images(directory)
    batch_size = max(1, int(batch_size))
    while True:
        chunk = list(itertools.islice(frames, batch_size))
        if not chunk:
            return
        yield np.stack(chunk, axis=0)


def store_enhanced_anchors(enhanced_anchors, context, job_folder: str,
                           folder_name: str = "enhanced_anchors") -> str:
    """Validate and persist enhanced anchors in deterministic order
    (``VRGDG_VideoEnhanceNodes.py:310-319``): the count must match the
    prepared anchor indices exactly.  Returns the folder and records it in
    ``context.extras["enhanced_anchor_folder"]``.

    ``context`` is any object with ``anchor_indices`` and ``extras``.
    """
    expected = len(context.anchor_indices)
    got = int(enhanced_anchors.shape[0])
    if got != expected:
        raise ValueError(
            f"The enhancer returned {got} anchors; expected {expected}.")
    folder = os.path.join(job_folder, folder_name)
    save_image_batch(enhanced_anchors, folder, "anchor")
    context.extras["enhanced_anchor_folder"] = folder
    return folder


def persist_prepare(working_frames, anchors, context: EnhanceContext,
                    job_folder: str) -> dict:
    """Write the prepare artifacts to disk the way the reference's node
    does (``VRGDG_VideoEnhanceNodes.py:215-230``): anchor-source PNGs,
    working-frame PNGs, and a near-lossless working MP4 (ffmpeg libx264
    CRF10 when available, else the cv2 codec chain).  Paths are recorded
    in ``context.extras`` and returned."""
    import subprocess

    from ..runtime import video_io

    os.makedirs(job_folder, exist_ok=True)
    anchor_folder = os.path.join(job_folder, "anchor_sources")
    frames_folder = os.path.join(job_folder, "ltx_working_frames")
    save_image_batch(anchors, anchor_folder, "anchor")
    save_image_batch(working_frames, frames_folder, "frame")
    video_path = os.path.join(job_folder, "ltx_working_video.mp4")
    ffmpeg = video_io.find_ffmpeg()
    if ffmpeg is not None:
        command = [
            ffmpeg, "-y", "-framerate", f"{context.fps:.12g}",
            "-i", os.path.join(frames_folder, "frame_%06d.png"),
            "-frames:v", str(int(context.frame_count)), "-an",
            "-c:v", "libx264", "-preset", "slow", "-crf", "10",
            "-pix_fmt", "yuv420p", "-movflags", "+faststart", video_path,
        ]
        result = subprocess.run(command, capture_output=True, text=True,
                                errors="replace", check=False)
        if result.returncode != 0 or not os.path.isfile(video_path):
            raise RuntimeError(
                "Could not create the Video Enhance working MP4: "
                + (result.stderr or result.stdout or "unknown")[-1600:])
    else:
        array = _host(working_frames)

        def produce():
            for index in range(array.shape[0]):
                yield array[index:index + 1]

        video_io.write_video_with_fallback(
            video_path, context.fps, context.working_width,
            context.working_height, produce)
    context.extras.update(
        job_folder=job_folder, anchor_sources_folder=anchor_folder,
        ltx_frames_folder=frames_folder, ltx_video_path=video_path)
    return {"job_folder": job_folder,
            "anchor_sources_folder": anchor_folder,
            "ltx_frames_folder": frames_folder,
            "ltx_video_path": video_path}


def run_guided_enhance(video_frames: torch.Tensor,
                       model_fn: Callable[[torch.Tensor, torch.Tensor,
                                           list[int]], torch.Tensor],
                       enhancement_strength: float = 1.0,
                       **prepare_kwargs) -> torch.Tensor:
    """Full prepare -> model -> restore pipeline with a pluggable model.

    ``model_fn(working_frames, anchors, safe_indices) -> enhanced_frames``
    stands in for the reference's LTX + Z-Image queue stages.
    """
    working, anchors, context = prepare(video_frames, **prepare_kwargs)
    safe = safe_conditioning_indices(context.anchor_indices,
                                     context.frame_count)
    enhanced = model_fn(working, anchors, safe)
    return restore(enhanced, context,
                   enhancement_strength=enhancement_strength)
