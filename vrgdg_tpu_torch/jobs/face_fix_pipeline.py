"""Standalone Face Fix pipeline: the in-memory (node-graph) variant.

Counterpart of :mod:`vrgdg_tpu.jobs.face_fix_pipeline`: the Face Fix
capability over an in-memory BHWC batch (the job engine over video files
is :mod:`vrgdg_tpu_torch.jobs.face_fix`), as pure functions around a
:class:`FaceFixContext`:

    prepare -> (store enhanced anchors | create crop video)
            -> collect_ltx_inputs -> composite

- per-frame detect/track with EMA ``prev*0.35 + cur*0.65``, a
  configurable ``short_gap_tracking`` carry at strengths 0.65 then 0.30,
  distance-based repair strength and close-face exclusion;
- 512x512 bicubic crops, gap frames filled with the nearest valid crop in
  both directions;
- anchors: evenly spaced targets snapped to the nearest *fresh* detected
  frame with positive strength; the %8 legality mapping happens later in
  :func:`collect_ltx_inputs`;
- store/create: deterministic-order anchor PNGs and the near-lossless 512
  crop MP4;
- composite: radial-feather paste-back with mean-shift colour match and
  the ±7 LTX temporal tolerance
  (:func:`vrgdg_tpu_torch.ops.paste_back.radial_face_composite`).

The frames stay on their device (``"cuda"`` for a numpy batch unless the
caller asks for ``"cpu"``): the detector's uint8 BGR frames come down in
one download a batch, and the crops, the anchors and the composite are
torch ops on the device.  The detector is the same pluggable
``(bgr_frame, region) -> detections`` callable as the job engine's.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.paste_back import radial_face_composite
from ..ops.resize import resample
from ..runtime.batch_stream import resolve_device
from .face_fix import (DetectorFn, ENHANCE_SIZE, detect_with_rotation,
                       distance_repair_strength, initial_regions,
                       load_default_detector, select_tracked, smooth_box,
                       square_crop_box, _encode_crop_video)
from .prepare_restore import safe_conditioning_indices, save_image_batch


@dataclass
class FaceFixContext:
    """The ``FACE_FIX_CONTEXT`` equivalent."""

    job_id: str
    original_frames: torch.Tensor      # BHWC [0,1] on the device (untouched)
    entries: list[dict]                # per frame: box/fresh/strength/...
    anchor_indices: list[int]
    frame_count: int
    width: int
    height: int
    extras: dict = field(default_factory=dict)


def _frames_on_device(video_frames, device) -> torch.Tensor:
    """A BHWC batch as float32 on ``device``; a tensor stays on its own
    device when ``device`` is None, a numpy batch goes to ``"cuda"``."""
    if isinstance(video_frames, torch.Tensor):
        target = video_frames.device if device is None else device
    else:
        target = "cuda" if device is None else device
        video_frames = torch.from_numpy(np.asarray(video_frames, np.float32))
    return video_frames.to(device=resolve_device(target), dtype=torch.float32)


def prepare_face_pipeline(video_frames, detector: DetectorFn | None = None, *,
                          device=None,
                          detection_confidence: float = 0.70,
                          crop_padding: float = 0.10,
                          minimum_face_pixels: int = 20,
                          rotation_assist: str = "light",
                          repair_distance: str = "far",
                          custom_distance_threshold: float = 9.0,
                          anchor_interval: int = 16,
                          short_gap_tracking: int = 2):
    """Track one primary face through a BHWC [0,1] batch; returns
    ``(crop_batch, anchor_batch, context)`` where ``crop_batch`` is the
    (N, 512, 512, 3) tracked face sequence (gap frames carry the nearest
    valid crop) and ``anchor_batch`` the selected anchor crops, both on
    the frames' device."""
    frames = _frames_on_device(video_frames, device)
    if frames.ndim != 4 or frames.shape[0] < 1:
        raise ValueError(
            "Face Fix Prepare requires a non-empty BHWC frame batch.")
    if detector is None:
        detector = load_default_detector()
    count, height, width = (int(v) for v in frames.shape[:3])
    # the detector's frames, quantized on the device, one download
    bgr_batch = torch.clamp(torch.round(frames[..., :3] * 255.0), 0,
                            255).to(torch.uint8).flip(-1).cpu().numpy()

    entries: list[dict] = []
    crops: list = [None] * count
    previous = None
    misses = 0
    close_skipped = 0
    for index in range(count):
        bgr = bgr_batch[index]
        candidates = detect_with_rotation(
            detector, bgr, float(detection_confidence),
            initial_regions(width, height), rotation_assist)
        candidates = [c for c in candidates
                      if min(c[2], c[3]) >= int(minimum_face_pixels)]
        chosen = select_tracked(candidates, previous, width, height,
                                int(minimum_face_pixels))
        fresh = chosen is not None
        if fresh:
            previous, misses = smooth_box(previous, chosen), 0
        else:
            misses += 1
        # strength ladder: live hit 1.0, coasted frames 0.65 then 0.30
        # while within the carry window, lapsed 0.0
        coasting = previous is not None and misses <= int(short_gap_tracking)
        if fresh:
            tracking_strength = 1.0
        elif coasting:
            tracking_strength = {1: 0.65}.get(misses, 0.30)
        else:
            previous, tracking_strength = None, 0.0
        face_width_percent = (float(previous[2]) / width * 100.0
                              if previous is not None else 0.0)
        dist_strength = (distance_repair_strength(
            face_width_percent, repair_distance, custom_distance_threshold)
            if previous is not None else 0.0)
        strength = tracking_strength * dist_strength
        if fresh and dist_strength <= 0.0:
            close_skipped += 1
        box = (square_crop_box(previous, width, height, float(crop_padding))
               if previous is not None else None)
        if box is not None:
            left, top, right, bottom = box
            crop = frames[index:index + 1, top:bottom, left:right, :3]
            crops[index] = torch.clamp(
                resample(crop, ENHANCE_SIZE, ENHANCE_SIZE, "bicubic")[0],
                0.0, 1.0)
        entries.append({
            "index": index, "box": list(box) if box else None,
            "fresh": fresh, "strength": float(strength),
            "tracking_strength": float(tracking_strength),
            "distance_strength": float(dist_strength),
            "face_width_percent": float(face_width_percent),
        })

    valid = [i for i, crop in enumerate(crops) if crop is not None]
    if not valid:
        raise ValueError("No face was detected in the video. Lower "
                         "confidence or minimum face pixels.")
    # fill gap frames with the nearest valid crop: backward from the first
    # valid, then forward
    last = crops[valid[0]]
    for i in range(count):
        if crops[i] is None:
            crops[i] = last
        else:
            last = crops[i]

    step = max(1, int(anchor_interval))
    desired = list(range(0, count, step))
    if desired[-1] != count - 1:
        desired.append(count - 1)
    fresh_indices = [e["index"] for e in entries
                     if e["fresh"] and e["strength"] > 0.0]
    if not fresh_indices:
        raise ValueError(
            "Faces were detected, but none are small enough for the "
            "selected Repair Distance preset. Choose a broader preset or "
            "All detected faces.")
    anchors: list[int] = []
    for target in desired:
        nearest = min(fresh_indices, key=lambda v: abs(v - target))
        if nearest not in anchors:
            anchors.append(nearest)
    anchors.sort()

    crop_batch = torch.stack(crops)
    anchor_batch = crop_batch[torch.tensor(anchors, device=frames.device)]
    context = FaceFixContext(
        job_id=(f"standalone_{time.strftime('%Y%m%d_%H%M%S')}_"
                f"{uuid.uuid4().hex[:8]}"),
        original_frames=frames, entries=entries,
        anchor_indices=anchors, frame_count=int(count),
        width=int(width), height=int(height))
    return crop_batch, anchor_batch, context


def store_enhanced_anchors(enhanced_anchors, context: FaceFixContext,
                           job_folder: str) -> str:
    """Validate count and persist enhanced anchors in deterministic order:
    the shared guided-enhance store with the face-fix folder name."""
    from .prepare_restore import store_enhanced_anchors as _store

    return _store(enhanced_anchors, context, job_folder,
                  folder_name="enhanced_anchors_512")


def create_crop_video(crop_batch, context: FaceFixContext, fps: float,
                      job_folder: str) -> str:
    """Encode the 512 face sequence to the silent near-lossless MP4 LTX
    consumes."""
    frames_folder = os.path.join(job_folder, "face_video_frames_512")
    save_image_batch(crop_batch, frames_folder, "frame")
    output_path = os.path.join(job_folder, "face_video_512.mp4")
    _encode_crop_video(frames_folder, output_path, float(fps),
                       int(crop_batch.shape[0]))
    context.extras["crop_video_path"] = output_path
    context.extras["fps"] = float(fps)
    return output_path


def collect_ltx_inputs(crop_context: FaceFixContext,
                       anchor_context: FaceFixContext) -> dict:
    """Execution barrier: validate both branches belong to one job, the
    artifacts exist, the anchor count matches, and map anchor positions
    to LTX-legal indices."""
    if (not crop_context.job_id
            or crop_context.job_id != anchor_context.job_id):
        raise ValueError("The cropped video and enhanced anchors belong to "
                         "different Face Fix jobs.")
    video_path = str(crop_context.extras.get("crop_video_path") or "")
    folder = str(anchor_context.extras.get("enhanced_anchor_folder") or "")
    if not os.path.isfile(video_path):
        raise FileNotFoundError(
            f"The cropped Face Fix video is missing: {video_path}")
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"The enhanced Face Fix anchor folder is missing: {folder}")
    files = sorted(name for name in os.listdir(folder)
                   if name.lower().endswith(".png"))
    indices = list(anchor_context.anchor_indices)
    if len(files) != len(indices):
        raise ValueError(f"Enhanced anchor folder contains {len(files)} "
                         f"images; expected {len(indices)}.")
    safe = safe_conditioning_indices(indices, crop_context.frame_count)
    crop_context.extras["enhanced_anchor_folder"] = folder
    crop_context.anchor_indices = safe
    return {
        "crop_video_path": video_path,
        "enhanced_anchor_folder": folder,
        "anchor_indices": safe,
        "anchor_indices_text": ",".join(str(i) for i in safe),
        "anchor_count": len(safe),
        "context": crop_context,
    }


def composite_repaired(ltx_face_frames, context: FaceFixContext,
                       feather_pixels: int = 18, color_match: float = 0.65):
    """Radial-feather the repaired 512 frames back into the originals, on
    the originals' device; returns ``(frames, masks, repaired_count)``."""
    originals = context.original_frames
    faces = torch.as_tensor(ltx_face_frames).to(device=originals.device,
                                                dtype=originals.dtype)
    return radial_face_composite(
        faces, originals, context.entries,
        feather_pixels=int(feather_pixels), color_match=float(color_match))


def run_face_fix_pipeline(video_frames, model_fn, detector=None,
                          job_folder: str | None = None, fps: float = 24.0,
                          feather_pixels: int = 18,
                          color_match: float = 0.65, **prepare_kwargs):
    """Full prepare -> enhance -> composite flow with a pluggable model.

    ``model_fn(crop_batch, anchor_batch, safe_indices) -> repaired_512``
    stands in for the reference's Z-Image + LTX queue stages.  When
    ``job_folder`` is given the on-disk artifacts (anchor PNGs, crop MP4)
    are produced exactly like the node pipeline; otherwise the flow stays
    in memory.  ``device`` goes to :func:`prepare_face_pipeline` with the
    other prepare keywords.
    """
    crop_batch, anchor_batch, context = prepare_face_pipeline(
        video_frames, detector, **prepare_kwargs)
    if job_folder:
        store_enhanced_anchors(anchor_batch, context, job_folder)
        create_crop_video(crop_batch, context, fps, job_folder)
        safe = collect_ltx_inputs(context, context)["anchor_indices"]
    else:
        safe = safe_conditioning_indices(context.anchor_indices,
                                         context.frame_count)
    repaired = model_fn(crop_batch, anchor_batch, safe)
    return composite_repaired(repaired, context, feather_pixels, color_match)
