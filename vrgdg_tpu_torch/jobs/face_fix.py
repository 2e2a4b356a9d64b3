"""Face Fix: the manifest-driven distant-face repair engine.

Counterpart of :mod:`vrgdg_tpu.jobs.face_fix`.  Everything but the
composite is host code (cv2, numpy, JSON), copied from the original,
which cannot be imported without JAX:

- geometry and tracking: IoU dedup, expanded re-scan windows, the
  0.60w x 0.70h region tiling, rotation assist off/light/strong, the
  distance-based repair strength presets, tracked selection, EMA box
  smoothing, the shift-in-bounds square crop;
- LTX-safe anchor indices (nearest free non-(8n+1) position per anchor);
- prepare: the per-frame tracking loop with a <=2-frame carry at
  strengths 1.0/0.65/0.30, run segmentation, per-run crop video and
  anchors, and the manifest;
- the accept endpoints (enhanced crop, enhanced anchor, LTX frames with
  the +/-7 frame tolerance and the preserved tail) and the LTX input
  contract;
- finalize: the per-frame ellipse composite
  (:func:`vrgdg_tpu_torch.ops.paste_back.ellipse_composite`) as torch ops
  on ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``), then an
  FFV1 intermediate + libx264 CRF16 with the source's audio, or the cv2
  codec chain where ffmpeg or FFV1 is missing.

The detector is pluggable: any callable ``(bgr_frame, region) ->
[(x, y, w, h, score), ...]`` in frame coordinates.
:func:`load_default_detector` wires cv2.dnn (res10 caffe, then YuNet)
from the repository's ``assets/`` folder (``VRGDG_TPU_ASSETS`` overrides
it); tests inject synthetic detectors.
"""

from __future__ import annotations

import base64
import json
import math
import os
import shutil
import subprocess
import time
import uuid
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..runtime import video_io
from ..runtime.batch_stream import resolve_device
from ..runtime.profiling import StageTimer

DetectorFn = Callable[[np.ndarray, tuple[int, int, int, int]],
                      list[tuple[float, float, float, float, float]]]

ENHANCE_SIZE = 512
MAX_RANGE_FRAMES = 1800
SMOOTH_ALPHA = 0.65
IOU_DEDUP = 0.35

_DISTANCE_RANGES = {
    "very_far": (4.0, 6.0),
    "far": (7.0, 9.0),
    "far_medium": (10.0, 12.0),
}


# --------------------------------------------------------------------------
# Geometry / tracking primitives (VRGDG_FaceFix.py:35-262)
# --------------------------------------------------------------------------

def box_iou(a, b) -> float:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    inter = (max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
             * max(0.0, min(ay + ah, by + bh) - max(ay, by)))
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def expanded_region(box, width: int, height: int,
                    scale: float = 4.0) -> tuple[int, int, int, int]:
    """Square re-scan window around the last tracked face.

    Behavior spec (``:43-51``): a square of side ``scale`` x the box's
    long edge, centered on the box, rounded to pixels, clipped to the
    frame, and kept at least 1 px wide/tall even for degenerate input.
    """
    x, y, w, h = box
    half = 0.5 * scale * max(w, h)
    center = (x + 0.5 * w, y + 0.5 * h)
    lo = [int(round(c - half)) for c in center]
    hi = [int(round(c + half)) for c in center]
    left, top = max(lo[0], 0), max(lo[1], 0)
    right, bottom = min(hi[0], width), min(hi[1], height)
    return (left, top, max(right, left + 1), max(bottom, top + 1))


def initial_regions(width: int, height: int) -> list[tuple[int, int, int, int]]:
    """Full frame plus four 60%x70% corner tiles for frames at least
    600x400 (``:54-64`` — note the face-fix tiling differs from Modern
    Face Crop's 60%x60% at 600x600)."""
    regions = [(0, 0, width, height)]
    if width >= 600 and height >= 400:
        tw, th = int(round(width * 0.60)), int(round(height * 0.70))
        regions += [(0, 0, tw, th), (width - tw, 0, width, th),
                    (0, height - th, tw, height),
                    (width - tw, height - th, width, height)]
    return regions


def dedup_detections(found: Sequence[tuple]) -> list[tuple]:
    kept: list[tuple] = []
    for item in sorted(found, key=lambda v: v[4], reverse=True):
        if not any(box_iou(item[:4], other[:4]) > IOU_DEDUP for other in kept):
            kept.append(item)
    return kept


def detect_in_regions(detector: DetectorFn, frame: np.ndarray,
                      confidence: float, regions) -> list[tuple]:
    found = []
    height, width = frame.shape[:2]
    for region in regions:
        left, top, right, bottom = region
        if right - left < 8 or bottom - top < 8:
            continue
        for x, y, w, h, score in detector(frame, region):
            if score < confidence:
                continue
            x = max(left, int(round(x)))
            y = max(top, int(round(y)))
            x2 = min(right, int(round(x + w)))
            y2 = min(bottom, int(round(y + h)))
            if x2 > x and y2 > y:
                found.append((float(x), float(y), float(x2 - x),
                              float(y2 - y), float(score)))
    return dedup_detections(found)


ROTATION_MODES = {"off": (0,), "light": (0, -15, 15),
                  "strong": (0, -15, 15, -30, 30)}


def _unrotate_box(box: tuple, inverse: np.ndarray,
                  width: int, height: int) -> tuple | None:
    """Map an axis-aligned box through an inverse affine: transform all
    four corners, take their axis-aligned hull, clip to the frame.
    Returns None when the clipped hull collapses."""
    x, y, w, h = box
    xs = np.array([x, x + w, x, x + w], np.float64)
    ys = np.array([y, y, y + h, y + h], np.float64)
    mx = inverse[0, 0] * xs + inverse[0, 1] * ys + inverse[0, 2]
    my = inverse[1, 0] * xs + inverse[1, 1] * ys + inverse[1, 2]
    left, right = np.clip([mx.min(), mx.max()], 0.0, float(width))
    top, bottom = np.clip([my.min(), my.max()], 0.0, float(height))
    if right <= left or bottom <= top:
        return None
    return (float(left), float(top), float(right - left),
            float(bottom - top))


def detect_with_rotation(detector: DetectorFn, frame: np.ndarray,
                         confidence: float, regions,
                         rotation_assist: str = "light") -> list[tuple]:
    """Rotate-scan-unrotate assist for tilted faces (behavior of
    ``:116-157``); rotated passes re-scan the standard tiling and their
    scores carry a tiny per-degree penalty so upright detections win
    ties."""
    angles = ROTATION_MODES.get(str(rotation_assist or "light").lower(),
                                ROTATION_MODES["light"])
    found = list(detect_in_regions(detector, frame, confidence, regions))
    tilted = [a for a in angles if a != 0]
    if not tilted:
        return found  # detect_in_regions output is already deduped

    import cv2

    height, width = frame.shape[:2]
    full_scan = initial_regions(width, height)
    for angle in tilted:
        matrix = cv2.getRotationMatrix2D((width / 2.0, height / 2.0),
                                         float(angle), 1.0)
        rotated = cv2.warpAffine(frame, matrix, (width, height),
                                 flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_REPLICATE)
        inverse = cv2.invertAffineTransform(matrix)
        tilt_penalty = abs(angle) * 0.0001
        for detection in detect_in_regions(detector, rotated, confidence,
                                           full_scan):
            hull = _unrotate_box(detection[:4], inverse, width, height)
            if hull is not None:
                found.append(hull + (detection[4] - tilt_penalty,))
    return dedup_detections(found)


def distance_repair_strength(face_width_percent: float, preset: str,
                             custom_threshold: float) -> float:
    """Repair strength by how distant (small) the face is (``:160-179``):
    full strength below the preset's near edge, fading to zero at the far
    edge; "all" repairs everything, "custom" fades over the 2% below the
    given threshold."""
    preset = str(preset or "far").lower()
    if preset == "all":
        return 1.0
    if preset == "custom":
        far = max(0.1, float(custom_threshold))
        near = max(0.0, far - 2.0)
    else:
        near, far = _DISTANCE_RANGES.get(preset, _DISTANCE_RANGES["far"])
    # linear fade from 1 at the near edge to 0 at the far edge, clamped
    ramp = (far - float(face_width_percent)) / max(0.001, far - near)
    return min(1.0, max(0.0, ramp))


def select_tracked(candidates, previous, frame_width: int, frame_height: int,
                   minimum_pixels: int):
    """Pick the detection that continues the current track (``:182-198``):
    IoU continuity x3 + confidence, penalized by normalized center travel
    x4 and log-area change x0.35."""
    candidates = [c for c in candidates
                  if min(c[2], c[3]) >= minimum_pixels]
    if not candidates:
        return None
    if previous is None:
        return max(candidates, key=lambda c: c[4])
    px, py, pw, ph = previous
    pcx, pcy = px + pw / 2.0, py + ph / 2.0
    diag = max(1.0, math.hypot(frame_width, frame_height))

    def score(item):
        x, y, w, h, conf = item
        cx, cy = x + w / 2.0, y + h / 2.0
        distance = math.hypot(cx - pcx, cy - pcy) / diag
        size_delta = abs(math.log(max(1.0, w * h) / max(1.0, pw * ph)))
        return (box_iou(previous, item[:4]) * 3.0 + conf
                - distance * 4.0 - size_delta * 0.35)

    return max(candidates, key=score)


def smooth_box(previous, current, alpha: float = SMOOTH_ALPHA):
    """EMA box smoothing, alpha toward the new detection (``:201-204``)."""
    if previous is None:
        return tuple(float(v) for v in current[:4])
    return tuple(previous[i] * (1.0 - alpha) + float(current[i]) * alpha
                 for i in range(4))


class Observation(NamedTuple):
    """One frame's tracking outcome (see :class:`FaceTracker`)."""
    chosen: tuple | None   # (x, y, w, h, score) to composite, or None
    detected: bool         # a real detection (not a carried ghost)
    misses: int            # consecutive carried frames incl. this one
    strength: float        # tracking-strength ladder value

    @property
    def carried(self) -> bool:
        return self.chosen is not None and not self.detected


class FaceTracker:
    """Temporal single-face track with bounded dropout carry.

    Independent re-derivation of the tracking *behavior* of
    the reference's ``VRGDG_FaceFix.py:411-475``, expressed as explicit
    track state instead of loop-local counters. The contract:

    - a hit resets the carry counter, opens a new run when the track was
      dormant (run ids increase globally across the clip), and EMA-smooths
      the track box toward the detection;
    - a miss while a track is live is tolerated for up to ``CARRY_LIMIT``
      consecutive frames by re-issuing the current track box as a
      zero-confidence ghost at decaying strength (``CARRY_STRENGTH``);
    - one more miss drops the track and closes the run.
    """

    CARRY_LIMIT = 2
    #: tracking-strength ladder: index = carried frames so far (a real
    #: detection is strength 1.0, a lapsed track 0.0).
    CARRY_STRENGTH = (0.65, 0.30)

    def __init__(self) -> None:
        self.box: tuple | None = None     # last smoothed (x, y, w, h)
        self.misses = 0                   # carried frames in a row
        self.run_id: int | None = None    # open run, None while dormant
        self.runs_opened = 0
        self.carried_frames = 0
        self.skipped_frames = 0

    def search_regions(self, width: int, height: int) -> list[tuple]:
        """Where to look next frame: the standard tiling when dormant, a
        4.5x window around the track otherwise (``:424-427``)."""
        if self.box is None:
            return initial_regions(width, height)
        return [expanded_region(self.box, width, height, 4.5)]

    def observe(self, hit: tuple | None) -> Observation:
        """Advance the track by one frame given the selected detection
        (or None) and return what to composite."""
        if hit is not None:
            if self.run_id is None:
                self.run_id = self.runs_opened
                self.runs_opened += 1
            self.misses = 0
            self.box = smooth_box(self.box, hit)
            return Observation(hit, True, 0, 1.0)
        if self.box is not None and self.misses < self.CARRY_LIMIT:
            ghost = (*self.box, 0.0)
            strength = self.CARRY_STRENGTH[self.misses]
            self.misses += 1
            self.carried_frames += 1
            # Reference arithmetic smooths the box toward the ghost too
            # (a float-exact no-op only up to EMA rounding).
            self.box = smooth_box(self.box, ghost)
            return Observation(ghost, False, self.misses, strength)
        self.box = None
        self.misses = 0
        self.run_id = None
        self.skipped_frames += 1
        return Observation(None, False, 0, 0.0)


def square_crop_box(face_box, width: int, height: int,
                    padding: float) -> tuple[int, int, int, int]:
    """Padded square crop translated (never shrunk) to fit the frame.

    Behavior of ``:207-226``: the square's side is the larger face edge
    grown by ``padding`` per side, capped at the frame's short edge; the
    square is centered on the face, then each axis is clamped into
    ``[0, frame - side]`` — a translation, since the cap guarantees fit.
    """
    x, y, face_w, face_h = face_box
    side = min(max(face_w, face_h) * (1.0 + 2.0 * max(0.0, padding)),
               width, height)
    edge = int(round(side))
    left = int(round(x + face_w / 2.0 - side / 2.0))
    top = int(round(y + face_h / 2.0 - side / 2.0))
    left = min(max(left, 0), width - edge)
    top = min(max(top, 0), height - edge)
    return (left, top, left + edge, top + edge)


def is_forbidden_ltx_index(index: int) -> bool:
    return int(index) % 8 == 1


def safe_ltx_indices(indices, frame_count: int) -> list[int]:
    """Nearest-free non-(8n+1) index per anchor over the whole run
    (``:233-251``); silently drops anchors with no legal position left."""
    count = max(0, int(frame_count or 0))
    if count <= 0:
        return []
    safe: list[int] = []
    used: set[int] = set()
    for raw in indices or []:
        original = max(0, min(count - 1, int(raw)))
        candidates = sorted(
            (i for i in range(count)
             if not is_forbidden_ltx_index(i) and i not in used),
            key=lambda i: (abs(i - original), i))
        if not candidates:
            continue
        safe.append(candidates[0])
        used.add(candidates[0])
    return safe


def face_fix_anchor_indices(frame_count: int, interval) -> list[int]:
    """Evenly spaced anchors + forced last frame, mapped to LTX-safe
    positions (``:254-262``)."""
    count = max(0, int(frame_count or 0))
    if count <= 0:
        return []
    step = min(240, max(1, int(interval or 16)))
    # the grid plus the forced last frame, deduped via the set union
    anchors = sorted({*range(0, count, step), count - 1})
    return safe_ltx_indices(anchors, count)


# --------------------------------------------------------------------------
# Detector loading
# --------------------------------------------------------------------------

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ASSETS_DIR = os.environ.get(
    "VRGDG_TPU_ASSETS", os.path.join(os.path.dirname(_PACKAGE_ROOT), "assets"))


def load_default_detector(assets_dir: str | None = None) -> DetectorFn:
    """cv2.dnn res10 caffe detector, falling back to YuNet, from the
    assets folder (``:378-409``).  Raises when no model files exist."""
    import cv2

    assets = assets_dir or DEFAULT_ASSETS_DIR
    config_path = os.path.join(assets, "opencv_face_deploy.prototxt")
    model_path = os.path.join(assets, "opencv_face_res10_fp16.caffemodel")
    yunet_path = os.path.join(assets, "face_detection_yunet_2023mar.onnx")

    if os.path.isfile(config_path) and os.path.isfile(model_path):
        net = cv2.dnn.readNetFromCaffe(config_path, model_path)

        def caffe_detector(frame, region):
            left, top, right, bottom = region
            patch = frame[top:bottom, left:right]
            h, w = patch.shape[:2]
            blob = cv2.dnn.blobFromImage(
                cv2.resize(patch, (300, 300)), 1.0, (300, 300),
                (104.0, 177.0, 123.0), swapRB=False, crop=False)
            net.setInput(blob)
            out = []
            for det in net.forward()[0, 0]:
                out.append((left + float(det[3]) * w, top + float(det[4]) * h,
                            (float(det[5]) - float(det[3])) * w,
                            (float(det[6]) - float(det[4])) * h,
                            float(det[2])))
            return out

        return caffe_detector

    if os.path.isfile(yunet_path):
        creator = getattr(cv2, "FaceDetectorYN", None)
        create = getattr(creator, "create", None) if creator else None
        if not callable(create):
            create = getattr(cv2, "FaceDetectorYN_create", None)
        if callable(create):
            net = create(yunet_path, "", (320, 320), 0.1, 0.3, 5000)

            def yunet_detector(frame, region):
                left, top, right, bottom = region
                patch = frame[top:bottom, left:right]
                h, w = patch.shape[:2]
                net.setInputSize((w, h))
                result = net.detect(patch)
                faces = result[1] if isinstance(result, tuple) else result
                out = []
                for det in () if faces is None else faces:
                    out.append((left + float(det[0]), top + float(det[1]),
                                float(det[2]), float(det[3]),
                                float(det[-1])))
                return out

            return yunet_detector

    raise RuntimeError(
        "Face Fix could not load a compatible OpenCV face detector — "
        f"place the res10 caffe or YuNet ONNX model in {assets}.")


# --------------------------------------------------------------------------
# Payload helpers
# --------------------------------------------------------------------------

def _existing_file(value, label: str) -> str:
    path = os.path.abspath(os.path.normpath(str(value or "").strip()
                                            .strip('"')))
    if not path or not os.path.isfile(path):
        raise FileNotFoundError(f"{label} was not found: {path}")
    return path


def _project_folder(value, video_path: str) -> str:
    raw = str(value or "").strip().strip('"')
    folder = (os.path.abspath(os.path.normpath(raw)) if raw
              else os.path.dirname(video_path))
    os.makedirs(folder, exist_ok=True)
    return folder


def _number(payload, key, default) -> float:
    value = payload.get(key)
    if value is None or str(value).strip() == "":
        return float(default)
    return float(value)


def _jpeg_data_url(path: str) -> str:
    try:
        import cv2

        image = cv2.imread(path)
        ok, buffer = cv2.imencode(".jpg", image,
                                  [cv2.IMWRITE_JPEG_QUALITY, 88])
        if ok:
            return ("data:image/jpeg;base64,"
                    + base64.b64encode(buffer.tobytes()).decode("ascii"))
    except Exception:
        pass
    return ""


def _load_manifest(payload) -> tuple[str, dict]:
    manifest_path = _existing_file(payload.get("manifest_path"),
                                   "Face Fix manifest")
    if os.path.basename(manifest_path).lower() != "manifest.json":
        raise ValueError("Invalid Face Fix manifest path.")
    parts = [p.lower() for p in os.path.normpath(manifest_path).split(os.sep)]
    if "face_fix" not in parts or "jobs" not in parts:
        raise ValueError("The manifest is not inside a Face Fix job folder.")
    with open(manifest_path, "r", encoding="utf-8") as handle:
        return manifest_path, json.load(handle)


def _save_manifest(manifest_path: str, manifest: dict) -> None:
    temp = manifest_path + ".tmp"
    with open(temp, "w", encoding="utf-8") as handle:
        json.dump(manifest, handle, indent=2)
    os.replace(temp, manifest_path)


def _resolve_image_path(image_info) -> str:
    """Accept either a plain path string or a ``{"path": ...}`` dict (the
    reference resolves ComfyUI image metadata here; standalone, the caller
    supplies the file directly)."""
    if isinstance(image_info, str):
        return _existing_file(image_info, "Generated image")
    if isinstance(image_info, dict) and image_info.get("path"):
        return _existing_file(image_info["path"], "Generated image")
    raise ValueError("Generated image metadata is missing.")


# --------------------------------------------------------------------------
# estimate / prepare
# --------------------------------------------------------------------------

def estimate_anchors(payload) -> dict:
    """Anchor plan for a time range without running detection
    (``:283-315``)."""
    video_path = _existing_file(payload.get("video_path"), "Scene video")
    meta = video_io.probe_video(video_path)
    fps, total_frames = meta["fps"], meta["frame_count"]
    if fps <= 0 or total_frames <= 0:
        raise RuntimeError("The scene video has invalid frame metadata.")
    if bool(payload.get("whole_scene", False)):
        start_frame, end_frame = 0, total_frames - 1
    else:
        start_time = max(0.0, _number(payload, "in_time", 0.0))
        end_time = max(start_time, _number(payload, "out_time", start_time))
        start_frame = min(max(0, int(math.floor(start_time * fps))),
                          total_frames - 1)
        end_frame = min(max(start_frame, int(math.ceil(end_time * fps))),
                        total_frames - 1)
    frame_count = end_frame - start_frame + 1
    interval = min(240, max(1, int(_number(payload, "anchor_interval", 16))))
    indices = face_fix_anchor_indices(frame_count, interval)
    return {
        "fps": fps, "total_video_frames": total_frames,
        "start_frame": start_frame, "end_frame": end_frame,
        "frame_count": frame_count,
        "anchor_interval": interval, "anchor_count": len(indices),
        "anchor_indices": indices,
        "anchor_indices_text": ",".join(str(i) for i in indices),
    }


def prepare_face_fix(payload, detector: DetectorFn | None = None) -> dict:
    """The detection/tracking prepare pass (``:318-638``): track one face
    through the selected range (2-frame carry at fading strengths),
    segment contiguous face runs, write original frames + 512x512 LANCZOS4
    crops, pick LTX-safe anchors per run, encode per-run crop videos, and
    persist the whole plan as ``manifest.json``."""
    import cv2

    video_path = _existing_file(payload.get("video_path"), "Scene video")
    project_folder = _project_folder(payload.get("project_folder"),
                                     video_path)
    start_time = max(0.0, _number(payload, "in_time", 0.0))
    end_time = max(start_time, _number(payload, "out_time", start_time))
    whole_scene = bool(payload.get("whole_scene", False))
    preview_only = str(payload.get("mode") or "range") == "frame"
    confidence = max(0.1, min(0.99, _number(payload, "confidence", 0.70)))
    padding = max(0.0, min(2.0, _number(payload, "crop_padding_factor", 0.10)))
    minimum_pixels = max(4, int(_number(payload, "minimum_face_pixels", 20)))
    rotation_assist = str(payload.get("rotation_assist") or "light").lower()
    repair_distance = str(payload.get("repair_distance") or "far").lower()
    custom_threshold = max(0.1, min(50.0, _number(
        payload, "custom_distance_threshold", 9.0)))
    ltx_settings = {
        "guiding_strength": max(0.0, min(2.0, _number(
            payload, "ltx_guiding_strength", 0.20))),
        "temporal_overlap_cond_strength": max(0.0, min(2.0, _number(
            payload, "ltx_temporal_overlap_cond_strength", 0.50))),
        "cond_image_strength": max(0.0, min(2.0, _number(
            payload, "ltx_cond_image_strength", 0.50))),
        "seed": max(0, int(payload.get("seed") or 42)),
        "sampler": str(payload.get("ltx_sampler")
                       or "euler_ancestral").strip(),
        "sigmas": str(payload.get("ltx_sigmas")
                      or "0.909375, 0.725, 0.421875, 0.0").strip(),
    }

    meta = video_io.probe_video(video_path)
    fps = meta["fps"]
    total_frames = meta["frame_count"]
    width, height = meta["width"], meta["height"]
    if whole_scene and not preview_only:
        start_time = 0.0
        end_time = max(0.0, (total_frames - 1) / fps)
        start_frame, end_frame = 0, max(0, total_frames - 1)
    else:
        start_frame = min(max(0, int(math.floor(start_time * fps))),
                          max(0, total_frames - 1))
        end_frame = (start_frame if preview_only
                     else min(max(start_frame, int(math.ceil(end_time * fps))),
                              max(0, total_frames - 1)))
    if end_frame - start_frame + 1 > MAX_RANGE_FRAMES:
        raise ValueError(
            f"Face Fix currently supports at most {MAX_RANGE_FRAMES:,} "
            "frames per range.")

    if detector is None:
        detector = load_default_detector()

    job_id = f"face_fix_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
    job_folder = os.path.join(project_folder, "face_fix", "jobs", job_id)
    originals_folder = os.path.join(job_folder, "original_frames")
    crops_folder = os.path.join(job_folder, "crops_512")
    enhanced_folder = os.path.join(job_folder, "enhanced_512")
    for folder in (originals_folder, crops_folder, enhanced_folder):
        os.makedirs(folder, exist_ok=True)

    capture = cv2.VideoCapture(video_path)
    if not capture.isOpened():
        raise RuntimeError(f"Could not open scene video: {video_path}")
    capture.set(cv2.CAP_PROP_POS_FRAMES, start_frame)

    entries: list[dict] = []
    tracker = FaceTracker()
    close_skipped_frames = 0
    try:
        for frame_number in range(start_frame, end_frame + 1):
            ok, frame = capture.read()
            if not ok:
                break
            candidates = detect_with_rotation(
                detector, frame, confidence,
                tracker.search_regions(width, height), rotation_assist)
            obs = tracker.observe(
                select_tracked(candidates, tracker.box, width, height,
                               minimum_pixels))

            base_name = f"frame_{frame_number:06d}.png"
            original_path = os.path.join(originals_folder, base_name)
            cv2.imwrite(original_path, frame)
            entry = {
                "index": len(entries),
                "frame_number": frame_number,
                "time": frame_number / fps,
                "original_path": original_path,
                "detected": obs.detected,
                "carried": obs.carried,
                "missed_count": obs.misses if obs.carried else 0,
                "run_index": tracker.run_id,
                "confidence": (float(obs.chosen[4])
                               if obs.chosen is not None else 0.0),
                # strength fields default to zero; overwritten below
                # whenever a face is being tracked this frame
                "tracking_strength": 0.0,
                "distance_strength": 0.0,
                "face_width_percent": 0.0,
                "composite_strength": 0.0,
            }
            if obs.chosen is not None:
                face_width_percent = float(tracker.box[2]) / width * 100.0
                dist_strength = distance_repair_strength(
                    face_width_percent, repair_distance, custom_threshold)
                entry["tracking_strength"] = obs.strength
                entry["distance_strength"] = dist_strength
                entry["face_width_percent"] = face_width_percent
                entry["composite_strength"] = obs.strength * dist_strength
                if obs.detected and dist_strength <= 0.0:
                    close_skipped_frames += 1
                crop_box = square_crop_box(tracker.box, width, height,
                                           padding)
                left, top, right, bottom = crop_box
                crop = frame[top:bottom, left:right]
                resized = cv2.resize(crop, (ENHANCE_SIZE, ENHANCE_SIZE),
                                     interpolation=cv2.INTER_LANCZOS4)
                crop_path = os.path.join(crops_folder, base_name)
                cv2.imwrite(crop_path, resized)
                entry.update({
                    "crop_path": crop_path,
                    "enhanced_path": os.path.join(enhanced_folder, base_name),
                    "crop_box": list(crop_box),
                    "face_box": [round(v, 3) for v in tracker.box],
                })
            entries.append(entry)
    finally:
        capture.release()
    if not entries:
        raise RuntimeError(
            "No frames were extracted from the selected Face Fix range.")

    anchor_interval = max(1, min(240, int(payload.get("anchor_interval")
                                          or 16)))
    runs: list[dict] = []
    anchors: list[dict] = []
    for run_index in range(tracker.runs_opened):
        run_entries = [e for e in entries if e.get("run_index") == run_index]
        if not run_entries:
            continue
        run_folder = os.path.join(job_folder, "runs", f"run_{run_index:03d}")
        run_crops = os.path.join(run_folder, "crop_frames_512")
        run_anchor_sources = os.path.join(run_folder, "anchor_sources_512")
        run_enhanced_anchors = os.path.join(run_folder,
                                            "enhanced_anchors_512")
        run_ltx_frames = os.path.join(run_folder, "ltx_frames_512")
        for folder in (run_crops, run_anchor_sources, run_enhanced_anchors,
                       run_ltx_frames):
            os.makedirs(folder, exist_ok=True)
        for local_index, entry in enumerate(run_entries):
            entry["run_local_index"] = local_index
            shutil.copy2(entry["crop_path"],
                         os.path.join(run_crops,
                                      f"frame_{local_index:06d}.png"))
        desired = face_fix_anchor_indices(len(run_entries), anchor_interval)
        detected_indices = [
            i for i, e in enumerate(run_entries)
            if e.get("detected") and float(e.get("composite_strength")
                                           or 0.0) > 0.0]
        safe_detected = [i for i in detected_indices
                         if not is_forbidden_ltx_index(i)]
        if safe_detected:
            detected_indices = safe_detected
        selected: list[int] = []
        for want in desired:
            if not detected_indices:
                break
            pick = min(detected_indices, key=lambda i: (abs(i - want), i))
            if pick not in selected:
                selected.append(pick)
        if not selected:
            continue
        run_anchors = []
        for order, local_index in enumerate(selected):
            entry = run_entries[local_index]
            name = f"anchor_{order:04d}_index_{local_index:06d}.png"
            source_path = os.path.join(run_anchor_sources, name)
            enhanced_path = os.path.join(run_enhanced_anchors, name)
            shutil.copy2(entry["crop_path"], source_path)
            anchor = {
                "run_index": run_index, "order": order, "index": local_index,
                "entry_index": entry["index"],
                "frame_number": entry["frame_number"],
                "source_path": source_path, "enhanced_path": enhanced_path,
            }
            run_anchors.append(anchor)
            anchors.append(anchor)
        crop_video_path = os.path.join(run_folder, "face_crops_512.mp4")
        _encode_crop_video(run_crops, crop_video_path, fps,
                           len(run_entries))
        runs.append({
            "run_index": run_index,
            "start_entry_index": run_entries[0]["index"],
            "end_entry_index": run_entries[-1]["index"],
            "start_frame": run_entries[0]["frame_number"],
            "end_frame": run_entries[-1]["frame_number"],
            "frame_count": len(run_entries), "crop_video_path": crop_video_path,
            "anchor_indices": selected,
            "anchor_indices_text": ",".join(str(i) for i in selected),
            "anchor_sources_folder": run_anchor_sources,
            "enhanced_anchors_folder": run_enhanced_anchors,
            "ltx_frames_folder": run_ltx_frames, "anchors": run_anchors,
        })
    if not runs:
        if close_skipped_frames > 0:
            raise ValueError(
                "Faces were detected, but none are distant enough for the "
                "selected Repair Distance preset. Choose a broader preset "
                "or All detected faces.")
        raise ValueError("No face was detected in the selected Face Fix "
                         "range.")

    manifest = {
        "version": 1, "job_id": job_id,
        "video_path": video_path,
        "project_folder": project_folder, "job_folder": job_folder,
        "fps": fps, "width": width, "height": height,
        "total_video_frames": total_frames,
        "start_frame": start_frame,
        "end_frame": entries[-1]["frame_number"],
        "start_time": start_time, "end_time": end_time,
        "whole_scene": whole_scene and not preview_only,
        "enhance_size": ENHANCE_SIZE,
        "anchor_interval": anchor_interval,
        "face_run_count": len(runs),
        "runs": runs,
        "anchors": anchors,
        "ltx_settings": ltx_settings,
        "carried_frames": tracker.carried_frames,
        "skipped_frames": tracker.skipped_frames,
        "close_skipped_frames": close_skipped_frames,
        "settings": {
            "confidence": confidence,
            "crop_padding_factor": padding,
            "minimum_face_pixels": minimum_pixels,
            "rotation_assist": rotation_assist,
            "repair_distance": repair_distance,
            "custom_distance_threshold": custom_threshold,
            "enhance_amount": max(1, min(20, int(_number(
                payload, "enhance_amount", 8)))),
        },
        "entries": entries,
    }
    manifest_path = os.path.join(job_folder, "manifest.json")
    _save_manifest(manifest_path, manifest)

    first_face = next(e for e in entries if e.get("crop_path"))
    return {
        "job_id": job_id, "job_folder": job_folder,
        "manifest_path": manifest_path,
        "frame_count": len(entries), "fps": fps,
        "start_frame": start_frame,
        "end_frame": entries[-1]["frame_number"],
        "carried_frames": tracker.carried_frames,
        "skipped_frames": tracker.skipped_frames,
        "close_skipped_frames": close_skipped_frames,
        "face_run_count": len(runs),
        "runs": runs,
        "anchor_interval": anchor_interval,
        "anchor_count": len(anchors),
        "anchors": anchors,
        "ltx_settings": ltx_settings,
        "first_crop_path": first_face["crop_path"],
        "crop_preview_data": _jpeg_data_url(first_face["crop_path"]),
        "crops": [{"index": e["index"], "frame_number": e["frame_number"],
                   "crop_path": e["crop_path"]}
                  for e in entries if e.get("crop_path")],
    }


def _encode_crop_video(crops_folder: str, output_path: str, fps: float,
                       frame_count: int) -> str:
    """Near-lossless 512x512 crop video: ffmpeg libx264 CRF10 when
    available (``:265-280``), else the cv2 codec-fallback chain."""
    ffmpeg = video_io.find_ffmpeg()
    if ffmpeg is not None:
        command = [
            ffmpeg, "-y", "-framerate", f"{float(fps):.12g}",
            "-start_number", "0",
            "-i", os.path.join(crops_folder, "frame_%06d.png"),
            "-frames:v", str(int(frame_count)),
            "-an", "-c:v", "libx264", "-preset", "slow", "-crf", "10",
            "-pix_fmt", "yuv420p", "-movflags", "+faststart", output_path,
        ]
        done = subprocess.run(command, capture_output=True, text=True,
                              errors="replace", check=False)
        if done.returncode != 0 or not os.path.isfile(output_path):
            raise RuntimeError(
                "Could not create the 512x512 Face Fix crop video: "
                + (done.stderr or done.stdout or "unknown")[-1600:])
        return output_path

    import cv2

    def produce():
        for index in range(int(frame_count)):
            frame = cv2.imread(os.path.join(crops_folder,
                                            f"frame_{index:06d}.png"))
            if frame is None:
                raise RuntimeError(f"Missing crop frame {index}.")
            yield video_io.frames_to_array([frame])

    video_io.write_video_with_fallback(output_path, fps, ENHANCE_SIZE,
                                       ENHANCE_SIZE, produce)
    return output_path


# --------------------------------------------------------------------------
# accept endpoints
# --------------------------------------------------------------------------

def _picked(items, raw_index, what: str) -> int:
    """Bounds-checked index into a manifest list (shared by the accept/
    collect endpoints; IndexError text matches the reference routes)."""
    index = int(-1 if raw_index is None else raw_index)
    if not 0 <= index < len(items):
        raise IndexError(f"Face Fix {what} is out of range: {index}")
    return index


def accept_enhanced_crop(payload) -> dict:
    """Collect one externally enhanced 512 crop into the manifest
    (``:641-687``)."""
    manifest_path, manifest = _load_manifest(payload)
    entries = manifest.get("entries") or []
    index = _picked(entries, payload.get("index", -1), "crop index")
    source_path = _resolve_image_path(payload.get("image"))
    target_path = os.path.abspath(str(entries[index].get("enhanced_path")
                                      or ""))
    enhanced_root = os.path.abspath(os.path.join(manifest["job_folder"],
                                                 "enhanced_512"))
    if os.path.commonpath([enhanced_root, target_path]) != enhanced_root:
        raise ValueError("Enhanced crop path escapes the Face Fix job "
                         "folder.")
    os.makedirs(os.path.dirname(target_path), exist_ok=True)
    shutil.copy2(source_path, target_path)
    entries[index]["enhanced_source"] = source_path
    entries[index]["enhanced_complete"] = True
    manifest["enhanced_count"] = sum(
        1 for e in entries if e.get("enhanced_complete"))
    _save_manifest(manifest_path, manifest)
    return {
        "index": index,
        "frame_number": entries[index].get("frame_number"),
        "enhanced_path": target_path,
        "enhanced_count": manifest["enhanced_count"],
        "frame_count": len(entries),
        "enhanced_preview_data": _jpeg_data_url(target_path),
    }


def accept_enhanced_anchor(payload) -> dict:
    """Collect one enhanced anchor for a run (``:690-743``)."""
    manifest_path, manifest = _load_manifest(payload)
    runs = manifest.get("runs") or []
    run_index = _picked(runs, payload.get("run_index", -1), "run index")
    anchors = runs[run_index].get("anchors") or []
    order = _picked(anchors, payload.get("order", -1), "anchor order")
    source_path = _resolve_image_path(payload.get("image"))
    target_path = os.path.abspath(str(anchors[order].get("enhanced_path")
                                      or ""))
    enhanced_root = os.path.abspath(str(
        runs[run_index].get("enhanced_anchors_folder") or ""))
    if (not enhanced_root
            or os.path.commonpath([enhanced_root, target_path])
            != enhanced_root):
        raise ValueError("Enhanced anchor path escapes the Face Fix job "
                         "folder.")
    os.makedirs(os.path.dirname(target_path), exist_ok=True)
    shutil.copy2(source_path, target_path)
    anchors[order]["enhanced_source"] = source_path
    anchors[order]["enhanced_complete"] = True
    manifest["enhanced_anchor_count"] = sum(
        1 for run in runs for a in (run.get("anchors") or [])
        if a.get("enhanced_complete"))
    _save_manifest(manifest_path, manifest)
    return {
        "run_index": run_index, "order": order,
        "index": anchors[order].get("index"),
        "frame_number": anchors[order].get("frame_number"),
        "enhanced_path": target_path,
        "enhanced_anchor_count": manifest["enhanced_anchor_count"],
        "anchor_count": sum(len(run.get("anchors") or [])
                            for run in runs),
        "enhanced_preview_data": _jpeg_data_url(target_path),
    }


def build_ltx_inputs(payload) -> dict:
    """The pipeline contract the reference feeds its LTX workflow
    (``:746-793``): the run's crop video, enhanced-anchor folder, LTX-safe
    conditioning indices re-validated against the run length, and the
    sampler settings.  The reference patches these into a bundled ComfyUI
    workflow JSON; the workflow itself is out of scope (SURVEY.md section
    2.5), so any external enhancer consumes this dict instead."""
    manifest_path, manifest = _load_manifest(payload)
    runs = manifest.get("runs") or []
    run_index = _picked(runs, payload.get("run_index", -1), "run index")
    run = runs[run_index]
    anchors = run.get("anchors") or []
    if not anchors or any(
            not a.get("enhanced_complete")
            or not os.path.isfile(str(a.get("enhanced_path") or ""))
            for a in anchors):
        raise ValueError(
            "All Face Fix anchors must be enhanced before LTX can run.")
    crop_video_path = _existing_file(run.get("crop_video_path"),
                                     "512x512 face crop video")
    enhanced_anchors_folder = os.path.abspath(str(
        run.get("enhanced_anchors_folder") or ""))
    if not os.path.isdir(enhanced_anchors_folder):
        raise FileNotFoundError("The enhanced anchor folder was not found.")
    settings = manifest.get("ltx_settings") or {}
    original_indices = [int(a.get("index", 0)) for a in anchors]
    safe = safe_ltx_indices(original_indices,
                            int(run.get("frame_count") or 0))
    if len(safe) != len(anchors):
        raise ValueError(
            "Face Fix could not assign a valid LTX conditioning index to "
            "every enhanced anchor.")
    return {
        "run_index": run_index,
        "crop_video_path": crop_video_path,
        "enhanced_anchors_folder": enhanced_anchors_folder,
        "frame_count": int(run.get("frame_count") or 0),
        "anchor_count": len(anchors),
        "anchor_indices": safe,
        "anchor_indices_text": ",".join(str(i) for i in safe),
        "guiding_strength": float(settings.get("guiding_strength", 0.20)),
        "temporal_overlap_cond_strength": float(
            settings.get("temporal_overlap_cond_strength", 0.50)),
        "cond_image_strength": float(
            settings.get("cond_image_strength", 0.50)),
        "seed": int(settings.get("seed", 42)),
        "sampler": str(settings.get("sampler") or "euler_ancestral"),
        "sigmas": str(settings.get("sigmas")
                      or "0.909375, 0.725, 0.421875, 0.0"),
    }


def accept_ltx_frames(payload) -> dict:
    """Collect a run's externally-repaired 512 frame batch (``:796-866``):
    tolerate up to a +/-7 frame delta from the prepared count (LTX rounds
    to 8n+1 temporal lengths) and preserve the unmatched tail frames as
    originals instead of rejecting the batch."""
    import cv2

    manifest_path, manifest = _load_manifest(payload)
    runs = manifest.get("runs") or []
    run_index = _picked(runs, payload.get("run_index", -1), "run index")
    run = runs[run_index]
    all_entries = manifest.get("entries") or []
    entries = [e for e in all_entries if e.get("run_index") == run_index]
    images = payload.get("images")
    if not isinstance(images, list):
        raise ValueError("LTX frame batch metadata is missing.")
    frame_delta = len(entries) - len(images)
    if abs(frame_delta) > 7:
        raise ValueError(
            f"LTX returned {len(images)} frames, but Face Fix prepared "
            f"{len(entries)}; the difference is larger than one normal LTX "
            "temporal-length adjustment.")
    images = images[:len(entries)]
    output_folder = os.path.abspath(str(run.get("ltx_frames_folder") or ""))
    if not output_folder:
        raise ValueError("The LTX run output folder is missing.")
    os.makedirs(output_folder, exist_ok=True)
    saved = []
    for index, image_info in enumerate(images):
        source_path = _resolve_image_path(image_info)
        frame = cv2.imread(source_path, cv2.IMREAD_COLOR)
        if frame is None:
            raise RuntimeError(f"Could not read LTX frame {index}: "
                               f"{source_path}")
        h, w = frame.shape[:2]
        if w != ENHANCE_SIZE or h != ENHANCE_SIZE:
            raise ValueError(f"LTX frame {index} is {w}x{h}; expected "
                             f"exactly {ENHANCE_SIZE}x{ENHANCE_SIZE}.")
        target_path = os.path.join(output_folder, f"frame_{index:06d}.png")
        if not cv2.imwrite(target_path, frame):
            raise RuntimeError(f"Could not save LTX frame {index}.")
        entries[index]["ltx_frame_path"] = target_path
        entries[index]["ltx_source"] = source_path
        saved.append(target_path)
    for entry in entries[len(saved):]:
        entry["composite_strength"] = 0.0
        entry["ltx_skipped_reason"] = \
            "LTX temporal-length tail; original frame preserved"
    run["ltx_frames_folder"] = output_folder
    run["ltx_frame_count"] = len(saved)
    run["ltx_complete"] = True
    manifest["ltx_frame_count"] = sum(
        int(item.get("ltx_frame_count") or 0) for item in runs)
    manifest["ltx_complete"] = all(bool(item.get("ltx_complete"))
                                   for item in runs)
    _save_manifest(manifest_path, manifest)
    return {
        "run_index": run_index, "ltx_frames_folder": output_folder,
        "ltx_frame_count": len(saved),
        "frame_count": len(entries),
        "preserved_tail_frames": max(0, len(entries) - len(saved)),
        "ltx_preview_data": _jpeg_data_url(saved[0]) if saved else "",
    }


# --------------------------------------------------------------------------
# finalize
# --------------------------------------------------------------------------

def unit_float(u8: np.ndarray, device) -> torch.Tensor:
    """A uint8 array on ``device`` as float32 ``u8 / 255``, divided as
    numpy divides on the host: by a tensor, which CUDA divides exactly
    (a Python scalar there becomes a multiply by its reciprocal, an ulp
    off, which the truncating quantize can turn into a level)."""
    u8 = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    return u8.to(torch.float32) / torch.tensor(255.0, device=device)


def finalize_face_fix(payload, device="cuda",
                      timer: StageTimer | None = None) -> dict:
    """Composite all repaired frames back into the source video.  The
    per-frame composite (ellipse feather, mean-shift color match over
    alpha>0.35, composite-strength fade) runs as torch ops on ``device``
    via :func:`vrgdg_tpu_torch.ops.paste_back.ellipse_composite`, one
    uint8 upload and download a frame; the rebuild is a lossless FFV1
    intermediate + libx264 CRF16 with audio copied from the source,
    degrading to the cv2 codec chain without ffmpeg.  ``timer``, when
    given, gathers the ``composite`` (PNG read, device, PNG write) and
    ``encode`` seconds."""
    import cv2

    from ..ops.paste_back import ellipse_composite

    device = resolve_device(device)
    timer = timer or StageTimer()
    manifest_path, manifest = _load_manifest(payload)
    entries = manifest.get("entries") or []
    if not entries:
        raise ValueError("The Face Fix job has no prepared frames.")
    repair_entries = [e for e in entries
                      if float(e.get("composite_strength") or 0.0) > 0.0]
    incomplete = [e for e in repair_entries
                  if not os.path.isfile(str(e.get("ltx_frame_path") or ""))]
    if incomplete:
        raise ValueError(f"Face Fix still has {len(incomplete)} frame(s) "
                         "without validated LTX output.")
    if not repair_entries:
        raise ValueError(
            "Face Fix has no safe face-visible frames to composite.")

    feather = max(0, min(256, int(payload.get("feather") or 18)))
    color_match = max(0.0, min(1.0, _number(payload, "color_match", 0.65)))
    job_folder = os.path.abspath(manifest["job_folder"])
    composited_folder = os.path.join(job_folder, "composited_frames")
    os.makedirs(composited_folder, exist_ok=True)

    composited_by_frame: dict[int, str] = {}
    faded_frames = 0
    for entry in repair_entries:
        strength = max(0.0, min(1.0,
                                float(entry.get("composite_strength") or 0.0)))
        if strength < 1.0:
            faded_frames += 1
        with timer.stage("composite"):
            original = cv2.imread(_existing_file(entry.get("original_path"),
                                                 "Original Face Fix frame"))
            enhanced = cv2.imread(_existing_file(entry.get("ltx_frame_path"),
                                                 "LTX Face Fix frame"))
            if original is None or enhanced is None:
                raise RuntimeError("Could not decode Face Fix frame "
                                   f"{entry.get('frame_number')}.")
            crop_box = [int(v) for v in entry["crop_box"]]
            if (crop_box[2] - crop_box[0] <= 0
                    or crop_box[3] - crop_box[1] <= 0):
                raise ValueError("Invalid crop box for frame "
                                 f"{entry.get('frame_number')}.")
            output = ellipse_composite(
                unit_float(original[..., ::-1], device),
                unit_float(enhanced[..., ::-1], device), crop_box,
                feather=feather, color_match=color_match,
                composite_strength=strength)
            # the original's quantize truncates: clip(x * 255).astype(uint8)
            out_bgr = torch.clamp(output * 255.0, 0, 255).to(
                torch.uint8).cpu().numpy()[..., ::-1]
            output_path = os.path.join(
                composited_folder,
                f"frame_{int(entry['frame_number']):06d}.png")
            cv2.imwrite(output_path, np.ascontiguousarray(out_bgr))
        entry["composited_path"] = output_path
        composited_by_frame[int(entry["frame_number"])] = output_path

    source_video = _existing_file(manifest.get("video_path"),
                                  "Source scene video")
    fps = float(manifest.get("fps") or 0.0)
    width = int(manifest.get("width") or 0)
    height = int(manifest.get("height") or 0)

    source_dir = os.path.dirname(source_video)
    stem = os.path.splitext(os.path.basename(source_video))[0]
    output_path = os.path.join(
        source_dir, f"{stem}_facefix_{time.strftime('%Y%m%d_%H%M%S')}.mp4")

    def spliced_frames():
        capture = cv2.VideoCapture(source_video)
        try:
            frame_number = 0
            while True:
                ok, frame = capture.read()
                if not ok:
                    break
                repaired = composited_by_frame.get(frame_number)
                if repaired:
                    image = cv2.imread(repaired)
                    if image is not None:
                        frame = image
                yield frame
                frame_number += 1
        finally:
            capture.release()

    audio_preserved = False
    with timer.stage("encode"):
        ffmpeg = video_io.find_ffmpeg()
        if ffmpeg is not None:
            silent_path = os.path.join(job_folder, "face_fix_silent.avi")
            writer = cv2.VideoWriter(silent_path,
                                     cv2.VideoWriter_fourcc(*"FFV1"), fps,
                                     (width, height))
            if writer.isOpened():
                for frame in spliced_frames():
                    writer.write(frame)
                writer.release()
                command = [
                    ffmpeg, "-y", "-i", silent_path, "-i", source_video,
                    "-map", "0:v:0", "-map", "1:a?", "-c:v", "libx264",
                    "-preset", "medium", "-crf", "16", "-pix_fmt", "yuv420p",
                    "-c:a", "copy", "-movflags", "+faststart", output_path,
                ]
                result = subprocess.run(command, capture_output=True,
                                        text=True, errors="replace",
                                        check=False)
                if result.returncode != 0 or not os.path.isfile(output_path):
                    raise RuntimeError(
                        (result.stderr or result.stdout
                         or "FFmpeg failed to rebuild the Face Fix video.")
                        .strip()[-1600:])
                try:
                    os.remove(silent_path)
                except OSError:
                    pass
                audio_preserved = (video_io.media_has_audio(source_video)
                                   or False)
            else:
                ffmpeg = None  # FFV1 unavailable: fall through to cv2 chain
        if ffmpeg is None:
            def produce():
                for frame in spliced_frames():
                    yield video_io.frames_to_array([frame])

            video_io.write_video_with_fallback(output_path, fps, width,
                                               height, produce)

    manifest.update(
        composite_complete=True, output_video_path=output_path,
        feather=feather, color_match=color_match,
        frames_repaired=len(repair_entries), frames_faded=faded_frames,
        frames_skipped=len(entries) - len(repair_entries))
    _save_manifest(manifest_path, manifest)
    return {
        "output_video_path": output_path,
        "source_video_path": source_video,
        "frames_repaired": len(repair_entries),
        "frames_faded": faded_frames,
        "frames_skipped": len(entries) - len(repair_entries),
        "close_skipped_frames": int(manifest.get("close_skipped_frames")
                                    or 0),
        "start_frame": manifest.get("start_frame"),
        "end_frame": manifest.get("end_frame"),
        "fps": fps,
        "width": width,
        "height": height,
        "audio_preserved": audio_preserved,
    }
