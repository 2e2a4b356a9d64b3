"""Targeted far-face repair: prepare -> (external enhance) -> composite.

Counterpart of :mod:`vrgdg_tpu.jobs.face_repair`, the human-in-the-loop
sibling of the Face Fix job engine: the user marks frame ranges where a
distant face needs work, this module extracts those frames and padded
face crops with soft masks (:func:`prepare`), the user runs the crops
through any image-to-image tool, and the module pastes the repaired crops
back (:func:`composite`), renders an original/fixed review sheet
(:func:`contact_sheet`) and a preview MP4 with the repaired frames
swapped in (:func:`rebuild_video`).

The manifest JSON schema (keys, entry fields, file layout:
``original_frames/ crops/ masks/ debug/ manifest.json``) is the
original's, so crops prepared by either package composite with the other.
Everything is the original's host code (cv2, numpy), copied, but
:func:`_resize_u8`: the lanczos4 rescaling of crops, masks and frames runs
through :func:`vrgdg_tpu_torch.ops.resize.resample` on ``device``
(``"cuda"`` unless the caller asks for ``"cpu"``).  Detection uses the
vendored res10/YuNet detector
(:func:`vrgdg_tpu_torch.jobs.face_fix.load_default_detector`) by default;
``detector="opencv"`` keeps the haar-cascade path, which OpenCV 5 builds
without ``CascadeClassifier`` refuse.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil

import numpy as np
import torch

from ..ops.resize import resample
from ..runtime.batch_stream import resolve_device

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp")

#: crop side = max(face edge) * padding, never below this many pixels
MIN_CROP_SIDE = 32.0
#: ellipse inset fraction of the soft mask (ref ``soft_face_mask`` shrink)
MASK_SHRINK = 0.12
#: fraction of the original-minus-repaired mean shift applied in the
#: masked color match (ref ``color_match_repaired``)
COLOR_MATCH_RATE = 0.65


# ------------------------------------------------------------------
# pure parsing / geometry (oracle-fuzzed vs the reference script)
# ------------------------------------------------------------------

def parse_ranges(value: str) -> list[tuple[int, int]]:
    """``"120-160,300-318"`` (commas or newlines, bare numbers allowed)
    -> inclusive ``(start, end)`` pairs, each normalized ascending
    (ref ``parse_ranges``, ``:53-73``)."""
    ranges: list[tuple[int, int]] = []
    for part in re.split(r"[,\n]", str(value or "")):
        token = part.strip()
        if not token:
            continue
        edges = [int(piece.strip()) for piece in token.split("-", 1)]
        low, high = min(edges), max(edges)
        if low < 0:
            raise ValueError(f"Frame ranges must be non-negative: {token}")
        ranges.append((low, high))
    if not ranges:
        raise ValueError("at least one frame range is required")
    return ranges


def parse_box(value: str) -> tuple[int, int, int, int] | None:
    """Manual face box: ``x,y,w,h`` or ``x1,y1,x2,y2`` (``x`` also
    accepted as a separator) -> corner form, or None when blank
    (ref ``parse_box``, ``:75-86``)."""
    cleaned = str(value or "").strip()
    if not cleaned:
        return None
    numbers = [int(float(tok))
               for tok in re.split(r"[x,]", cleaned) if tok.strip()]
    if len(numbers) != 4:
        raise ValueError(
            "a face box needs exactly four numbers "
            "(x,y,w,h or x1,y1,x2,y2)")
    left, top = numbers[:2]
    # the second pair is corners when it lies past the first, otherwise
    # a width/height extent (floored at one pixel)
    if numbers[2] > left and numbers[3] > top:
        right, bottom = numbers[2:]
    else:
        right = left + max(1, numbers[2])
        bottom = top + max(1, numbers[3])
    return left, top, right, bottom


def frames_in_ranges(ranges) -> set[int]:
    """Every frame index covered by the inclusive ranges
    (ref ``selected_frame_set``, ``:88-92``)."""
    return {index for low, high in ranges for index in range(low, high + 1)}


def pick_face(faces, width: int, height: int, mode: str = "largest"):
    """The face to repair from ``(x, y, w, h, score)`` candidates:
    ``center`` = closest to frame center, ``largest`` = area with a 15%
    center-distance discount (ref ``choose_face``, ``:154-169``)."""
    if not faces:
        return None

    def rating(face):
        x, y, w, h = face[:4]
        dist = math.hypot((x + w / 2.0 - width / 2.0) / width,
                          (y + h / 2.0 - height / 2.0) / height)
        area = w * h
        return -dist if mode == "center" else area * (1.0 - dist * 0.15)

    return max(faces, key=rating)


def expanded_crop_box(face, image_width: int, image_height: int,
                      padding: float) -> tuple[int, int, int, int]:
    """Square crop around the face center, side ``max(w, h) * padding``
    (>= :data:`MIN_CROP_SIDE`), translated — never shrunk — into the
    frame (ref ``expanded_square_crop``, ``:172-199``)."""
    x, y, w, h = face[:4]
    side = max(max(w, h) * float(padding), MIN_CROP_SIDE)
    cx, cy = x + w / 2.0, y + h / 2.0
    box = np.array([round(cx - side / 2.0), round(cy - side / 2.0),
                    round(cx + side / 2.0), round(cy + side / 2.0)],
                   np.int64)
    for axis, limit in ((0, image_width), (1, image_height)):
        lo, hi = box[axis], box[axis + 2]
        shift = max(0, -lo) - max(0, hi - limit)
        box[axis], box[axis + 2] = lo + shift, hi + shift
    left = max(0, int(box[0]))
    top = max(0, int(box[1]))
    right = min(image_width, max(left + 1, int(box[2])))
    bottom = min(image_height, max(top + 1, int(box[3])))
    return left, top, right, bottom


def soft_ellipse_mask(width: int, height: int, feather: int) -> np.ndarray:
    """uint8 alpha: filled ellipse inset :data:`MASK_SHRINK` per edge,
    Gaussian-feathered (ref ``soft_face_mask``, ``:202-211``)."""
    import cv2

    inset_x = int(round(width * MASK_SHRINK))
    inset_y = int(round(height * MASK_SHRINK))
    mask = np.zeros((height, width), np.uint8)
    center = ((width - 1) // 2, (height - 1) // 2)
    axes = (max(1, (width - 2 * inset_x) // 2),
            max(1, (height - 2 * inset_y) // 2))
    cv2.ellipse(mask, center, axes, 0, 0, 360, 255, -1)
    if feather > 0:
        mask = cv2.GaussianBlur(mask, (0, 0), float(feather))
    return mask


def match_crop_colors(original: np.ndarray, repaired: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
    """Shift the repaired crop toward the original's mean color inside
    the mask (alpha > 0.25; crops with under 16 masked pixels pass
    through) — ref ``color_match_repaired``, ``:214-224``."""
    selected = (mask.astype(np.float32) / 255.0) > 0.25
    if int(selected.sum()) < 16:
        return repaired
    rep = repaired.astype(np.float32)
    shift = (original.astype(np.float32)[selected].mean(axis=0)
             - rep[selected].mean(axis=0)) * COLOR_MATCH_RATE
    return np.clip(rep + shift, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------
# detection wiring
# ------------------------------------------------------------------

def _haar_detect(frame_bgr: np.ndarray) -> list[tuple]:
    """The reference's cascade path (``detect_faces_opencv``,
    ``:132-137``): frontal haar, scale 1.08, 4 neighbors, >=12 px.
    OpenCV 5 headless builds drop ``CascadeClassifier`` — degrade with
    a pointer at the vendored detector instead of an AttributeError."""
    import cv2

    classifier = getattr(cv2, "CascadeClassifier", None)
    if classifier is None:
        raise RuntimeError(
            "This cv2 build has no CascadeClassifier (haar cascades were "
            "dropped); use detector='auto' (vendored res10/YuNet assets).")
    cascade = classifier(os.path.join(
        cv2.data.haarcascades, "haarcascade_frontalface_default.xml"))
    gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
    found = cascade.detectMultiScale(gray, scaleFactor=1.08,
                                     minNeighbors=4, minSize=(12, 12))
    return [(int(x), int(y), int(w), int(h), 1.0) for x, y, w, h in found]


def detect_repair_faces(frame_bgr: np.ndarray, detector: str,
                        min_confidence: float) -> list[tuple]:
    """``auto`` = the vendored res10/YuNet assets (confidence-filtered),
    ``opencv`` = the reference's haar cascade."""
    if detector == "opencv":
        return _haar_detect(frame_bgr)
    if detector != "auto":
        raise ValueError(f"Unknown detector: {detector!r} "
                         "(expected 'auto' or 'opencv')")
    from .face_fix import load_default_detector

    height, width = frame_bgr.shape[:2]
    found = load_default_detector()(frame_bgr, (0, 0, width, height))
    out = []
    for x, y, w, h, score in found:
        if score < float(min_confidence):
            continue
        xi = max(0, min(width - 1, int(round(x))))
        yi = max(0, min(height - 1, int(round(y))))
        out.append((xi, yi, max(1, min(width - xi, int(round(w)))),
                    max(1, min(height - yi, int(round(h)))), float(score)))
    return out


# ------------------------------------------------------------------
# stages
# ------------------------------------------------------------------

def _layout(out_dir: str) -> dict[str, str]:
    names = ("original_frames", "crops", "masks", "debug")
    return {name: os.path.join(out_dir, name) for name in names}


def prepare(video: str, ranges: str, out_dir: str, *,
            detector: str = "auto", face_choice: str = "largest",
            manual_box: str = "", min_confidence: float = 0.35,
            padding: float = 2.35, feather: int = 18,
            overwrite: bool = False) -> dict:
    """Extract the marked frames, crop the chosen face on each, write
    crops + soft masks + debug overlays + ``manifest.json``
    (ref ``prepare``, ``:227-337``)."""
    import cv2

    from ..runtime import video_io

    video_path = video_io.normalize_video_path(video)
    span = parse_ranges(ranges)
    forced = parse_box(manual_box)
    selected = frames_in_ranges(span)
    out_dir = os.path.abspath(os.path.expanduser(out_dir))
    if overwrite and os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    folders = _layout(out_dir)
    for folder in folders.values():
        os.makedirs(folder, exist_ok=True)

    info = video_io.probe_video(video_path)
    width, height = info["width"], info["height"]
    if forced:
        x1 = max(0, min(width - 1, forced[0]))
        y1 = max(0, min(height - 1, forced[1]))
        x2 = max(x1 + 1, min(width, forced[2]))
        y2 = max(y1 + 1, min(height, forced[3]))
        forced = (x1, y1, x2, y2)

    entries, missed = [], []
    capture = cv2.VideoCapture(video_path)
    try:
        last = max(selected)
        for index in range(last + 1):
            ok, frame = capture.read()
            if not ok:
                break
            if index not in selected:
                continue
            frame_name = f"frame_{index:06d}.png"
            original_path = os.path.join(folders["original_frames"],
                                         frame_name)
            cv2.imwrite(original_path, frame)

            if forced:
                face = (forced[0], forced[1], forced[2] - forced[0],
                        forced[3] - forced[1], 1.0)
            else:
                face = pick_face(
                    detect_repair_faces(frame, detector, min_confidence),
                    width, height, face_choice)
            if face is None:
                missed.append(index)
                continue

            box = expanded_crop_box(face, width, height, padding)
            left, top, right, bottom = box
            crop_name = f"frame_{index:06d}_face_00.png"
            cv2.imwrite(os.path.join(folders["crops"], crop_name),
                        frame[top:bottom, left:right])
            cv2.imwrite(os.path.join(folders["masks"], crop_name),
                        soft_ellipse_mask(right - left, bottom - top,
                                          int(feather)))

            debug = frame.copy()
            x, y, w, h = (int(v) for v in face[:4])
            cv2.rectangle(debug, (x, y), (x + w, y + h), (0, 220, 255), 2)
            cv2.rectangle(debug, (left, top), (right, bottom),
                          (120, 255, 0), 2)
            cv2.imwrite(os.path.join(folders["debug"], frame_name), debug)

            entries.append({
                "frame": index,
                "original_frame": original_path,
                "crop": os.path.join(folders["crops"], crop_name),
                "mask": os.path.join(folders["masks"], crop_name),
                "crop_box": list(box),
                "face_box": [x, y, x + w, y + h],
                "face_score": float(face[4]),
                "repaired_name": crop_name,
            })
    finally:
        capture.release()

    manifest = {
        "video": video_path,
        "fps": info["fps"],
        "total_frames": info["frame_count"],
        "width": width,
        "height": height,
        "ranges": [{"start": low, "end": high} for low, high in span],
        "detector": detector,
        "manual_box": list(forced) if forced else None,
        "padding": padding,
        "feather": feather,
        "entries": entries,
        "missed_frames": missed,
    }
    manifest_path = os.path.join(out_dir, "manifest.json")
    with open(manifest_path, "w", encoding="utf-8") as handle:
        json.dump(manifest, handle, indent=2)
    return {"manifest_path": manifest_path, "crops": len(entries),
            "missed_frames": missed, "out_dir": out_dir}


def _read_manifest(manifest_path: str) -> tuple[dict, str]:
    manifest_path = os.path.abspath(os.path.expanduser(manifest_path))
    with open(manifest_path, "r", encoding="utf-8") as handle:
        return json.load(handle), os.path.dirname(manifest_path)


def _resize_u8(image: np.ndarray, height: int, width: int,
               device="cuda") -> np.ndarray:
    """Lanczos4 resample of a uint8 HWC/HW image on ``device``: one uint8
    upload, the float work and the rounding there, one uint8 download."""
    from .face_fix import unit_float

    planes = image if image.ndim == 3 else image[..., None]
    out = resample(unit_float(planes, device)[None], height, width,
                   "lanczos4")[0]
    array = torch.clamp(torch.round(out * 255.0), 0, 255).to(
        torch.uint8).cpu().numpy()
    return array if image.ndim == 3 else array[..., 0]


def composite(manifest_path: str, *, repaired_dir: str = "",
              out_dir: str = "", feather: int = 18,
              color_match: bool = False, device="cuda") -> dict:
    """Paste repaired crops back onto the extracted frames through the
    soft mask (ref ``composite``, ``:339-372``). ``feather >= 0``
    regenerates the mask at that radius; ``-1`` keeps the saved masks."""
    import cv2

    device = resolve_device(device)

    manifest, base_dir = _read_manifest(manifest_path)
    repaired_root = (os.path.abspath(os.path.expanduser(repaired_dir))
                     if repaired_dir else os.path.join(base_dir, "crops"))
    out_root = (os.path.abspath(os.path.expanduser(out_dir))
                if out_dir else os.path.join(base_dir, "composited_frames"))
    os.makedirs(out_root, exist_ok=True)

    written, skipped = 0, []
    for entry in manifest.get("entries", []):
        repaired_path = os.path.join(repaired_root, entry["repaired_name"])
        original = cv2.imread(entry["original_frame"], cv2.IMREAD_COLOR)
        repaired = cv2.imread(repaired_path, cv2.IMREAD_COLOR)
        if original is None or repaired is None:
            skipped.append(entry["repaired_name"])
            continue
        left, top, right, bottom = (int(v) for v in entry["crop_box"])
        h, w = bottom - top, right - left
        repaired = _resize_u8(repaired, h, w, device)
        if int(feather) >= 0:
            mask = soft_ellipse_mask(w, h, int(feather))
        else:
            saved = cv2.imread(entry["mask"], cv2.IMREAD_GRAYSCALE)
            mask = (_resize_u8(saved, h, w, device) if saved is not None
                    else soft_ellipse_mask(w, h, 18))
        region = original[top:bottom, left:right]
        if color_match:
            repaired = match_crop_colors(region, repaired, mask)
        alpha = (mask.astype(np.float32) / 255.0)[..., None]
        blended = (region.astype(np.float32) * (1.0 - alpha)
                   + repaired.astype(np.float32) * alpha)
        output = original.copy()
        output[top:bottom, left:right] = \
            np.clip(np.round(blended), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(
            out_root, f"frame_{int(entry['frame']):06d}.png"), output)
        written += 1
    return {"out_dir": out_root, "written": written, "skipped": skipped}


def contact_sheet(manifest_path: str, *, repaired_dir: str = "",
                  out_path: str = "", limit: int = 24, columns: int = 3,
                  thumb_width: int = 900, device="cuda") -> dict:
    """Original|fixed pairs tiled into one review JPEG
    (ref ``contact_sheet``, ``:374-408``)."""
    import cv2

    device = resolve_device(device)

    manifest, base_dir = _read_manifest(manifest_path)
    fixed_root = (os.path.abspath(os.path.expanduser(repaired_dir))
                  if repaired_dir
                  else os.path.join(base_dir, "composited_frames"))
    target = (os.path.abspath(os.path.expanduser(out_path)) if out_path
              else os.path.join(base_dir, "contact_sheet.jpg"))

    thumbs = []
    for entry in manifest.get("entries", [])[:max(0, int(limit))]:
        original = cv2.imread(entry["original_frame"], cv2.IMREAD_COLOR)
        if original is None:
            continue
        fixed_path = os.path.join(fixed_root,
                                  f"frame_{int(entry['frame']):06d}.png")
        fixed = cv2.imread(fixed_path, cv2.IMREAD_COLOR)
        if fixed is None:
            fixed = original
        if fixed.shape != original.shape:
            fixed = _resize_u8(fixed, original.shape[0], original.shape[1],
                               device)
        pair = np.concatenate([original, fixed], axis=1)
        scale = min(1.0, int(thumb_width) / pair.shape[1])
        if scale < 1.0:
            pair = _resize_u8(pair, max(1, int(pair.shape[0] * scale)),
                              max(1, int(pair.shape[1] * scale)), device)
        thumbs.append(pair)
    if not thumbs:
        raise RuntimeError("contact sheet: no readable frames in the "
                           "manifest entries")

    cols = max(1, int(columns))
    rows = math.ceil(len(thumbs) / cols)
    cell_h = max(t.shape[0] for t in thumbs)
    cell_w = max(t.shape[1] for t in thumbs)
    sheet = np.full((rows * cell_h, cols * cell_w, 3), 24, np.uint8)
    for index, thumb in enumerate(thumbs):
        y = (index // cols) * cell_h
        x = (index % cols) * cell_w
        sheet[y:y + thumb.shape[0], x:x + thumb.shape[1]] = thumb
    cv2.imwrite(target, sheet, [cv2.IMWRITE_JPEG_QUALITY, 92])
    return {"sheet_path": target, "pairs": len(thumbs)}


def rebuild_video(manifest_path: str, out_path: str, *,
                  fixed_dir: str = "", only_ranges: bool = False,
                  device="cuda") -> dict:
    """Preview MP4 with composited frames replacing the originals
    (ref ``rebuild_video``, ``:411-462``; silent, mp4v like the
    reference's preview writer)."""
    import cv2

    device = resolve_device(device)

    manifest, base_dir = _read_manifest(manifest_path)
    fixed_root = (os.path.abspath(os.path.expanduser(fixed_dir))
                  if fixed_dir
                  else os.path.join(base_dir, "composited_frames"))
    out_path = os.path.abspath(os.path.expanduser(out_path))

    capture = cv2.VideoCapture(manifest["video"])
    if not capture.isOpened():
        raise RuntimeError(f"Could not open video: {manifest['video']}")
    fps = float(manifest.get("fps")
                or capture.get(cv2.CAP_PROP_FPS) or 30.0)
    width = int(capture.get(cv2.CAP_PROP_FRAME_WIDTH)
                or manifest.get("width") or 0)
    height = int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT)
                 or manifest.get("height") or 0)
    selected = {int(entry["frame"])
                for entry in manifest.get("entries", [])}
    selected |= frames_in_ranges(
        [(int(r["start"]), int(r["end"]))
         for r in manifest.get("ranges", [])])
    last = max(selected) if selected else -1

    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (width, height))
    if not writer.isOpened():
        capture.release()
        raise RuntimeError(f"Could not write video: {out_path}")
    written = replaced = 0
    index = 0
    try:
        while True:
            ok, frame = capture.read()
            if not ok or (only_ranges and index > last):
                break
            if not only_ranges or index in selected:
                fixed_path = os.path.join(fixed_root,
                                          f"frame_{index:06d}.png")
                fixed = (cv2.imread(fixed_path, cv2.IMREAD_COLOR)
                         if os.path.isfile(fixed_path) else None)
                if fixed is not None:
                    if fixed.shape[:2] != (height, width):
                        fixed = _resize_u8(fixed, height, width, device)
                    frame = fixed
                    replaced += 1
                writer.write(frame)
                written += 1
            index += 1
    finally:
        capture.release()
        writer.release()
    return {"output": out_path, "written": written, "replaced": replaced}
