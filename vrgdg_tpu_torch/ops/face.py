"""Face-crop geometry: tiling, IoU dedup, selection, padded square crops.

The reference's Modern Face Crop (``VRGDG_ImagePasteBack.py:44-179``) pairs
an OpenCV DNN detector with pure geometry.  The detector weights are
external assets, so here the geometry is first-class and the detector is a
pluggable callable; :func:`detect_faces_cv2` wires in cv2.dnn when the
caffemodel assets are available.

Geometry reproduced exactly:
- 4-tile 60% overlapping long-range scan for wide shots (``:86-94``),
- candidate clamping and minimum-size filtering (``:110-121, 139-141``),
- greedy confidence-ordered IoU 0.35 dedup (``:124-137``),
- selection by highest confidence / largest / closest-to-center (``:148-153``),
- padded square crop shifted (not shrunk) back inside the image
  (``:155-178``), returning WAS-compatible CROP_DATA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence


@dataclass(frozen=True)
class FaceCandidate:
    x: int
    y: int
    width: int
    height: int
    confidence: float
    center_distance: float


def tile_regions(width: int, height: int) -> list[tuple[int, int, int, int]]:
    """Full frame plus four 60% overlapping corner tiles for frames at
    least 600px on both edges."""
    regions = [(0, 0, width, height)]
    if width >= 600 and height >= 600:
        tw, th = int(round(width * 0.60)), int(round(height * 0.60))
        regions += [(0, 0, tw, th), (width - tw, 0, width, th),
                    (0, height - th, tw, height),
                    (width - tw, height - th, width, height)]
    return regions


def make_candidate(x: int, y: int, w: int, h: int, confidence: float,
                   frame_width: int, frame_height: int) -> FaceCandidate:
    cx, cy = x + w / 2.0, y + h / 2.0
    center_distance = (((cx - frame_width / 2.0) / frame_width) ** 2
                       + ((cy - frame_height / 2.0) / frame_height) ** 2)
    return FaceCandidate(x, y, w, h, float(confidence), center_distance)


def iou(a: FaceCandidate, b: FaceCandidate) -> float:
    inter = (max(0, min(a.x + a.width, b.x + b.width) - max(a.x, b.x))
             * max(0, min(a.y + a.height, b.y + b.height) - max(a.y, b.y)))
    union = a.width * a.height + b.width * b.height - inter
    return inter / union if union > 0 else 0.0


def dedup_candidates(candidates: Sequence[FaceCandidate],
                     threshold: float = 0.35) -> list[FaceCandidate]:
    """Greedy confidence-ordered suppression at IoU > threshold."""
    kept: list[FaceCandidate] = []
    for candidate in sorted(candidates, key=lambda c: c.confidence,
                            reverse=True):
        if all(iou(candidate, other) <= threshold for other in kept):
            kept.append(candidate)
    return kept


def select_candidate(candidates: Sequence[FaceCandidate],
                     selection: str = "highest_confidence") -> FaceCandidate:
    if not candidates:
        raise ValueError(
            "No face passed the detection settings. Try full_range, lower "
            "confidence slightly, or reduce minimum_face_pixels.")
    if selection == "largest":
        return max(candidates, key=lambda c: c.width * c.height)
    if selection == "closest_to_center":
        return min(candidates, key=lambda c: c.center_distance)
    return max(candidates, key=lambda c: c.confidence)


def padded_square_box(candidate: FaceCandidate, frame_width: int,
                      frame_height: int, crop_padding_factor: float = 0.40,
                      minimum_face_pixels: int = 24
                      ) -> tuple[int, int, int, int]:
    """Square crop around the face, expanded by padding and shifted (not
    distorted) back inside the frame."""
    side = max(candidate.width, candidate.height) \
        * (1.0 + 2.0 * float(crop_padding_factor))
    half = max(float(minimum_face_pixels), side) / 2.0
    cx = candidate.x + candidate.width / 2.0
    cy = candidate.y + candidate.height / 2.0
    left, right = _shift_span(int(round(cx - half)), int(round(cx + half)),
                              frame_width)
    top, bottom = _shift_span(int(round(cy - half)), int(round(cy + half)),
                              frame_height)
    return left, top, right, bottom


def _shift_span(lo: int, hi: int, limit: int) -> tuple[int, int]:
    """Translate ``[lo, hi)`` into ``[0, limit)`` preserving its length;
    an oversized span is cropped to the full axis. Equivalent to the
    shift-then-clamp sequence in the reference crop helpers."""
    span = hi - lo
    lo = max(0, min(lo, limit - span))
    return lo, min(limit, lo + span)


DetectorFn = Callable[["object", tuple[int, int, int, int]],
                      list[tuple[int, int, int, int, float]]]


def crop_face(image, detector: DetectorFn, *, confidence: float = 0.70,
              crop_padding_factor: float = 0.40,
              minimum_face_pixels: int = 24,
              face_selection: str = "highest_confidence",
              long_range: bool = True):
    """Detect + crop with the reference's full pipeline; ``detector`` maps
    ``(bgr_or_rgb_frame, region)`` to ``[(x, y, w, h, score), ...]`` in
    frame coordinates.

    Returns ``(crop BHWC, crop_data, confidence)``.
    """
    import numpy as np

    frame = np.asarray(image[0] if hasattr(image, "ndim") and image.ndim == 4
                       else image)
    height, width = frame.shape[:2]
    regions = tile_regions(width, height) if long_range \
        else [(0, 0, width, height)]

    candidates: list[FaceCandidate] = []
    for region in regions:
        rl, rt, rr, rb = region
        for x, y, w, h, score in detector(frame, region):
            if score < confidence:
                continue
            x, y = max(rl, int(x)), max(rt, int(y))
            right, bottom = min(rr, int(x + w)), min(rb, int(y + h))
            w, h = right - x, bottom - y
            if min(w, h) < int(minimum_face_pixels):
                continue
            candidates.append(make_candidate(x, y, w, h, score, width, height))

    candidates = dedup_candidates(candidates)
    candidates = [c for c in candidates
                  if min(c.width, c.height) >= int(minimum_face_pixels)]
    chosen = select_candidate(candidates, face_selection)
    box = padded_square_box(chosen, width, height, crop_padding_factor,
                            minimum_face_pixels)
    left, top, right, bottom = box
    batch = image if (hasattr(image, "ndim") and image.ndim == 4) else image[None]
    crop = batch[:, top:bottom, left:right, :]
    crop_data = ((right - left, bottom - top), box)
    return crop, crop_data, chosen.confidence


def detect_faces_cv2(model_path: str, config_path: str,
                     input_size: int = 300) -> DetectorFn:
    """cv2.dnn res10 SSD detector factory (requires the caffemodel assets
    the reference ships in ``assets/``)."""
    import cv2

    net = cv2.dnn.readNetFromCaffe(config_path, model_path)

    def detector(frame, region):
        import numpy as np

        rl, rt, rr, rb = region
        patch = np.asarray(frame)[rt:rb, rl:rr]
        if patch.dtype != "uint8":
            patch = (np.clip(patch, 0, 1) * 255).astype("uint8")
        bgr = patch[..., ::-1]
        h, w = bgr.shape[:2]
        blob = cv2.dnn.blobFromImage(cv2.resize(bgr, (input_size, input_size)),
                                     1.0, (input_size, input_size),
                                     (104.0, 177.0, 123.0), swapRB=False,
                                     crop=False)
        net.setInput(blob)
        found = []
        for detection in net.forward()[0, 0]:
            score = float(detection[2])
            x = rl + int(round(float(detection[3]) * w))
            y = rt + int(round(float(detection[4]) * h))
            right = rl + int(round(float(detection[5]) * w))
            bottom = rt + int(round(float(detection[6]) * h))
            found.append((x, y, right - x, bottom - y, score))
        return found

    return detector
