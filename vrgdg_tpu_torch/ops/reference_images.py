"""Reference-image preparation for multi-reference conditioning.

Counterpart of :mod:`vrgdg_tpu.ops.reference_images`: the deterministic
image math of the multi-reference conditioning family, as torch ops on
the images' device (the parsing and size math are the original's,
copied):

* :func:`scale_dims`: the megapixel-budget target size snapped to
  ``resolution_steps``;
* :func:`scale_to_total_pixels`: that resize, crop disabled;
* :func:`batch_reference_images`: the preview batch: channels padded to
  the widest image with 1.0, spatial dims conformed to the first image by
  **center-crop + bilinear**;
* :func:`parse_image_paths`: the FromPaths variant's path-list parser.

Center-crop semantics follow ComfyUI's ``common_upscale(crop="center")``
contract: crop the *source* to the target aspect ratio (round-half-even
margins), then resample.
"""

from __future__ import annotations

import json
import math
import re

import torch
import torch.nn.functional as F

from .resize import canonical_method, resample

__all__ = ["MAX_REFERENCE_IMAGES", "parse_image_paths", "scale_dims",
           "scale_to_total_pixels", "center_crop_box", "upscale_center",
           "batch_reference_images"]

MAX_REFERENCE_IMAGES = 50  # VRGDG_GeneralNodes2.py:3775

# the node's dropdown values all resolve through the resampler's own
# alias table (canonical_method); "lanczos" -> "lanczos4" included


def _path_of(item) -> str:
    """One candidate -> cleaned path text (dicts contribute their first
    truthy ``path``/``file``/``image`` field)."""
    if isinstance(item, dict):
        item = item.get("path") or item.get("file") or item.get("image")
    return str(item or "").strip().strip('"').strip("'")


def parse_image_paths(raw) -> list[str]:
    """Path list from UI text: JSON list / dict (``image_paths`` or
    ``images`` keys, else the dict's values) or newline-separated text;
    items may be dicts carrying ``path``/``file``/``image``; quotes and
    whitespace are stripped and blanks dropped
    (``VRGDG_GeneralNodes2.py:3955-3999``)."""
    text = str(raw or "").strip()
    if not text:
        return []
    try:
        candidates = json.loads(text)
    except Exception:
        candidates = None
    if isinstance(candidates, dict):
        listed = [candidates[key] for key in ("image_paths", "images")
                  if isinstance(candidates.get(key), list)]
        candidates = listed[0] if listed else list(candidates.values())
    if not isinstance(candidates, list):
        candidates = re.split(r"[\r\n]+", text)
    return [path for path in map(_path_of, candidates) if path]


def scale_dims(height: int, width: int, megapixels: float,
               resolution_steps: int) -> tuple[int, int]:
    """Target ``(height, width)`` for a ``megapixels`` budget, each axis
    rounded (round-half-even, as the reference's builtin ``round``) to a
    multiple of ``resolution_steps`` with a floor of 1
    (``VRGDG_GeneralNodes2.py:3832-3846``)."""
    total = float(megapixels) * 1024 * 1024
    scale_by = math.sqrt(total / (int(width) * int(height)))
    steps = max(1, int(resolution_steps))
    out_w = max(1, round(int(width) * scale_by / steps) * steps)
    out_h = max(1, round(int(height) * scale_by / steps) * steps)
    return out_h, out_w


def scale_to_total_pixels(images: torch.Tensor, upscale_method: str,
                          megapixels: float,
                          resolution_steps: int) -> torch.Tensor:
    """Resize a BHWC batch to its megapixel-budget dims, no cropping
    (the reference passes ``crop="disabled"``)."""
    method = canonical_method(upscale_method)
    out_h, out_w = scale_dims(int(images.shape[1]), int(images.shape[2]),
                              megapixels, resolution_steps)
    return resample(images, out_h, out_w, method)


def center_crop_box(src_h: int, src_w: int, dst_h: int,
                    dst_w: int) -> tuple[int, int, int, int]:
    """``(top, left, crop_h, crop_w)`` of the aspect-matching center
    window: the wider-aspect side loses symmetric margins of
    ``round(extent * (1 - covered_fraction) / 2)`` (ComfyUI
    ``common_upscale(crop="center")`` contract)."""
    old_aspect = src_w / src_h
    new_aspect = dst_w / dst_h
    left = top = 0
    if old_aspect > new_aspect:
        left = round((src_w - src_w * (new_aspect / old_aspect)) / 2)
    elif old_aspect < new_aspect:
        top = round((src_h - src_h * (old_aspect / new_aspect)) / 2)
    return top, left, src_h - 2 * top, src_w - 2 * left


def upscale_center(images: torch.Tensor, target_height: int,
                   target_width: int,
                   method: str = "bilinear") -> torch.Tensor:
    """Center-crop to the target aspect, then resample — the conforming
    step the batching loop applies to every image whose spatial dims
    differ from the first's (``VRGDG_GeneralNodes2.py:3874-3881``)."""
    top, left, crop_h, crop_w = center_crop_box(
        int(images.shape[1]), int(images.shape[2]),
        int(target_height), int(target_width))
    window = images[:, top:top + crop_h, left:left + crop_w, :]
    return resample(window, int(target_height), int(target_width),
                    canonical_method(method))


def batch_reference_images(images) -> torch.Tensor:
    """Concatenate BHWC reference batches into one preview batch on the
    first image's device.

    The first image fixes the spatial dims; channel counts grow to the
    running maximum with constant 1.0 padding; spatial mismatches conform
    by center-crop bilinear.  Raises on an empty list with the
    reference's message.
    """
    if not images:
        raise ValueError("VRGDG Multi Reference Conditioning needs at "
                         "least one connected image input.")
    if len(images) == 1:
        return torch.as_tensor(images[0])
    base = torch.as_tensor(images[0])
    batched = [base]
    for image in images[1:]:
        nxt = torch.as_tensor(image).to(base.device)
        if nxt.shape[-1] != base.shape[-1]:
            channels = max(nxt.shape[-1], base.shape[-1])
            if base.shape[-1] < channels:
                base = F.pad(base, (0, channels - base.shape[-1]),
                             value=1.0)
                batched[0] = base
            if nxt.shape[-1] < channels:
                nxt = F.pad(nxt, (0, channels - nxt.shape[-1]), value=1.0)
        if nxt.shape[1:] != base.shape[1:]:
            nxt = upscale_center(nxt, base.shape[1], base.shape[2],
                                 "bilinear")
        batched.append(nxt)
    return torch.cat(batched, dim=0)
