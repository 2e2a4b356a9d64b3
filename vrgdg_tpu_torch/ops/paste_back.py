"""Feathered paste-back and face composites.

Counterpart of :mod:`vrgdg_tpu.ops.paste_back`, as torch ops on the
frames' device.  The three mask/composite variants:

1. :func:`soft_blend_mask` + :func:`paste_back`: rect/ellipse inset and
   feather distance fields, mean-shift colour match over ``alpha > 0.25``,
   bicubic crop resize, optional user mask;
2. :func:`radial_face_composite`: the radial ``1 - sqrt(xx^2 + yy^2)``
   alpha scaled by a feather ratio, per-entry strength, colour match over
   ``alpha > 0.35``, ±7-frame LTX tolerance;
3. :func:`soft_ellipse_mask` + :func:`ellipse_composite`: a filled ellipse
   with a 3.5% inset, feathered by a separable Gaussian with kernel
   ``max(3, 4*feather+1)`` and sigma ``max(0.1, feather)``, reflect-101
   borders (cv2's), however far the kernel reaches past the box.

Crop rectangles are Python ints (host-side geometry).  Each composite
clones its output once and writes the pasted regions in place, in the
order the original's functional updates take.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .resize import resample

CROP_DATA = tuple  # WAS-compatible: ((width, height), (left, top, right, bottom))


def soft_blend_mask(height: int, width: int, inset: float, feather: float,
                    shape: str = "ellipse", device=None) -> torch.Tensor:
    """Soft alpha mask from an inset + feather distance field."""
    yy = torch.arange(height, dtype=torch.float32,
                      device=device).reshape(height, 1)
    xx = torch.arange(width, dtype=torch.float32,
                      device=device).reshape(1, width)
    inset = max(0.0, min(float(inset), (min(width, height) - 1) / 2.0))

    if shape == "ellipse":
        cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
        rx, ry = max(0.5, cx - inset), max(0.5, cy - inset)
        distance = 1.0 - torch.sqrt(((xx - cx) / rx) ** 2
                                    + ((yy - cy) / ry) ** 2)
        distance = distance * min(rx, ry)  # normalized -> ~pixel distance
    else:
        distance = torch.minimum(
            torch.minimum(xx - inset, (width - 1 - inset) - xx),
            torch.minimum(yy - inset, (height - 1 - inset) - yy))

    if feather <= 0:
        return (distance >= 0).to(torch.float32)
    return torch.clamp(distance / float(feather), 0.0, 1.0)


def mean_shift_color_match(source: torch.Tensor, target: torch.Tensor,
                           alpha: torch.Tensor, strength: float,
                           threshold: float = 0.25,
                           min_pixels: int = 16) -> torch.Tensor:
    """Shift the source's mean toward the target over the blended region;
    a no-op when fewer than ``min_pixels`` pixels pass the alpha
    threshold (decided on the device, without a host round trip)."""
    if strength <= 0:
        return source
    selected = (alpha[..., 0] if alpha.ndim == 3 else alpha) > threshold
    count = selected.sum()
    weight = selected.to(source.dtype)[..., None]
    denom = torch.clamp(count.to(source.dtype), min=1.0)
    src_mean = (source * weight).sum(dim=(0, 1)) / denom
    dst_mean = (target * weight).sum(dim=(0, 1)) / denom
    shifted = torch.clamp(source + (dst_mean - src_mean) * float(strength),
                          0.0, 1.0)
    return torch.where(count >= min_pixels, shifted, source)


def _batch_item(tensor: torch.Tensor, index: int) -> torch.Tensor:
    return tensor[min(index, tensor.shape[0] - 1)]


def paste_back(original_image: torch.Tensor, enhanced_crop: torch.Tensor,
               crop_data, inset_padding: int = 8, feather_strength: int = 24,
               blend_shape: str = "ellipse", color_match: float = 0.65,
               mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Resize an enhanced crop back into its original rectangle with a
    feathered blend.  Returns ``(composited_batch, blend_mask_batch)``."""
    if not crop_data:
        raise ValueError(
            "No valid CROP_DATA. Provide ((w, h), (left, top, right, bottom)).")
    try:
        _original_size, box = crop_data
        x, y, right_edge, bottom_edge = (int(v) for v in box)
        crop_w, crop_h = right_edge - x, bottom_edge - y
    except (TypeError, ValueError) as exc:
        raise ValueError("Unsupported CROP_DATA format.") from exc
    if crop_w <= 0 or crop_h <= 0:
        raise ValueError(f"Invalid crop rectangle in CROP_DATA: {box!r}")

    batch = max(original_image.shape[0], enhanced_crop.shape[0],
                mask.shape[0] if mask is not None else 1)
    outputs, masks = [], []
    for index in range(batch):
        original = _batch_item(original_image, index)
        height, width = int(original.shape[0]), int(original.shape[1])
        left, top = min(x, width), min(y, height)
        right = min(left + crop_w, width)
        bottom = min(top + crop_h, height)
        paste_w, paste_h = right - left, bottom - top
        full_mask = torch.zeros((height, width), dtype=original.dtype,
                                device=original.device)
        if paste_w <= 0 or paste_h <= 0:
            outputs.append(original)
            masks.append(full_mask)
            continue

        crop = _batch_item(enhanced_crop, index).to(original.dtype)
        crop = resample(crop[None], crop_h, crop_w, "bicubic")[0]
        crop = crop[:paste_h, :paste_w, :original.shape[2]]

        alpha = soft_blend_mask(crop_h, crop_w, inset_padding,
                                feather_strength, blend_shape,
                                device=original.device)
        alpha = alpha[:paste_h, :paste_w]
        if mask is not None:
            user = _batch_item(mask, index).to(original.dtype)
            if user.ndim == 3:
                user = user[..., 0]
            user = resample(user[None, :, :, None], crop_h, crop_w,
                            "bilinear")[0, :, :, 0]
            alpha = alpha * torch.clamp(user[:paste_h, :paste_w], 0.0, 1.0)

        alpha3 = alpha[..., None]
        channels = crop.shape[2]
        target = original[top:bottom, left:right, :channels]
        crop = mean_shift_color_match(crop, target, alpha3, color_match)
        blended = target * (1.0 - alpha3) + crop * alpha3
        out = original.clone()
        out[top:bottom, left:right, :channels] = blended
        outputs.append(torch.clamp(out, 0.0, 1.0))
        full_mask[top:bottom, left:right] = alpha
        masks.append(full_mask)
    return torch.stack(outputs), torch.stack(masks)


def radial_face_composite(face_frames: torch.Tensor, originals: torch.Tensor,
                          entries: list[dict], feather_pixels: int = 18,
                          color_match: float = 0.65
                          ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Feather repaired face crops back into the original frames.

    ``entries[i]`` is ``{"box": (l, t, r, b) or None, "strength": float}``
    per source frame; frames without a box (no safe face) and LTX tail
    drift up to ±7 frames pass through untouched.  Returns
    ``(frames, masks, repaired_count)``.
    """
    delta = len(entries) - int(face_frames.shape[0])
    if abs(delta) > 7:
        raise ValueError(
            f"The model returned {face_frames.shape[0]} frames for "
            f"{len(entries)} source frames.")
    output = originals.clone()
    masks = torch.zeros(originals.shape[:3], dtype=originals.dtype,
                        device=originals.device)
    repaired = 0
    usable = min(len(entries), int(face_frames.shape[0]))
    for index in range(usable):
        entry = entries[index]
        box = entry.get("box")
        strength = float(entry.get("strength", 0.0))
        if not box or strength <= 0:
            continue
        left, top, right, bottom = (int(v) for v in box)
        h, w = bottom - top, right - left
        face = face_frames[index:index + 1, ..., :3].to(
            device=output.device, dtype=output.dtype)
        face = torch.clamp(resample(face, h, w, "bicubic")[0], 0.0, 1.0)

        yy = torch.linspace(-1.0, 1.0, h, dtype=output.dtype,
                            device=output.device)[:, None]
        xx = torch.linspace(-1.0, 1.0, w, dtype=output.dtype,
                            device=output.device)[None, :]
        radial = 1.0 - torch.sqrt(xx * xx + yy * yy)
        feather_scale = max(1.0, float(feather_pixels)
                            / max(1.0, min(w, h) / 2.0))
        alpha = torch.clamp(radial / feather_scale, 0.0, 1.0) * strength

        # the target reads this frame as earlier entries left it
        target = output[index, top:bottom, left:right, :3]
        face = mean_shift_color_match(face, target, alpha, color_match,
                                      threshold=0.35)
        blended = target * (1.0 - alpha[..., None]) + face * alpha[..., None]
        output[index, top:bottom, left:right, :3] = blended
        masks[index, top:bottom, left:right] = alpha
        repaired += 1
    return torch.clamp(output, 0.0, 1.0), masks, repaired


@functools.lru_cache(maxsize=64)
def _reflect_101(length: int, half: int) -> np.ndarray:
    """Source index of each of ``length + 2 * half`` padded positions under
    reflect-101 (``jnp.pad``/``np.pad`` mode ``"reflect"``), which reflects
    again and again where ``half`` reaches past the axis."""
    return np.pad(np.arange(length, dtype=np.int64), half, mode="reflect")


def gaussian_blur(image: torch.Tensor, kernel_size: int,
                  sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the leading two axes of a 2D tensor,
    cv2-compatible (reflect-101 border, normalized sampled kernel)."""
    kernel_size = int(kernel_size)
    if kernel_size % 2 == 0:
        kernel_size += 1
    half = kernel_size // 2
    x = np.arange(kernel_size, dtype=np.float64) - half
    kernel = np.exp(-(x ** 2) / (2.0 * float(sigma) ** 2))
    kernel = (kernel / kernel.sum()).astype(np.float32)
    taps = torch.from_numpy(kernel).to(image.device)

    def blur_axis(arr: torch.Tensor, axis: int) -> torch.Tensor:
        length = arr.shape[axis]
        index = torch.from_numpy(_reflect_101(length, half)).to(arr.device)
        padded = arr.index_select(axis, index)
        out = torch.zeros_like(arr)
        for i in range(kernel_size):
            out = out + padded.narrow(axis, i, length) * taps[i]
        return out

    return blur_axis(blur_axis(image, 0), 1)


def soft_ellipse_mask(width: int, height: int, feather: int,
                      device=None) -> torch.Tensor:
    """Filled ellipse with a 3.5% inset, feathered by a Gaussian with
    kernel ``max(3, 4*feather+1)`` and sigma ``max(0.1, feather)``, built
    analytically."""
    feather = max(0, int(feather))
    inset = max(2, int(round(min(width, height) * 0.035)))
    ax = max(1, width // 2 - inset)
    ay = max(1, height // 2 - inset)
    cx, cy = width // 2, height // 2
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    # +0.5 half-pixel bump matches cv2.ellipse's boundary rasterization
    mask = ((((xx - cx) / (ax + 0.5)) ** 2 + ((yy - cy) / (ay + 0.5)) ** 2)
            <= 1.0).to(torch.float32)
    if feather > 0:
        kernel = max(3, feather * 4 + 1)
        mask = gaussian_blur(mask, kernel, max(0.1, float(feather)))
    return torch.clamp(mask, 0.0, 1.0)


def ellipse_composite(original: torch.Tensor, enhanced: torch.Tensor,
                      crop_box, feather: int = 18, color_match: float = 0.65,
                      composite_strength: float = 1.0) -> torch.Tensor:
    """Single-frame ellipse composite on [0,1] float HWC frames: resize the
    repaired crop into the box (lanczos4), ellipse-feather, mean-shift
    colour match over ``alpha > 0.35``, fade by ``composite_strength``."""
    left, top, right, bottom = (int(v) for v in crop_box)
    h, w = bottom - top, right - left
    if h <= 0 or w <= 0:
        raise ValueError(f"Invalid crop box: {crop_box!r}")
    resized = torch.clamp(resample(enhanced[None, ..., :3], h, w,
                                   "lanczos4")[0], 0.0, 1.0)
    target = original[top:bottom, left:right, :3]
    base_alpha = soft_ellipse_mask(w, h, feather, device=original.device)
    resized = mean_shift_color_match(resized, target, base_alpha,
                                     color_match, threshold=0.35)
    alpha = (base_alpha * max(0.0, min(1.0, float(composite_strength))))[
        ..., None]
    blended = target * (1.0 - alpha) + resized * alpha
    out = original.clone()
    out[top:bottom, left:right, :3] = blended
    return torch.clamp(out, 0.0, 1.0)
