"""Still-image read, write and resize with Pillow's results, on OpenCV.

The JAX package reads and writes every still image with Pillow; the
port's machines have OpenCV and no Pillow.  These four functions give
Pillow's pixels through cv2 and numpy, and every still image of the port
goes through them:

- :func:`read_rgb` is ``Image.open(path).convert("RGB")``: EXIF
  orientation is ignored (cv2 applies it unless told not to), and a
  16-bit PNG comes out as Pillow's 8 bits (gray clipped at 255, the other
  colour types' high byte);
- :func:`read_rgb_exif_transposed` is ``ImageOps.exif_transpose(...)
  .convert("RGB")``: EXIF orientation applied;
- :func:`write_rgb` is ``Image.fromarray(u8).save(path)`` at Pillow's
  defaults for the extension (JPEG quality 75, WebP quality 80, PNG and
  BMP lossless), where cv2's own defaults are JPEG 95 and lossless WebP;
- :func:`pil_lanczos_resize` is ``Image.resize(size, LANCZOS)`` on an
  RGB image: Pillow's fixed-point two-pass filter (``Resample.c``), which
  is not cv2's ``INTER_LANCZOS4`` (4 lobes, float weights, no widening on
  a downscale).

cv2 is imported where it is used, so the package imports without it.
"""

from __future__ import annotations

import math
import os

import numpy as np

# Pillow's default save quality per extension, as cv2 parameters; an
# extension not listed here is written without parameters (PNG, BMP:
# lossless either way)
_JPEG_QUALITY = 75
_WEBP_QUALITY = 80
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Resample.c: 8-bit coefficients carry 32 - 8 - 2 fractional bits
_PRECISION_BITS = 22
_LANCZOS_SUPPORT = 3.0


def _png_16bit_color_type(path) -> int | None:
    """The IHDR colour type of a 16-bit PNG (0 gray, 2 RGB, 4 gray+alpha,
    6 RGBA), None for any other file."""
    with open(path, "rb") as handle:
        head = handle.read(26)
    if len(head) < 26 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    return head[25] if head[24] == 16 else None


def _imread(path, flags: int) -> np.ndarray:
    import cv2

    path = os.fspath(path)
    color_type = _png_16bit_color_type(path)
    if color_type is not None:
        flags |= cv2.IMREAD_ANYDEPTH
    bgr = cv2.imread(path, flags)
    if bgr is None:
        raise ValueError(f"Could not read the image {path}.")
    if color_type == 0:
        # Pillow opens a 16-bit gray PNG as I;16, and convert("RGB")
        # clips each value at 255
        bgr = np.minimum(bgr, 255).astype(np.uint8)
    elif color_type is not None:
        # gray+alpha, RGB and RGBA: Pillow keeps each value's high byte
        bgr = (bgr >> 8).astype(np.uint8)
    return np.ascontiguousarray(bgr[..., ::-1])


def read_rgb(path) -> np.ndarray:
    """Decode an image to (H, W, 3) uint8 RGB, ignoring EXIF orientation,
    as Pillow's ``Image.open(path).convert("RGB")`` does."""
    import cv2

    return _imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)


def read_rgb_exif_transposed(path) -> np.ndarray:
    """Decode an image to (H, W, 3) uint8 RGB with its EXIF orientation
    applied, as Pillow's ``ImageOps.exif_transpose(image).convert("RGB")``
    does."""
    import cv2

    return _imread(path, cv2.IMREAD_COLOR)


def write_rgb(path, u8: np.ndarray) -> str:
    """Encode (H, W, 3) uint8 RGB to ``path`` in the format its extension
    names, at Pillow's default settings for that format; raises when cv2
    cannot write it."""
    import cv2

    path = os.fspath(path)
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8 or u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"write_rgb takes (H, W, 3) uint8, not {u8.dtype} "
                         f"{u8.shape}.")
    ext = os.path.splitext(path)[1].lower()
    params: list[int] = []
    if ext in (".jpg", ".jpeg"):
        params = [cv2.IMWRITE_JPEG_QUALITY, _JPEG_QUALITY]
    elif ext == ".webp":
        params = [cv2.IMWRITE_WEBP_QUALITY, _WEBP_QUALITY]
    if not cv2.imwrite(path, np.ascontiguousarray(u8[..., ::-1]), params):
        raise RuntimeError(f"cv2 could not write the image {path}.")
    return path


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -_LANCZOS_SUPPORT <= x < _LANCZOS_SUPPORT:
        return _sinc(x) * _sinc(x / _LANCZOS_SUPPORT)
    return 0.0


def _coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for one
    axis: each output position's first input tap ``(out,)`` and its
    fixed-point weights ``(out, taps)`` (zero past its last tap).  Scalar
    float64 in Pillow's order (the weights summed one by one, libm's sin),
    so a weight on a rounding edge rounds as Pillow's does."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    one = float(1 << _PRECISION_BITS)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        count = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(count)]
        total = 0.0
        for w in k:
            total += w
        for x, w in enumerate(k):
            if total != 0.0:
                w /= total
            weights[xx, x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
        first[xx] = xmin
    return first, weights


def _resample_axis(u8: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 rows, 1
    columns) of an (H, W, C) uint8 image: integer accumulation from half a
    unit, shifted down and clipped to uint8."""
    in_size = u8.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    source = np.moveaxis(u8, axis, 0).astype(np.int64)
    acc = np.full((out_size, *source.shape[1:]),
                  1 << (_PRECISION_BITS - 1), np.int64)
    extra = (1,) * (source.ndim - 1)
    for tap in range(weights.shape[1]):
        index = np.minimum(first + tap, in_size - 1)
        acc += source[index] * weights[:, tap].reshape(-1, *extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def pil_lanczos_resize(u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """Resize (H, W, C) uint8 to ``(height, width)`` bit for bit as
    Pillow's ``Image.resize((width, height), Image.LANCZOS)`` does on an
    RGB image: the horizontal pass, then the vertical one, each only where
    that size changes; an equal size is an unfiltered copy."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8 or u8.ndim != 3:
        raise ValueError(f"pil_lanczos_resize takes (H, W, C) uint8, not "
                         f"{u8.dtype} {u8.shape}.")
    width, height = int(width), int(height)
    if width < 1 or height < 1:
        raise ValueError(f"Cannot resize to {width}x{height}.")
    out = u8
    if width != u8.shape[1]:
        out = _resample_axis(out, 1, width)
    if height != u8.shape[0]:
        out = _resample_axis(out, 0, height)
    return out.copy() if out is u8 else out
