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
  BMP lossless), where cv2's own defaults are JPEG 95 and lossless WebP,
  or at the quality asked for;
- :func:`pil_lanczos_resize` is ``Image.resize(size, LANCZOS)`` on an
  RGB image: Pillow's fixed-point two-pass filter (``Resample.c``), which
  is not cv2's ``INTER_LANCZOS4`` (4 lobes, float weights, no widening on
  a downscale).

Two readers stand in for Pillow where it only measures an image:

- :func:`channel_stats` is ``ImageStat.Stat(Image.open(path).convert(
  "RGB"))``'s ``mean`` and ``stddev``, to the bit: Pillow's float64
  sums over the 256-bin histogram, in its order;
- :func:`image_size` is ``Image.open(path).size``: ``(width, height)``
  from the file's header alone (PNG, JPEG, GIF, WebP, BMP, TIFF), EXIF
  orientation ignored as Pillow's lazy open does, and Pillow's message
  for a file that holds none of these.

cv2 is imported where it is used, so the package imports without it.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from types import SimpleNamespace

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


def write_rgb(path, u8: np.ndarray, quality: int | None = None) -> str:
    """Encode (H, W, 3) uint8 RGB to ``path`` in the format its extension
    names, at Pillow's default settings for that format or at
    ``quality`` (JPEG and WebP, as Pillow's ``save(quality=)``); raises
    when cv2 cannot write it."""
    import cv2

    path = os.fspath(path)
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8 or u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"write_rgb takes (H, W, 3) uint8, not {u8.dtype} "
                         f"{u8.shape}.")
    ext = os.path.splitext(path)[1].lower()
    params: list[int] = []
    if ext in (".jpg", ".jpeg"):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality or _JPEG_QUALITY]
    elif ext == ".webp":
        params = [cv2.IMWRITE_WEBP_QUALITY, quality or _WEBP_QUALITY]
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


def channel_stats(path) -> SimpleNamespace:
    """``mean`` and ``stddev`` (lists of 3 floats) of the image's R, G and
    B, as Pillow's ``ImageStat.Stat(Image.open(path).convert("RGB"))``
    gives them: from each channel's 256-bin histogram, ``sum`` and
    ``sum2`` accumulated in bin order as Python floats, ``mean = sum / n``
    and ``stddev = sqrt((sum2 - sum ** 2 / n) / n)``.  numpy's ``mean`` and
    ``std`` sum in another order and differ in the last bits."""
    rgb = read_rgb(path)
    means, stddevs = [], []
    for channel in range(3):
        histogram = np.bincount(rgb[..., channel].ravel(),
                                minlength=256).tolist()
        count = sum(histogram)
        total, total2 = 0.0, 0.0
        for level in range(256):
            total += level * histogram[level]
        for level in range(256):
            total2 += (level ** 2) * float(histogram[level])
        means.append(total / count if count else 0)
        variance = (total2 - (total ** 2.0) / count) / count if count else 0
        stddevs.append(math.sqrt(variance))
    return SimpleNamespace(mean=means, stddev=stddevs)


# JPEG start-of-frame markers: every SOFn but DHT (C4), JPG (C8), DAC (CC)
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _png_size(head: bytes):
    if head[12:16] == b"IHDR" and len(head) < 29:
        # Pillow reads the header chunk whole or raises this
        raise OSError("Truncated File Read")
    if len(head) < 33 or head[12:16] != b"IHDR":
        return None
    if zlib.crc32(head[12:29]) != struct.unpack(">I", head[29:33])[0]:
        return None
    return struct.unpack(">II", head[16:24])


def _jpeg_size(handle):
    """The last start-of-frame's size, read as Pillow's JPEG plugin reads
    the header: marker by marker up to the start of scan, bytes between
    markers skipped; None when the header ends first."""
    handle.seek(3)
    size, lead = None, b"\xff"
    while lead:
        if lead[0] != 0xFF:
            lead = handle.read(1)
            continue
        code = handle.read(1)
        if not code:
            return None
        code = code[0]
        if code == 0xFF:
            continue
        if code == 0x00 or 0xD0 <= code <= 0xD9:
            lead = handle.read(1)
            continue
        length = handle.read(2)
        if len(length) < 2:
            return None
        wanted = struct.unpack(">H", length)[0] - 2
        segment = handle.read(wanted)
        if len(segment) < wanted:
            # Pillow reads each segment whole or raises this
            raise OSError("Truncated File Read")
        if code in _JPEG_SOF:
            if len(segment) < 5:
                return None
            height, width = struct.unpack(">HH", segment[1:5])
            size = (width, height)
        if code == 0xDA:
            return size
        lead = handle.read(1)
    return None


def _webp_size(head: bytes):
    chunk = head[12:16]
    if chunk == b"VP8 " and head[23:26] == b"\x9d\x01\x2a":
        width, height = struct.unpack("<HH", head[26:30])
        return width & 0x3FFF, height & 0x3FFF
    if chunk == b"VP8L" and head[20:21] == b"\x2f":
        bits = int.from_bytes(head[21:25], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if chunk == b"VP8X" and len(head) >= 30:
        return (int.from_bytes(head[24:27], "little") + 1,
                int.from_bytes(head[27:30], "little") + 1)
    return None


def _bmp_size(head: bytes):
    header_size = struct.unpack("<I", head[14:18])[0]
    if header_size == 12:
        return struct.unpack("<HH", head[18:22])
    if header_size in (40, 52, 56, 64, 108, 124):
        width, height = struct.unpack("<iI", head[18:26])
        # a top-down bitmap stores its height negative
        return width, (2 ** 32 - height if head[25] == 0xFF else height)
    return None


def _tiff_size(handle, head: bytes):
    order = "<" if head[:2] == b"II" else ">"
    big = head[2:4] in (b"+\x00", b"\x00+")
    if big:
        offset = struct.unpack(order + "Q", head[8:16])[0]
        count_format, entry_size, value_at = "Q", 20, 12
    else:
        offset = struct.unpack(order + "I", head[4:8])[0]
        count_format, entry_size, value_at = "H", 12, 8
    handle.seek(offset)
    raw = handle.read(struct.calcsize(count_format))
    if len(raw) < struct.calcsize(count_format):
        return None
    tags = {}
    for _ in range(struct.unpack(order + count_format, raw)[0]):
        entry = handle.read(entry_size)
        if len(entry) < entry_size:
            return None
        tag, kind = struct.unpack(order + "HH", entry[:4])
        if tag in (256, 257, 274) and kind in (3, 4):
            value = entry[value_at:value_at + (2 if kind == 3 else 4)]
            tags[tag] = struct.unpack(order + ("H" if kind == 3 else "I"),
                                      value)[0]
    if 256 not in tags or 257 not in tags:
        return None
    width, height = tags[256], tags[257]
    # Pillow reports a TIFF's size with its orientation tag applied
    return (height, width) if tags.get(274) in (5, 6, 7, 8) \
        else (width, height)


def image_size(path) -> tuple[int, int]:
    """``(width, height)`` from the image file's header, as Pillow's lazy
    ``Image.open(path).size``: no pixel data is read, so a file whose
    pixel data is cut short still has a size, and EXIF orientation is
    ignored (a TIFF's own orientation tag is not, as in Pillow).  A file
    that is none of PNG, JPEG, GIF, WebP, BMP or TIFF raises ``OSError``
    with Pillow's message."""
    path = os.fspath(path)
    size = None
    with open(path, "rb") as handle:
        head = handle.read(64)
        try:
            if head[:8] == _PNG_SIGNATURE:
                size = _png_size(head)
            elif head[:3] == b"\xff\xd8\xff":
                size = _jpeg_size(handle)
            elif head[:6] in (b"GIF87a", b"GIF89a"):
                size = struct.unpack("<HH", head[6:10])
            elif head[:4] == b"RIFF" and head[8:12] == b"WEBP":
                size = _webp_size(head)
            elif head[:2] == b"BM" and len(head) >= 26:
                size = _bmp_size(head)
            elif head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00",
                              b"MM\x00+"):
                size = _tiff_size(handle, head)
        except struct.error:
            size = None
    if size is None or size[0] <= 0 or size[1] <= 0:
        raise OSError("cannot identify image file %r" % path)
    return int(size[0]), int(size[1])
