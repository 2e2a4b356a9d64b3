"""Host-side 3D LUT handling: ``.cube`` parse/write, palette-LUT synthesis,
and an mtime-keyed cache.

Functional parity targets in the reference:
- parser: ``VRGDG_IV_Adjustments.py:221-282`` (TITLE/LUT_3D_SIZE/DOMAIN_*
  handling, 1D-LUT rejection, size^3*3 validation, C-order reshape to
  ``[blue, green, red, rgb]`` with red varying fastest),
- writer: ``VRGDG_IV_Adjustments.py:108-123``,
- palette generator: ``VRGDG_IV_Adjustments.py:68-105`` (Rec.709-luma
  palette interpolation with luma rescale and 0.82/0.18 chroma reinjection),
- cache: ``VRGDG_IV_Adjustments.py:203-219`` keyed on (path, mtime, size).

Everything here is plain numpy on the host; device code receives the table
as a ``(N, N, N, 3)`` float32 array indexed ``[b, g, r]``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np

from .colorspace import LUMA_B, LUMA_G, LUMA_R

NAMED_COLORS = {
    "black": "#000000", "white": "#ffffff", "red": "#ff0000",
    "green": "#00ff00", "blue": "#0000ff", "yellow": "#ffff00",
    "cyan": "#00ffff", "magenta": "#ff00ff", "orange": "#ffa500",
    "purple": "#800080", "pink": "#ffc0cb", "teal": "#008080",
}

SUPPORTED_LUT_EXTENSIONS = (".cube",)


@dataclass(frozen=True)
class LutData:
    """A parsed 3D LUT: ``table[b, g, r] -> rgb`` plus its input domain."""

    size: int
    table: np.ndarray                      # (N, N, N, 3) float32
    domain_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    domain_max: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    title: str = ""

    def __post_init__(self):
        if self.table.shape != (self.size, self.size, self.size, 3):
            raise ValueError(
                f"LUT table shape {self.table.shape} does not match size {self.size}.")


class CubeParseError(ValueError):
    pass


def parse_cube(path: str | os.PathLike) -> LutData:
    """Parse a ``.cube`` file into :class:`LutData`.

    Data lines are stored red-fastest, so a C-order reshape yields an array
    indexed ``[blue, green, red, rgb]`` — the same convention the reference
    documents at ``VRGDG_IV_Adjustments.py:272-274``.
    """
    path = os.fspath(path)
    size: int | None = None
    title = ""
    domain_min = np.zeros(3, np.float32)
    domain_max = np.ones(3, np.float32)
    samples: list[float] = []

    with open(path, "r", encoding="utf-8", errors="ignore") as handle:
        for raw in handle:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            keyword = line.split(None, 1)[0].upper()
            if keyword == "TITLE":
                title = line[5:].strip().strip('"')
                continue
            if keyword == "LUT_1D_SIZE":
                raise CubeParseError(
                    f"1D LUTs are not supported: {os.path.basename(path)}")
            if keyword == "LUT_3D_SIZE":
                fields = line.split()
                if len(fields) != 2:
                    raise CubeParseError(f"Invalid LUT_3D_SIZE line in {path}")
                size = int(fields[1])
                continue
            if keyword in ("DOMAIN_MIN", "DOMAIN_MAX"):
                fields = line.split()
                if len(fields) != 4:
                    raise CubeParseError(f"Invalid {keyword} line in {path}")
                vec = np.array([float(v) for v in fields[1:4]], np.float32)
                if keyword == "DOMAIN_MIN":
                    domain_min = vec
                else:
                    domain_max = vec
                continue
            fields = line.split()
            if len(fields) != 3:
                continue  # tolerate unknown metadata lines, like the reference
            try:
                samples.extend(float(v) for v in fields)
            except ValueError:
                continue

    if size is None:
        raise CubeParseError(f"Missing LUT_3D_SIZE in {path}")
    expected = size ** 3 * 3
    if len(samples) != expected:
        raise CubeParseError(
            f"Invalid LUT data length in {path}: expected {expected} floats, "
            f"got {len(samples)}.")

    table = np.asarray(samples, np.float32).reshape(size, size, size, 3)
    return LutData(size=size, table=table, domain_min=domain_min,
                   domain_max=domain_max, title=title)


def write_cube(lut: LutData | np.ndarray, path: str | os.PathLike,
               title: str = "") -> str:
    """Write a LUT to ``.cube`` (red varies fastest, 6 decimals), matching
    the reference writer at ``VRGDG_IV_Adjustments.py:108-123``."""
    path = os.fspath(path)
    table = lut.table if isinstance(lut, LutData) else np.asarray(lut, np.float32)
    size = int(table.shape[0])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = [
        f'TITLE "{title or os.path.basename(path)}"',
        f"LUT_3D_SIZE {size}",
        "DOMAIN_MIN 0.0 0.0 0.0",
        "DOMAIN_MAX 1.0 1.0 1.0",
    ]
    flat = table.reshape(-1, 3)
    lines.extend(f"{r:.6f} {g:.6f} {b:.6f}" for r, g, b in flat)
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("\n".join(lines) + "\n")
    return path


def parse_hex_color(token: str) -> np.ndarray:
    """``#rgb``/``#rrggbb``/basic color name -> float32 RGB in [0,1]
    (reference: ``VRGDG_IV_Adjustments.py:45-65``)."""
    token = str(token or "").strip().lower()
    token = NAMED_COLORS.get(token, token)
    token = token.removeprefix("#")
    if len(token) == 3:
        token = "".join(ch * 2 for ch in token)
    if len(token) != 6 or any(ch not in "0123456789abcdef" for ch in token):
        raise ValueError(
            f"Invalid color '{token}'. Use hex like #ff8800 or a basic color name.")
    return np.array([int(token[i:i + 2], 16) / 255.0 for i in (0, 2, 4)],
                    np.float32)


def parse_color_list(colors_text: str) -> np.ndarray:
    parts = [p.strip() for p in str(colors_text or "").split(",") if p.strip()]
    if not parts:
        raise ValueError("Provide one or more colors separated by commas.")
    return np.stack([parse_hex_color(p) for p in parts], axis=0)


def _interpolate_palette(luma: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Map luma in [0,1] onto evenly spaced palette stops per channel."""
    if palette.shape[0] == 1:
        return np.broadcast_to(palette[0], luma.shape + (3,)).astype(np.float32)
    stops = np.linspace(0.0, 1.0, palette.shape[0], dtype=np.float32)
    flat = luma.reshape(-1)
    channels = [np.interp(flat, stops, palette[:, c]) for c in range(3)]
    return np.stack(channels, axis=-1).reshape(luma.shape + (3,)).astype(np.float32)


def build_palette_lut(colors_text: str, lut_size: int = 33) -> LutData:
    """Synthesize a ``size^3`` LUT from a comma-separated color list.

    Math mirrors ``VRGDG_IV_Adjustments.py:90-105``: palette color chosen by
    the identity lattice's Rec.709 luma, rescaled so target luma tracks the
    source luma, then 18% of the source chroma is reinjected.
    """
    palette = parse_color_list(colors_text)
    size = int(lut_size)
    axis = np.linspace(0.0, 1.0, size, dtype=np.float32)
    blue, green, red = np.meshgrid(axis, axis, axis, indexing="ij")
    source = np.stack([red, green, blue], axis=-1)  # [b,g,r] lattice, rgb values

    luma = LUMA_R * source[..., 0] + LUMA_G * source[..., 1] + LUMA_B * source[..., 2]
    target = _interpolate_palette(luma, palette)

    target_luma = (LUMA_R * target[..., 0] + LUMA_G * target[..., 1]
                   + LUMA_B * target[..., 2])
    target = np.clip(target * (luma / np.maximum(target_luma, 1e-6))[..., None],
                     0.0, 1.0)

    source_chroma = source - luma[..., None]
    table = np.clip(target * 0.82 + (target + source_chroma) * 0.18, 0.0, 1.0)
    return LutData(size=size, table=table.astype(np.float32))


def identity_lut(size: int = 33) -> LutData:
    """The identity lattice: applying it must return the input exactly."""
    axis = np.linspace(0.0, 1.0, size, dtype=np.float32)
    blue, green, red = np.meshgrid(axis, axis, axis, indexing="ij")
    return LutData(size=size,
                   table=np.stack([red, green, blue], axis=-1).astype(np.float32))


def corner_bundle(lut: LutData | np.ndarray) -> np.ndarray:
    """Precompute the 8-corner bundle table for fast trilinear application.

    Returns a ``(N^3, 24)`` float32 array: row ``cell = (b0*N + g0)*N + r0``
    holds the LUT's rgb values at the cell's eight lattice corners
    (``hi = min(lo+1, N-1)``), corner-major then channel
    (``[c000, c100, c010, c110, c001, c101, c011, c111] x rgb``, where the
    corner digit order is blue/green/red lo->hi).

    One row gather per pixel fetches all eight trilinear corners.
    :func:`vrgdg_tpu_torch.ops.lut.apply_lut_bundle` consumes this table
    and is bit-identical to :func:`~vrgdg_tpu_torch.ops.lut.apply_lut`
    for arbitrary float inputs.  ~3.4 MB for N=33.
    """
    table = lut.table if isinstance(lut, LutData) else np.asarray(lut)
    n = table.shape[0]
    lo = np.arange(n)
    hi = np.minimum(lo + 1, n - 1)
    out = np.empty((n, n, n, 8, 3), np.float32)
    combos = [(lo, lo, lo), (hi, lo, lo), (lo, hi, lo), (hi, hi, lo),
              (lo, lo, hi), (hi, lo, hi), (lo, hi, hi), (hi, hi, hi)]
    for k, (b, g, r) in enumerate(combos):
        out[..., k, :] = table[b][:, g][:, :, r]
    return out.reshape(n ** 3, 24)


class LutCache:
    """Thread-safe single-entry-per-path LUT cache keyed on
    ``(path, mtime, size)`` (reference: ``VRGDG_IV_Adjustments.py:203-219``)."""

    def __init__(self, capacity: int = 8):
        self._capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: dict[tuple, LutData] = {}

    def load(self, path: str | os.PathLike) -> LutData:
        path = os.fspath(path)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"LUT file not found: {path}")
        stat = os.stat(path)
        key = (os.path.abspath(path), stat.st_mtime, stat.st_size)
        with self._lock:
            cached = self._entries.get(key)
        if cached is not None:
            return cached
        lut = parse_cube(path)
        with self._lock:
            if len(self._entries) >= self._capacity:
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = lut
        return lut

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


GLOBAL_LUT_CACHE = LutCache()


def list_lut_files(directory: str | os.PathLike) -> list[str]:
    """Sorted ``.cube`` filenames in a directory (reference:
    ``VRGDG_IV_Adjustments.py:25-36``)."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return []
    names = [n for n in os.listdir(directory)
             if os.path.isfile(os.path.join(directory, n))
             and n.lower().endswith(SUPPORTED_LUT_EXTENSIONS)]
    names.sort(key=str.lower)
    return names
