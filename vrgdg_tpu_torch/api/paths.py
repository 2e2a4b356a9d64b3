"""Path safety for the appliers: LUT-name resolution inside the LUT folder
and media-path resolution.

Counterpart of the part of :mod:`vrgdg_tpu.api.paths` that the appliers
use (traversal-proof resolution via ``os.path.commonpath`` root checks,
reference ``VRGDG_LUTVideoTools.py:34-139``).
"""

from __future__ import annotations

import os

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_LUTS_DIR = os.environ.get(
    "VRGDG_TPU_LUTS", os.path.join(os.path.dirname(_PACKAGE_ROOT), "LUTS"))

SUPPORTED_IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
SUPPORTED_VIDEO_EXTENSIONS = {".mp4", ".mov", ".mkv", ".webm", ".avi", ".m4v"}


def _inside(root: str, path: str) -> bool:
    try:
        return os.path.commonpath([os.path.abspath(root),
                                   os.path.abspath(path)]) == os.path.abspath(root)
    except ValueError:
        return False


def safe_lut_path(lut_name: str, luts_dir: str | None = None) -> str:
    """Resolve a LUT name inside the LUT folder, rejecting traversal."""
    luts_dir = os.path.abspath(luts_dir or DEFAULT_LUTS_DIR)
    name = os.path.basename(str(lut_name or "").strip())
    if not name.lower().endswith(".cube"):
        raise ValueError("LUT names must end in .cube")
    path = os.path.abspath(os.path.join(luts_dir, name))
    if not _inside(luts_dir, path):
        raise ValueError("LUT path escapes the LUT folder.")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"LUT file not found: {path}")
    return path


def resolve_media_path(value, label: str = "Input") -> str:
    path = os.path.normpath(os.path.abspath(str(value or "").strip().strip('"')))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{label} file was not found: {path}")
    return path
