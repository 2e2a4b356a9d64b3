"""Path safety, LUT catalog, preview roots and adjust-preset persistence.

A copy of :mod:`vrgdg_tpu.api.paths` (which cannot be imported without
JAX).  Functional parity targets in the reference:
- traversal-proof resolution via ``os.path.commonpath`` root checks
  (``VRGDG_LUTVideoTools.py:34-139``),
- LUT catalog with paired example images (``:188-219``),
- adjust presets: JSON files with sanitized names, save/import/list
  (``:669-733``).
"""

from __future__ import annotations

import json
import os
import re
import time

from ..core.cube import list_lut_files
from ..core.params import AdjustSettings

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_LUTS_DIR = os.environ.get(
    "VRGDG_TPU_LUTS", os.path.join(os.path.dirname(_PACKAGE_ROOT), "LUTS"))
DEFAULT_OUTPUT_ROOT = os.environ.get(
    "VRGDG_TPU_OUTPUT", os.path.join(os.getcwd(), "vrgdg_output"))

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


def list_luts(luts_dir: str | None = None) -> dict:
    """LUT catalog with example-image pairing
    (``VRGDG_LUTVideoTools.py:188-219``)."""
    luts_dir = os.path.abspath(luts_dir or DEFAULT_LUTS_DIR)
    examples_dir = os.path.join(luts_dir, "examples")
    items = []
    example_lookup: dict[str, str] = {}
    if os.path.isdir(examples_dir):
        for name in os.listdir(examples_dir):
            stem, ext = os.path.splitext(name)
            if ext.lower() in SUPPORTED_IMAGE_EXTENSIONS:
                example_lookup[stem.lower()] = name
                example_lookup[_example_key(stem)] = name
    for name in list_lut_files(luts_dir):
        path = os.path.join(luts_dir, name)
        stem = os.path.splitext(name)[0]
        example = (example_lookup.get(stem.lower(), "")
                   or example_lookup.get(_example_key(stem), ""))
        items.append({
            "name": name,
            "label": stem.replace("_", " "),
            "path": path,
            "example_name": example,
            "size": os.path.getsize(path),
            "modified": os.path.getmtime(path),
        })
    return {"luts": items, "luts_dir": luts_dir, "examples_dir": examples_dir}


def _example_key(stem: str) -> str:
    return re.sub(r"[^a-z0-9]+", "", stem.lower())


def preview_root(base: str | None = None) -> str:
    path = os.path.join(base or DEFAULT_OUTPUT_ROOT, "_tmp", "lut_previews")
    os.makedirs(path, exist_ok=True)
    return path


# --------------------------------------------------------------------------
# Adjust presets
# --------------------------------------------------------------------------

def presets_dir(base: str | None = None) -> str:
    path = os.path.join(base or DEFAULT_OUTPUT_ROOT, "VRGDG_AdjustPresets")
    os.makedirs(path, exist_ok=True)
    return path


def _sanitize_preset_name(name: str) -> str:
    cleaned = re.sub(r"[^A-Za-z0-9 _.-]+", "_", str(name or "").strip())
    cleaned = cleaned.strip(" ._") or "preset"
    return cleaned[:80]


def save_adjust_preset(name: str, settings, base: str | None = None) -> dict:
    safe = _sanitize_preset_name(name)
    normalized = AdjustSettings.normalize(
        settings if isinstance(settings, dict) else settings.to_dict())
    path = os.path.join(presets_dir(base), f"{safe}.json")
    document = {"name": safe, "settings": normalized.to_dict(),
                "saved_at": time.time()}
    temp = path + ".tmp"
    with open(temp, "w", encoding="utf-8") as handle:
        json.dump(document, handle, indent=2)
    os.replace(temp, path)
    return {"name": safe, "path": path, "settings": normalized.to_dict()}


def list_adjust_presets(base: str | None = None) -> list[dict]:
    folder = presets_dir(base)
    presets = []
    for name in sorted(os.listdir(folder), key=str.lower):
        if not name.lower().endswith(".json"):
            continue
        path = os.path.join(folder, name)
        try:
            with open(path, "r", encoding="utf-8") as handle:
                document = json.load(handle)
            settings = AdjustSettings.normalize(document.get("settings"))
        except Exception:
            continue
        presets.append({"name": document.get("name")
                        or os.path.splitext(name)[0],
                        "path": path, "settings": settings.to_dict()})
    return presets


def import_adjust_preset(source_path: str, base: str | None = None) -> dict:
    source_path = resolve_media_path(source_path, "Preset")
    with open(source_path, "r", encoding="utf-8") as handle:
        document = json.load(handle)
    name = document.get("name") or os.path.splitext(
        os.path.basename(source_path))[0]
    return save_adjust_preset(name, document.get("settings") or {}, base)


def delete_adjust_preset(name: str, base: str | None = None) -> bool:
    folder = presets_dir(base)
    path = os.path.join(folder, f"{_sanitize_preset_name(name)}.json")
    if not _inside(folder, path) or not os.path.isfile(path):
        return False
    os.remove(path)
    return True
