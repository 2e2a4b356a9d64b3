"""Checkpoint manifests: fingerprinting, atomic writes, resume pruning.

Reproduces the reference's enhancer manifest design (SURVEY.md §5.4;
``VRGDG_StandaloneVideoEnhancerNodes.py:342-375, 527-543``):

- a sha256 fingerprint over source identity (path/size/mtime), frame count
  and the full settings dict — resume refuses when it changes,
- atomic ``.tmp`` + ``os.replace`` manifest writes,
- ``completed_segments`` pruned against the files actually on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Mapping

MANIFEST_NAME = "manifest.json"


def manifest_path(job_folder: str) -> str:
    return os.path.join(job_folder, MANIFEST_NAME)


def write_manifest(job_folder: str, document: Mapping[str, Any]) -> None:
    os.makedirs(job_folder, exist_ok=True)
    path = manifest_path(job_folder)
    temp = path + ".tmp"
    with open(temp, "w", encoding="utf-8") as handle:
        json.dump(document, handle, indent=2)
    os.replace(temp, path)


def read_manifest(job_folder: str) -> dict:
    try:
        with open(manifest_path(job_folder), "r", encoding="utf-8") as handle:
            value = json.load(handle)
    except (OSError, ValueError):
        # missing, unreadable, or corrupt manifests all mean "no resume"
        return {}
    return value if isinstance(value, dict) else {}


def settings_fingerprint(source_path: str, settings: Mapping[str, Any],
                         frame_count: int) -> str:
    stat = os.stat(source_path)
    document = {
        "source_path": source_path,
        "source_size": int(stat.st_size),
        "source_mtime": float(stat.st_mtime),
        "frame_count": int(frame_count),
        "settings": dict(settings),
    }
    payload = json.dumps(document, sort_keys=True).encode("utf-8")
    return hashlib.sha256(payload).hexdigest()


def segment_file_name(index: int) -> str:
    return f"segment_{index:05d}.mp4"


def prune_completed(completed, total_segments: int,
                    segments_folder: str) -> set[int]:
    """Keep only indices that are in range *and* whose segment file exists
    on disk (``VRGDG_StandaloneVideoEnhancerNodes.py:531-543``)."""
    valid = set()
    for value in completed or []:
        try:
            index = int(value)
        except (TypeError, ValueError):
            continue
        if 0 <= index < total_segments and os.path.isfile(
                os.path.join(segments_folder, segment_file_name(index))):
            valid.add(index)
    return valid
