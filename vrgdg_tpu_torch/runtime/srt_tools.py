"""SRT utilities: lyric-duration merging and latest-file discovery.

A copy of :mod:`vrgdg_tpu.runtime.srt_tools` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

Re-derivations of the reference's small SRT text/timing tools:

- :func:`merge_srt_lyrics` — ``SRTLyricsMerger``
  (``GeneralVideoNodes2.py:1139-1185``): stamp each ``lyricSegmentN``
  key of a lyrics JSON with the duration of SCENE ``N`` from an SRT.
- :func:`latest_srt` — ``VRGDG_LatestSRTAutoLoader``
  (``GeneralVideoNodes.py:2980-3064``): newest ``.srt`` by modification
  time across the run folder (plus any legacy folders).

The SRT block parser itself lives in
:func:`vrgdg_tpu_torch.runtime.audio_toolkit.parse_srt`.
"""

from __future__ import annotations

import json
import os
import re

_SCENE_BLOCK = re.compile(
    r"(\d+)\s+(\d\d:\d\d:\d\d,\d\d\d)\s*-->\s*(\d\d:\d\d:\d\d,\d\d\d)"
    r"\s+SCENE\s+(\d+)")
_LYRIC_KEY = re.compile(r"lyricSegment(\d+)")


def _seconds(stamp: str) -> float:
    hours, minutes, rest = stamp.split(":")
    secs, millis = rest.split(",")
    return int(hours) * 3600 + int(minutes) * 60 + int(secs) \
        + int(millis) / 1000.0


def scene_durations(srt_text: str) -> dict[int, float]:
    """Scene number -> duration seconds for every ``SCENE N`` block."""
    return {int(scene): _seconds(end) - _seconds(start)
            for _, start, end, scene in _SCENE_BLOCK.findall(srt_text)}


def merge_srt_lyrics(srt_text: str, lyrics_json: str | dict) -> str:
    """Append ``_Duration_<seconds>s`` to every ``lyricSegmentN`` key,
    taking the duration from the SRT's SCENE ``N`` block (``UNKNOWN``
    when the SRT has no such scene).  Non-segment keys are dropped,
    matching the reference.  Returns indented JSON text."""
    lyrics = json.loads(lyrics_json) if isinstance(lyrics_json, str) \
        else dict(lyrics_json)
    durations = scene_durations(srt_text)
    merged = {}
    for key, value in lyrics.items():
        match = _LYRIC_KEY.search(key)
        if not match:
            continue
        duration = durations.get(int(match.group(1)))
        label = f"{duration:.3f}s" if duration is not None else "UNKNOWN"
        merged[f"{key}_Duration_{label}"] = value
    return json.dumps(merged, indent=2)


def latest_srt(directory: str, *extra_directories: str,
               require: bool = False) -> tuple[str, str]:
    """``(full_path, file_name)`` of the newest ``.srt`` (by mtime)
    across the given folders; ``("", "")`` when none exist unless
    ``require``."""
    candidates: list[tuple[float, str, str]] = []
    for folder in (directory, *extra_directories):
        if not folder or not os.path.isdir(folder):
            continue
        for entry in os.scandir(folder):
            if entry.is_file() and entry.name.lower().endswith(".srt"):
                candidates.append((entry.stat().st_mtime, entry.path,
                                   entry.name))
    if not candidates:
        if require:
            raise FileNotFoundError(
                f"No .srt files found in: {directory}")
        return "", ""
    _, path, name = max(candidates)
    return path, name
