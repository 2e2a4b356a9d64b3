"""Music Video Builder project store (the non-LLM builder backend).

A copy of :mod:`vrgdg_tpu.api.builder` (which cannot be imported
without JAX): every function keeps its original's source.

Framework-native re-derivation of the reference Video Builder's
project/session subsystem: project lifecycle, session persistence with
media-path rehydration, portable ZIP export/import, per-scene media and
audio management, cursor-timeline audio mixing, waveform/beat analysis,
render logs, wizard drafts, and CapCut beat import.

Behavioral parity targets (all in
``VRGDG_MusicVideoBuilderNodes.py``):

- project layout + lifecycle: ``:606-739`` (safe names, unique folders,
  new project, save-as) and ``:9397-9493`` (load/list/delete),
- session save with asset snapshot + the lyric-clear guard:
  ``:8380-8498``,
- media-path rehydration on load: ``:1630-1944``,
- portable ZIP export/import with member safety: ``:8501-8656``,
- scene media: ``:8724-8912`` (save/archive/delete/final-frame/flux
  reference), ``:8913-9011`` (subject/location card import),
- audio: ``:9013-9079`` (scene/project audio save + m4a conversion),
  ``:9119-9199`` (trim), ``:9200-9395`` (timeline mix),
- SRT/prompt loaders: ``:1945-2031``, ``:2695-2704``,
- waveform peaks + beat estimation: ``:2820-2945``,
- CapCut project beat import: ``:2946-3080``,
- scene video scan/restore + thumbnails: ``:9494-9791``,
- wizard drafts ``:8658-8723``, render logs ``:757-878``, model
  defaults ``:8260-8347``, prompt-creator import ``:202-412``.

Deliberate departures from the reference design:

- every entry point takes an explicit ``output_root`` (no global server
  state), defaulting to :data:`vrgdg_tpu_torch.api.paths.DEFAULT_OUTPUT_ROOT`;
- the timeline audio mix is assembled natively in numpy (decode each
  source once, resample, concatenate along a cursor timeline) instead of
  spawning two ffmpeg subprocesses per scene; ffmpeg is only needed to
  *decode* non-WAV sources and to convert ``.m4a`` uploads;
- thumbnails and final-frame extraction use cv2 with graceful failure
  instead of requiring an ffmpeg binary;
- path handling is table-driven: one generic walker plus declarative key
  tables implement snapshot, rebase, and rehydration rather than
  hand-unrolled per-key blocks.
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import re
import shutil
import threading
import time
import zipfile
from contextlib import contextmanager
from dataclasses import dataclass

import cv2
import numpy as np

from .paths import DEFAULT_OUTPUT_ROOT, _inside

SESSION_FILENAME = "vrgdg_builder_session.json"
SRT_FILENAME = "builder_segments.srt"
SCENE_NOTES_FILENAME = "SceneNotes.json"
PACKAGE_MANIFEST = "vrgdg_project_package.json"

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp")
AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".m4a", ".ogg")
VIDEO_EXTENSIONS = (".mp4", ".mov", ".mkv", ".webm", ".avi")

# Reference context files created for every project
# (VRGDG_MusicVideoBuilderNodes.py:650-662).
CONTEXT_FILENAMES = ("ConceptPrompts.txt", "I2VMotionNotes.txt",
                     "themestyle.txt", "storyconcept.txt",
                     "subjectsandscenes.txt")

# session keys that point at context text files, and the canonical
# file each is snapshotted to inside project_context (:1363-1368)
SESSION_CONTEXT_FILES = {
    "prompt_json_path": "ConceptPrompts.txt",
    "theme_style_path": "themestyle.txt",
    "story_idea_path": "storyconcept.txt",
    "subject_scene_path": "subjectsandscenes.txt",
}

# per-segment keys that hold media paths (:1603-1611)
SEGMENT_MEDIA_KEYS = ("approved_image_path", "custom_image_path",
                      "ref_image_path", "flux_subject_image_path",
                      "flux_location_image_path", "video_path",
                      "custom_audio_path")

# the subset copied into per-scene context folders on snapshot (:1494-1500)
SEGMENT_REFERENCE_KEYS = ("custom_image_path", "ref_image_path",
                          "flux_subject_image_path",
                          "flux_location_image_path")

MODEL_DEFAULT_KEYS = (
    "text_gemma_runner", "llm_max_tokens", "gemma_context_limit",
    "gemma_output_token_limit", "gemma_gpu_layers", "lm_studio_base_url",
    "lm_studio_model", "lm_studio_api_key", "lm_studio_context_limit",
    "lm_studio_output_token_limit", "image_model_mode", "zimage_settings",
    "reference_krea2_settings", "flux_klein_settings",
    "ernie_image_settings", "krea2_2pass_settings", "z_enhance_settings",
    "video_model_mode", "i2v_video_settings",
)


# The reference's handlers run serialized on ComfyUI's event loop; here
# sync route bodies run in a thread pool, so read-modify-write session
# updates (save, render-log fold-in, export's rewrite) take a
# per-project lock to keep the same effective serialization.
_PROJECT_LOCKS: dict[str, threading.Lock] = {}
_PROJECT_LOCKS_GUARD = threading.Lock()


@contextmanager
def project_write_lock(folder):
    key = os.path.normcase(os.path.abspath(str(folder or "")))
    with _PROJECT_LOCKS_GUARD:
        lock = _PROJECT_LOCKS.setdefault(key, threading.Lock())
    with lock:
        yield


def _clean(value) -> str:
    return str(value or "").strip().strip('"')


def safe_component(value, fallback: str = "VRGDG_MusicVideoBuilder") -> str:
    """Filesystem-safe project/file name (reference ``_safe_project_name``,
    ``:606-609``)."""
    text = re.sub(r"[^A-Za-z0-9_. -]+", "_", _clean(value)).strip(" ._")
    return text or fallback


def require_file(value, label: str = "file") -> str:
    text = _clean(value)
    if not text:
        raise ValueError(f"{label} path is empty.")
    path = os.path.abspath(text)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{label} was not found: {path}")
    return path


def unique_folder(path: str) -> str:
    """First free ``path``, ``path_002``, ... (``:619-630``)."""
    folder = os.path.abspath(_clean(path))
    if not folder:
        raise ValueError("Project folder is empty.")
    candidates = itertools.chain(
        (folder,), (f"{folder}_{n:03d}" for n in range(2, 10000)))
    free = next((p for p in candidates if not os.path.exists(p)), None)
    if free is None:
        raise RuntimeError(f"Could not find a unique folder for: {folder}")
    return free


def unique_file(path: str) -> str:
    base = os.path.abspath(_clean(path))
    folder, name = os.path.split(base)
    stem, ext = os.path.splitext(name)
    os.makedirs(folder, exist_ok=True)
    numbered = (os.path.join(folder, f"{stem}_{n:02d}{ext}")
                for n in itertools.count(2))
    return next(p for p in itertools.chain((base,), numbered)
                if not os.path.exists(p))


@dataclass(frozen=True)
class ProjectLayout:
    """All on-disk locations of one builder project.

    Folder and file names are the reference's exactly, so a project saved
    by the ComfyUI pack loads here unchanged (``:741-755``, ``:879-887``,
    ``:1197-1241``).
    """

    root: str

    @property
    def session_path(self):
        return os.path.join(self.root, SESSION_FILENAME)

    @property
    def srt_path(self):
        return os.path.join(self.root, SRT_FILENAME)

    @property
    def scene_notes_path(self):
        return os.path.join(self.root, SCENE_NOTES_FILENAME)

    @property
    def images_folder(self):
        return os.path.join(self.root, "zimage_approved")

    @property
    def prompts_folder(self):
        return os.path.join(self.root, "prompts")

    @property
    def context_folder(self):
        return os.path.join(self.root, "project_context")

    @property
    def wizard_folder(self):
        return os.path.join(self.root, "wizard")

    @property
    def scene_audio_folder(self):
        return os.path.join(self.root, "scene_audio")

    @property
    def project_audio_folder(self):
        return os.path.join(self.root, "project_audio")

    @property
    def videos_folder(self):
        return os.path.join(self.root, "rendered_scene_videos")

    @property
    def video_backup_root(self):
        return os.path.join(self.root, "rendered_scene_videos_backup")

    @property
    def previews_root(self):
        return os.path.join(self.root, "scene_image_previews")

    @property
    def render_logs_folder(self):
        return os.path.join(self.root, "render_logs")

    @property
    def session_backups_folder(self):
        return os.path.join(self.root, "session_backups")

    @property
    def scene_srt_folder(self):
        return os.path.join(self.root, "scene_srt")

    @property
    def trimmed_audio_folder(self):
        return os.path.join(self.root, "scene_audio_trimmed")

    @property
    def portable_folder(self):
        return os.path.join(self.root, "portable_assets")

    def scene_image_path(self, scene: int, ext: str = ".png") -> str:
        ext = str(ext or ".png").lower()
        if ext not in IMAGE_EXTENSIONS:
            ext = ".png"
        return os.path.join(self.images_folder,
                            f"image_{max(1, int(scene or 1)):04d}{ext}")

    def scene_audio_path(self, scene: int, ext: str = ".wav") -> str:
        ext = str(ext or ".wav").lower()
        if ext not in AUDIO_EXTENSIONS:
            ext = ".wav"
        return os.path.join(self.scene_audio_folder,
                            f"audio_{max(1, int(scene or 1)):04d}{ext}")

    def scene_video_path(self, scene: int) -> str:
        return os.path.join(self.videos_folder,
                            f"video_{max(1, int(scene or 1)):04d}-audio.mp4")

    def preview_folder(self, scene: int) -> str:
        return os.path.join(self.previews_root,
                            f"scene_{max(1, int(scene or 1)):04d}")

    def new_preview_path(self, scene: int, ext: str = ".png") -> str:
        folder = self.preview_folder(scene)
        os.makedirs(folder, exist_ok=True)
        ext = str(ext or ".png").lower()
        if ext not in IMAGE_EXTENSIONS:
            ext = ".png"
        stamp = time.strftime("%Y%m%d_%H%M%S")
        candidate = os.path.join(folder, f"preview_{stamp}{ext}")
        index = 2
        while os.path.exists(candidate):
            candidate = os.path.join(folder,
                                     f"preview_{stamp}_{index:02d}{ext}")
            index += 1
        return candidate

    def ensure_base_folders(self):
        for folder in (self.root, self.images_folder, self.prompts_folder,
                       self.context_folder):
            os.makedirs(folder, exist_ok=True)

    def describe(self) -> dict:
        context = self.context_folder
        return {
            "project_folder": self.root,
            "session_path": self.session_path,
            "srt_path": self.srt_path,
            "images_folder": self.images_folder,
            "prompts_folder": self.prompts_folder,
            "context_folder": context,
            "concept_prompts_path": os.path.join(context,
                                                 "ConceptPrompts.txt"),
            "i2v_motion_notes_path": os.path.join(context,
                                                  "I2VMotionNotes.txt"),
            "theme_style_path": os.path.join(context, "themestyle.txt"),
            "story_idea_path": os.path.join(context, "storyconcept.txt"),
            "subject_scene_path": os.path.join(context,
                                               "subjectsandscenes.txt"),
        }


def layout_for(payload_or_folder) -> ProjectLayout:
    """Layout for a payload dict (``project_folder`` key) or raw path."""
    if isinstance(payload_or_folder, dict):
        raw = _clean(payload_or_folder.get("project_folder"))
    else:
        raw = _clean(payload_or_folder)
    if not raw:
        raise ValueError("Project folder is empty.")
    return ProjectLayout(os.path.abspath(raw))


def project_target(payload: dict, output_root: str,
                   preferred_key: str = "project_folder") -> str:
    """Resolve the folder a new project should be created at
    (``:632-650``): explicit path > name under optional ``project_root``
    > name under ``output_root``."""
    raw = _clean(payload.get(preferred_key)) or _clean(
        payload.get("project_name"))
    if not raw:
        raw = f"VRGDG_Project_{time.strftime('%Y%m%d_%H%M%S')}"
    if os.path.isabs(raw) or os.path.dirname(raw):
        return os.path.abspath(raw)
    custom_root = _clean(payload.get("project_root"))
    if custom_root:
        if not os.path.isabs(custom_root):
            raise ValueError(
                "Custom project root must be a full absolute folder path.")
        return os.path.join(os.path.abspath(custom_root),
                            safe_component(raw))
    return os.path.join(os.path.abspath(output_root), safe_component(raw))


# --------------------------------------------------------------------------
# data-URL media decode
# --------------------------------------------------------------------------

def data_url_bytes(raw) -> bytes:
    text = _clean(raw)
    if not text:
        raise ValueError("Media data is empty.")
    if text.lower().startswith("data:") and "," in text:
        text = text.split(",", 1)[1]
    return base64.b64decode(text)


def save_data_url_image(raw, target_path: str) -> str:
    """Decode a base64/data-URL image and write it as PNG via cv2 (the
    reference uses PIL; ``:8738-8741``)."""
    buffer = np.frombuffer(data_url_bytes(raw), np.uint8)
    image = cv2.imdecode(buffer, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise ValueError("Image data could not be decoded.")
    os.makedirs(os.path.dirname(target_path), exist_ok=True)
    if not cv2.imwrite(target_path, image):
        raise ValueError(f"Could not write image: {target_path}")
    return target_path


def image_preview_data_url(path: str, max_height: int = 220,
                           quality: int = 72) -> str:
    """Small JPEG data URL for card previews (``:8920-8925``); empty
    string when the image cannot be read."""
    image = cv2.imread(path, cv2.IMREAD_COLOR)
    if image is None:
        return ""
    height, width = image.shape[:2]
    if height > max_height:
        scale = max_height / float(height)
        image = cv2.resize(image, (max(1, int(round(width * scale))),
                                   max_height),
                           interpolation=cv2.INTER_AREA)
    ok, encoded = cv2.imencode(
        ".jpg", image, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    if not ok:
        return ""
    return ("data:image/jpeg;base64,"
            + base64.b64encode(encoded.tobytes()).decode("ascii"))


# --------------------------------------------------------------------------
# SRT segments and prompt JSON
# --------------------------------------------------------------------------

def format_srt_time(seconds) -> str:
    total_ms = max(0, int(round(float(seconds or 0) * 1000)))
    hours, rest = divmod(total_ms, 3600000)
    minutes, rest = divmod(rest, 60000)
    secs, millis = divmod(rest, 1000)
    return f"{hours:02d}:{minutes:02d}:{secs:02d},{millis:03d}"


def parse_srt_time(text) -> float:
    match = re.match(r"^\s*(\d+):(\d+):(\d+)[,.](\d+)\s*$", str(text or ""))
    if not match:
        raise ValueError(f"Invalid SRT time: {text}")
    hours, minutes, seconds, millis = (int(part)
                                       for part in match.groups())
    return hours * 3600 + minutes * 60 + seconds + millis / 1000.0


def segments_to_srt(segments) -> str:
    """Timeline scenes -> SRT text (``:2695-2704``): ordered by start,
    minimum 0.1 s, label falling back to the T2I prompt."""
    ordered = sorted((seg for seg in segments or []
                      if isinstance(seg, dict)),
                     key=lambda seg: float(seg.get("start", 0) or 0))
    lines = []
    for index, seg in enumerate(ordered, start=1):
        start = float(seg.get("start", 0) or 0)
        end = max(start + 0.1,
                  float(seg.get("end", start + 4) or start + 4))
        # content strip only — labels may legitimately end in quotes
        text = str(seg.get("label") or seg.get("t2i_prompt")
                   or f"Scene {index}").strip()
        lines += [str(index),
                  f"{format_srt_time(start)} --> {format_srt_time(end)}",
                  text, ""]
    return "\n".join(lines).strip() + "\n"


def parse_srt_segments(srt_text) -> list[dict]:
    """SRT text -> timeline scene dicts with the reference's field set
    (``:1964-1994``)."""
    segments = []
    for block in re.split(r"\n\s*\n", str(srt_text or "").strip()):
        lines = [line.strip() for line in block.splitlines()
                 if line.strip()]
        timing = next((line for line in lines if "-->" in line), "")
        if not timing:
            continue
        left, right = (part.strip() for part in timing.split("-->", 1))
        start = parse_srt_time(left)
        end = max(start + 0.1, parse_srt_time(right))
        label = " ".join(lines[lines.index(timing) + 1:]).strip()
        label = label or f"Scene {len(segments) + 1}"
        segments.append({
            "id": f"srt_{len(segments) + 1}_{int(start * 1000)}",
            "start": round(start, 3), "end": round(end, 3),
            "label": label[:80] or f"Scene {len(segments) + 1}",
            "notes": label,
            "t2i_prompt": "", "i2v_prompt": "", "ref_image_path": "",
            "use_vision_reference": False, "image": None,
            "source": "srt",
        })
    return segments


def load_srt(path) -> dict:
    srt_path = require_file(path, "SRT file")
    with open(srt_path, "r", encoding="utf-8-sig") as handle:
        segments = parse_srt_segments(handle.read())
    if not segments:
        raise ValueError("No SRT timing blocks were found.")
    return {"srt_path": srt_path, "segments": segments}


def load_prompt_json(path) -> dict:
    """Numbered-key JSON object / list -> ordered prompt list
    (``:2005-2031``)."""
    json_path = require_file(path, "Prompt JSON")
    with open(json_path, "r", encoding="utf-8-sig") as handle:
        data = json.load(handle)

    def key_number(key):
        match = re.search(r"(\d+)", str(key or ""))
        return int(match.group(1)) if match else 999999

    prompts = []
    if isinstance(data, dict):
        prompts = [str(data.get(key, "") or "").strip()
                   for key in sorted(data, key=key_number)]
    elif isinstance(data, list):
        for item in data:
            if isinstance(item, str):
                prompts.append(item.strip())
            elif isinstance(item, dict):
                prompts.extend(str(item.get(key, "") or "").strip()
                               for key in sorted(item, key=key_number))
    else:
        raise ValueError("Prompt JSON must be an object or list.")
    if not prompts:
        raise ValueError("Prompt JSON did not contain any prompt text.")
    return {"prompt_json_path": json_path, "prompts": prompts}


# --------------------------------------------------------------------------
# path machinery: rebase / snapshot / rehydrate
# --------------------------------------------------------------------------

def rebase_path(new_root: str, old_root: str, raw) -> str:
    """Re-anchor ``raw`` from ``old_root`` to ``new_root`` when it lives
    inside the old project; else '' (``:1334-1346``)."""
    text = _clean(raw)
    if not text or not old_root:
        return ""
    old_abs = os.path.abspath(old_root)
    raw_abs = os.path.abspath(text)
    if not _inside(old_abs, raw_abs):
        return ""
    return os.path.abspath(
        os.path.join(new_root, os.path.relpath(raw_abs, old_abs)))


def map_strings(value, fn):
    """Apply ``fn`` to every string inside nested dict/list structures."""
    if isinstance(value, dict):
        return {key: map_strings(item, fn) for key, item in value.items()}
    if isinstance(value, list):
        return [map_strings(item, fn) for item in value]
    if isinstance(value, str):
        return fn(value)
    return value


def overlay_slot(segment, fallback_index: int) -> int:
    """Stable >=10001 slot number for an overlay-track scene
    (``:1668-1678``)."""
    if isinstance(segment, dict):
        for key in ("overlay_slot_number", "scene_slot_number",
                    "slot_number"):
            try:
                value = int(segment.get(key, 0) or 0)
            except (TypeError, ValueError):
                value = 0
            if value >= 10001:
                return value
    return 10000 + int(fallback_index or 1)


def assign_overlay_slots(overlay_segments):
    """Give every overlay scene a unique >=10001 slot, preserving
    existing assignments (``:1680-1703``)."""
    if not isinstance(overlay_segments, list):
        return overlay_segments
    taken = set()
    existing = [overlay_slot(seg, 0) for seg in overlay_segments
                if isinstance(seg, dict)]
    next_slot = max([10000] + [slot for slot in existing
                               if slot >= 10001]) + 1
    for index, seg in enumerate(overlay_segments, start=1):
        if not isinstance(seg, dict):
            continue
        slot = overlay_slot(seg, index)
        if slot in taken:
            slot = max(next_slot, 10000 + index)
            while slot in taken:
                slot += 1
            next_slot = slot + 1
        seg["overlay_slot_number"] = slot
        taken.add(slot)
    return overlay_segments


def _session_lists(session):
    """Normalized ``(segments, overlay_segments)`` lists stored back on
    the session; overlays get slots assigned."""
    segments = session.get("segments")
    if not isinstance(segments, list):
        segments = []
        session["segments"] = segments
    overlays = session.get("overlay_segments")
    if not isinstance(overlays, list):
        overlays = []
        session["overlay_segments"] = overlays
    assign_overlay_slots(overlays)
    return segments, overlays


def iter_scene_entries(session):
    """Yield ``(scene_number, segment)`` over base scenes (1..N) and
    overlay scenes (slot numbers >=10001)."""
    segments, overlays = _session_lists(session)
    for number, seg in enumerate(segments, start=1):
        if isinstance(seg, dict):
            yield number, seg
    for index, seg in enumerate(overlays, start=1):
        if isinstance(seg, dict):
            yield overlay_slot(seg, index), seg


def copy_file_into(source, target) -> str:
    """copy2 ``source`` -> exact ``target`` path; '' when missing
    (``:1383-1394``)."""
    source = _clean(source)
    if not source or not os.path.isfile(source):
        return ""
    source = os.path.abspath(source)
    target = os.path.abspath(target)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if os.path.normcase(source) != os.path.normcase(target):
        shutil.copy2(source, target)
    return target


def convert_audio_to_wav(source_path, target_path) -> str:
    """Decode any supported audio and write 44.1 kHz stereo 16-bit WAV.

    The reference shells out to ffmpeg (``:1295-1323``); here the decode
    goes through :func:`audio_toolkit.decode_audio_file` (native WAV
    parse, ffmpeg pipe otherwise) and the resample/write is numpy."""
    from ..runtime import audio_toolkit as at

    source = require_file(source_path, "Audio file")
    target = os.path.abspath(_clean(target_path))
    os.makedirs(os.path.dirname(target), exist_ok=True)
    wave_ct, rate = at.decode_audio_file(source)
    wave_ct = at.resample_waveform(wave_ct, rate, 44100)
    if wave_ct.shape[0] == 1:
        wave_ct = np.repeat(wave_ct, 2, axis=0)
    at.save_wav(target, at.make_audio(wave_ct[:2], 44100))
    if not os.path.isfile(target) or os.path.getsize(target) <= 0:
        raise ValueError(
            "Audio conversion finished, but the WAV file was not created.")
    return target


def import_project_audio(source_path, target_folder,
                         target_name=None) -> str:
    """Copy audio into the project; ``.m4a`` is converted to WAV
    (``:1325-1332``)."""
    source = require_file(source_path, "Audio file")
    name = target_name or os.path.basename(source)
    stem, ext = os.path.splitext(name)
    if os.path.splitext(source)[1].lower() == ".m4a":
        return convert_audio_to_wav(
            source, os.path.join(target_folder,
                                 f"{safe_component(stem)}.wav"))
    ext = ext or os.path.splitext(source)[1]
    return copy_file_into(
        source, os.path.join(target_folder, f"{safe_component(stem)}{ext}"))


def snapshot_context_assets(layout: ProjectLayout, session: dict,
                            audio_path: str,
                            old_root: str = "") -> tuple[str, dict]:
    """Pull the project audio and context text files into the project
    (``:1348-1381``); paths that are gone but lived inside ``old_root``
    are rebased instead."""
    if audio_path and os.path.isfile(audio_path):
        copied = import_project_audio(
            audio_path, layout.project_audio_folder,
            "project_audio" + os.path.splitext(audio_path)[1])
        audio_path = copied or audio_path
    elif old_root:
        audio_path = rebase_path(layout.root, old_root,
                                 audio_path) or audio_path
    for key, filename in SESSION_CONTEXT_FILES.items():
        raw = _clean(session.get(key))
        if raw and os.path.isfile(raw):
            copied = copy_file_into(
                raw, os.path.join(layout.context_folder, filename))
            if copied:
                session[key] = copied
        else:
            rebased = rebase_path(layout.root, old_root, raw)
            if rebased:
                session[key] = rebased
    return audio_path, session


def _reference_asset_target(layout: ProjectLayout, scene: int, key: str,
                            source: str) -> str:
    ext = os.path.splitext(source)[1].lower() or ".png"
    if ext not in IMAGE_EXTENSIONS + AUDIO_EXTENSIONS:
        ext = ".bin"
    safe_key = re.sub(r"[^A-Za-z0-9_.-]+", "_",
                      str(key or "asset")).strip("_") or "asset"
    return os.path.join(layout.context_folder,
                        f"scene_{max(1, int(scene or 1)):04d}",
                        f"{safe_key}{ext}")


def _is_approved_image_path(path) -> bool:
    parts = os.path.normpath(str(path or "")).split(os.sep)
    return "zimage_approved" in {part.lower() for part in parts}


def _ingest_scene_media(layout: ProjectLayout, scene: int, seg: dict):
    """Copy one scene's external media into the project's canonical
    locations (``:1441-1545``)."""
    approved = _clean(seg.get("approved_image_path"))
    if approved and os.path.isfile(approved):
        ext = os.path.splitext(approved)[1] or ".png"
        seg["approved_image_path"] = copy_file_into(
            approved, layout.scene_image_path(scene, ext))

    history = seg.get("image_history")
    kept = []
    if isinstance(history, list):
        for item in history:
            item_path = _clean(item)
            if not item_path or not os.path.isfile(item_path):
                continue
            if item_path == approved or _is_approved_image_path(item_path):
                continue
            ext = os.path.splitext(item_path)[1] or ".png"
            copied = copy_file_into(item_path,
                                    layout.new_preview_path(scene, ext))
            if copied and copied not in kept:
                kept.append(copied)
    seg["image_history"] = kept
    if kept:
        try:
            index = int(seg.get("image_history_index", len(kept) - 1) or 0)
        except (TypeError, ValueError):
            index = len(kept) - 1
        seg["image_history_index"] = max(0, min(len(kept) - 1, index))
    else:
        seg["image_history_index"] = -1

    video = _clean(seg.get("video_path"))
    if video and os.path.isfile(video):
        seg["video_path"] = copy_file_into(video,
                                           layout.scene_video_path(scene))
        seg["video_folder"] = os.path.dirname(seg["video_path"])
        seg["video_status"] = "done"

    custom_audio = _clean(seg.get("custom_audio_path"))
    if custom_audio and os.path.isfile(custom_audio):
        ext = os.path.splitext(custom_audio)[1] or ".wav"
        seg["custom_audio_path"] = copy_file_into(
            custom_audio, layout.scene_audio_path(scene, ext))

    for key in SEGMENT_REFERENCE_KEYS:
        source = _clean(seg.get(key))
        if source and os.path.isfile(source):
            copied = copy_file_into(
                source, _reference_asset_target(layout, scene, key, source))
            if copied:
                seg[key] = copied
    if isinstance(seg.get("flux_image_ingredients"), list):
        for number, ingredient in enumerate(seg["flux_image_ingredients"],
                                            start=1):
            if not isinstance(ingredient, dict):
                continue
            source = _clean(ingredient.get("path"))
            if source and os.path.isfile(source):
                copied = copy_file_into(
                    source, _reference_asset_target(
                        layout, scene, f"flux_ingredient_{number}", source))
                if copied:
                    ingredient["path"] = copied


def ingest_session_assets(layout: ProjectLayout, session: dict) -> dict:
    """Copy every externally-referenced media file the session points at
    into the project (``:1421-1545``)."""
    if isinstance(session.get("flux_global_image_ingredients"), list):
        folder = os.path.join(layout.context_folder, "flux_global")
        for number, ingredient in enumerate(
                session["flux_global_image_ingredients"], start=1):
            if not isinstance(ingredient, dict):
                continue
            source = _clean(ingredient.get("path"))
            if source and os.path.isfile(source):
                ext = os.path.splitext(source)[1].lower() or ".png"
                copied = copy_file_into(
                    source, os.path.join(
                        folder, f"global_ingredient_{number}{ext}"))
                if copied:
                    ingredient["path"] = copied
    for scene, seg in iter_scene_entries(session):
        _ingest_scene_media(layout, scene, seg)
        if scene >= 10001:
            seg["track"] = "overlay"
    return session


def rebase_session_paths(layout: ProjectLayout, old_root: str,
                         session: dict,
                         require_exists: bool = False) -> dict:
    """Point every project-owned path at the new root (``:1546-1629``).

    Unlike the reference's per-key blocks this walks the whole session:
    any absolute path string inside ``old_root`` is rebased. Strings
    outside the old project are untouched. With ``require_exists`` the
    rebase only sticks when the rebased file exists — the rehydration
    contract (``:1779-1784``), where a still-valid old-root path must
    survive so :func:`resolve_asset` can keep using it. Save-as/export
    rebase unconditionally (assets were just copied in)."""
    if not old_root:
        return session

    def rebase_one(text):
        if not os.path.isabs(text):
            return text
        rebased = rebase_path(layout.root, old_root, text)
        if not rebased:
            return text
        if require_exists and not os.path.exists(rebased):
            return text
        return rebased

    return map_strings(session, rebase_one)


def _asset_candidates(layout: ProjectLayout, old_root: str, raw,
                      scene=None):
    """Every location a missing media path may have moved to
    (``:1630-1666``)."""
    text = _clean(raw)
    if not text:
        return
    yield text
    abs_text = os.path.abspath(text)
    yield abs_text
    if old_root and _inside(os.path.abspath(old_root), abs_text):
        yield os.path.join(layout.root,
                           os.path.relpath(abs_text,
                                           os.path.abspath(old_root)))
    base = os.path.basename(text)
    if base:
        for folder in (layout.root, layout.images_folder,
                       layout.context_folder, layout.project_audio_folder,
                       layout.scene_audio_folder, layout.videos_folder):
            yield os.path.join(folder, base)
    if scene:
        scene = int(scene)
        for ext in IMAGE_EXTENSIONS:
            yield layout.scene_image_path(scene, ext)
        for ext in (".wav", ".mp3", ".m4a"):
            yield layout.scene_audio_path(scene, ext)
        yield layout.scene_video_path(scene)


def resolve_asset(layout: ProjectLayout, old_root: str, raw,
                  scene=None) -> str:
    for candidate in _asset_candidates(layout, old_root, raw, scene):
        if candidate and os.path.isfile(candidate):
            return os.path.abspath(candidate)
    return str(raw or "")


def _scene_numbers_on_disk(layout: ProjectLayout) -> set[int]:
    """Scene numbers recoverable from loose media files (``:1712-1735``)."""
    numbers = set()
    patterns = (
        (layout.images_folder, r"^image_(\d+)\.(?:png|jpe?g|webp)$"),
        (layout.videos_folder, r"^video_(\d+)-audio\.mp4$"),
    )
    for folder, pattern in patterns:
        if not os.path.isdir(folder):
            continue
        regex = re.compile(pattern, re.IGNORECASE)
        for name in os.listdir(folder):
            match = regex.match(name)
            if match and os.path.isfile(os.path.join(folder, name)):
                numbers.add(int(match.group(1)))
    if os.path.isdir(layout.previews_root):
        for name in os.listdir(layout.previews_root):
            match = re.match(r"^scene_(\d+)$", name, re.IGNORECASE)
            if match and os.path.isdir(
                    os.path.join(layout.previews_root, name)):
                numbers.add(int(match.group(1)))
    return numbers


def _preview_paths(layout: ProjectLayout, scene: int) -> list[str]:
    folder = layout.preview_folder(scene)
    if not os.path.isdir(folder):
        return []
    found = [os.path.abspath(os.path.join(folder, name))
             for name in os.listdir(folder)
             if os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS
             and os.path.isfile(os.path.join(folder, name))]
    found.sort(key=os.path.getmtime)
    return found


def _is_recovered(seg) -> bool:
    return (str(seg.get("source", "") or "").lower() == "recovered"
            or str(seg.get("id", "") or "").startswith("recovered_scene_"))


def _drop_overlapping_recovered(segments):
    """A recovered placeholder scene must not shadow a real scene at the
    same timeline position (``:1826-1850``)."""
    real_ranges = []
    for seg in segments:
        if isinstance(seg, dict) and not _is_recovered(seg):
            start = float(seg.get("start", 0) or 0)
            real_ranges.append(
                (start, float(seg.get("end", start) or start)))
    kept = []
    for seg in segments:
        if not isinstance(seg, dict):
            continue
        if _is_recovered(seg):
            start = float(seg.get("start", 0) or 0)
            end = float(seg.get("end", start) or start)
            if any(min(end, other_end) - max(start, other_start) > 0.05
                   for other_start, other_end in real_ranges):
                continue
        kept.append(seg)
    return kept


def _rehydrate_scene(layout: ProjectLayout, old_root: str, scene: int,
                     seg: dict, overlay: bool, ordinal: int = 0):
    """Re-find one scene's media on disk (``:1854-1943``); ``scene`` is
    the asset slot (>=10001 for overlays), ``ordinal`` the positional
    index the default overlay label uses (``:1914-1916``)."""
    default_label = (f"Insert {ordinal or 1}" if overlay
                     else f"Scene {scene}")
    label = str(seg.get("label", "") or "").strip()  # content strip
    if not label or label.lower() == "new scene":
        seg["label"] = default_label
    for key in SEGMENT_MEDIA_KEYS:
        seg[key] = resolve_asset(layout, old_root, seg.get(key, ""), scene)
    if isinstance(seg.get("image_history"), list):
        seg["image_history"] = [
            resolved for item in seg["image_history"]
            if (resolved := resolve_asset(layout, old_root, item, scene))]
    else:
        seg["image_history"] = []
    if isinstance(seg.get("flux_image_ingredients"), list):
        for ingredient in seg["flux_image_ingredients"]:
            if isinstance(ingredient, dict):
                ingredient["path"] = resolve_asset(
                    layout, old_root, ingredient.get("path", ""), scene)

    cleared = bool(seg.get("image_assignment_cleared", False))
    approved = resolve_asset(layout, old_root,
                             seg.get("approved_image_path", ""), scene)
    if not overlay and not os.path.isfile(approved) and not cleared:
        for ext in IMAGE_EXTENSIONS:
            candidate = layout.scene_image_path(scene, ext)
            if os.path.isfile(candidate):
                approved = os.path.abspath(candidate)
                break
    if approved and os.path.isfile(approved):
        seg["approved_image_path"] = approved
        seg["image_history"] = [
            item for item in seg["image_history"]
            if item != approved and not _is_approved_image_path(item)]
    if overlay or not cleared:
        for preview in _preview_paths(layout, scene):
            if preview not in seg["image_history"]:
                seg["image_history"].append(preview)
    if (not overlay and seg["image_history"]
            and not isinstance(seg.get("image_history_index"), int)):
        seg["image_history_index"] = len(seg["image_history"]) - 1
    video = layout.scene_video_path(scene)
    if os.path.isfile(video):
        seg["video_path"] = os.path.abspath(video)
        seg["video_folder"] = os.path.dirname(os.path.abspath(video))
        seg["video_status"] = "done"
    if overlay:
        seg["track"] = "overlay"


def rehydrate_session(layout: ProjectLayout, session: dict) -> dict:
    """Reattach a loaded session to the media actually on disk
    (``:1766-1943``)."""
    old_root = str(session.get("project_folder", "") or "")
    session = rebase_session_paths(layout, old_root, session,
                                   require_exists=True)
    session["project_folder"] = layout.root
    session["audio_path"] = resolve_asset(layout, old_root,
                                          session.get("audio_path", ""))
    for key in SESSION_CONTEXT_FILES:
        session[key] = resolve_asset(layout, old_root,
                                     session.get(key, ""))
    if isinstance(session.get("flux_global_image_ingredients"), list):
        for ingredient in session["flux_global_image_ingredients"]:
            if isinstance(ingredient, dict):
                ingredient["path"] = resolve_asset(
                    layout, old_root, ingredient.get("path", ""))

    segments, overlays = _session_lists(session)
    if not segments:
        # rebuild placeholder scenes from loose media, 4 s apart
        # (:1810-1824); only base-track scene numbers count
        base_numbers = [number for number
                        in _scene_numbers_on_disk(layout)
                        if number < 10000]
        for index in range(1, (max(base_numbers) if base_numbers else 0)
                           + 1):
            start = float((index - 1) * 4)
            segments.append({"id": f"recovered_scene_{index}",
                             "label": f"Scene {index}",
                             "start": start, "end": start + 4,
                             "source": "recovered"})
    session["segments"] = _drop_overlapping_recovered(segments)

    for index, seg in enumerate(session["segments"], start=1):
        if isinstance(seg, dict):
            _rehydrate_scene(layout, old_root, index, seg, overlay=False)
    for index, seg in enumerate(overlays, start=1):
        if isinstance(seg, dict):
            _rehydrate_scene(layout, old_root, overlay_slot(seg, index),
                             seg, overlay=True, ordinal=index)
    return session


# --------------------------------------------------------------------------
# project lifecycle + session persistence
# --------------------------------------------------------------------------

def new_project(payload: dict, output_root: str | None = None) -> dict:
    """Create a fresh project folder with the standard skeleton
    (``:648-673``)."""
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    layout = ProjectLayout(
        unique_folder(project_target(payload, output_root)))
    layout.ensure_base_folders()
    for filename in CONTEXT_FILENAMES:
        path = os.path.join(layout.context_folder, filename)
        if not os.path.exists(path):
            with open(path, "w", encoding="utf-8"):
                pass
    return layout.describe()


def _write_json(path: str, value) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    temp = path + ".tmp"
    with open(temp, "w", encoding="utf-8") as handle:
        json.dump(value, handle, indent=2, ensure_ascii=False)
        handle.write("\n")
    os.replace(temp, path)
    return path


def _read_json(path: str, default=None):
    try:
        with open(path, "r", encoding="utf-8-sig") as handle:
            return json.load(handle)
    except (OSError, ValueError):
        return default


def write_scene_notes(layout: ProjectLayout, segments) -> str:
    """``SceneNotes.json``: ``{"SceneNote<N>": timeline_note}``
    (``:8349-8359``)."""
    notes = {f"SceneNote{index}": str(seg.get("timeline_note", "") or "")
             for index, seg in enumerate(
                 (s for s in segments if isinstance(s, dict)), start=1)}
    return _write_json(layout.scene_notes_path, notes)


def read_scene_notes(layout: ProjectLayout) -> dict[int, str]:
    data = _read_json(layout.scene_notes_path, {})
    notes = {}
    if isinstance(data, dict):
        for raw_key, raw_value in data.items():
            match = re.search(r"(\d+)", str(raw_key or ""))
            if match:
                notes[int(match.group(1))] = str(raw_value or "").strip()
    return notes


def backup_session_file(layout: ProjectLayout) -> str:
    """Timestamped copy of the current session JSON before overwriting
    (``:1750-1764``)."""
    if not os.path.isfile(layout.session_path):
        return ""
    stamp = time.strftime("%Y%m%d_%H%M%S")
    target = unique_file(os.path.join(
        layout.session_backups_folder,
        f"vrgdg_builder_session_{stamp}.json"))
    shutil.copy2(layout.session_path, target)
    return target


def _guard_bulk_lyric_clear(layout: ProjectLayout, segments):
    """Restore lyric fields when an incoming save would blank at least
    half (and >=2) of the existing non-blank lyric lines — protection
    against a stale autosave wiping a transcription (``:8400-8444``).
    ``allow_bulk_lyric_clear`` on the session opts out."""
    existing = _read_json(layout.session_path, {})
    existing_segments = (existing.get("segments", [])
                         if isinstance(existing, dict) else [])
    by_id = {str(seg.get("id") or "").strip(): seg
             for seg in existing_segments
             if isinstance(seg, dict) and str(seg.get("id") or "").strip()}
    populated, erased = [], []
    for seg in segments:
        if not isinstance(seg, dict):
            continue
        prior = by_id.get(str(seg.get("id") or "").strip())
        if not isinstance(prior, dict):
            continue
        if not str(prior.get("lyric_text") or "").strip():
            continue
        populated.append((seg, prior))
        if not str(seg.get("lyric_text") or "").strip():
            erased.append((seg, prior))
    if len(populated) >= 2 and len(erased) >= 2 \
            and len(erased) * 2 >= len(populated):
        lyric_fields = ("lyric_text", "lyric_no_lip_sync", "lyric_section",
                        "lyric_singers", "performance_mode",
                        "no_character_present")
        for seg, prior in erased:
            for key in lyric_fields:
                if key in prior:
                    seg[key] = prior[key]
        return len(erased), len(populated)
    return 0, len(populated)


def _persist_session(layout: ProjectLayout, session: dict,
                     audio_path: str, segments) -> dict:
    """Common tail of save_session/save_project_as: finalize the session
    dict, write session + SRT + notes + prompt exports."""
    session = {**session, "audio_path": audio_path,
               "project_folder": layout.root, "updated": time.time(),
               "segments": segments}
    _write_json(layout.session_path, session)
    with open(layout.srt_path, "w", encoding="utf-8") as handle:
        handle.write(segments_to_srt(segments))
    scene_notes_path = write_scene_notes(layout, segments)

    # flat prompt text exports ordered by timeline position (:8477-8487)
    ordered = sorted(
        (seg for _n, seg in iter_scene_entries(session)),
        key=lambda seg: float(seg.get("start", 0) or 0))
    for key, filename in (("t2i_prompt", "t2i_prompts.txt"),
                          ("i2v_prompt", "i2v_prompts.txt")):
        lines = [str(seg.get(key, "")).strip() for seg in ordered
                 if str(seg.get(key, "")).strip()]
        os.makedirs(layout.prompts_folder, exist_ok=True)
        with open(os.path.join(layout.prompts_folder, filename), "w",
                  encoding="utf-8") as handle:
            handle.write("\n\n".join(lines).strip()
                         + ("\n" if lines else ""))
    result = layout.describe()
    result["scene_notes_path"] = scene_notes_path
    result["session"] = session
    return result


def save_session(payload: dict, output_root: str | None = None) -> dict:
    """Persist the working session (``:8380-8498``): snapshot external
    assets, guard against bulk lyric clearing, back up the previous
    session file, write session/SRT/notes/prompts + model defaults."""
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    audio_raw = _clean(payload.get("audio_path"))
    audio_path = require_file(audio_raw, "Audio file") if audio_raw else ""
    folder = _clean(payload.get("project_folder"))
    if not folder:
        if audio_path:
            stem = os.path.splitext(os.path.basename(audio_path))[0]
            name = safe_component(payload.get("project_name")
                                  or f"{stem}_builder")
            folder = os.path.join(os.path.dirname(audio_path), name)
        else:
            name = (payload.get("project_name")
                    or f"VRGDG_Project_{time.strftime('%Y%m%d_%H%M%S')}")
            folder = os.path.join(output_root, safe_component(name))
    layout = ProjectLayout(os.path.abspath(folder))
    layout.ensure_base_folders()

    session = (payload.get("session")
               if isinstance(payload.get("session"), dict) else {})
    segments, _overlays = _session_lists(session)
    with project_write_lock(layout.root):
        restored = 0
        if not bool(session.get("allow_bulk_lyric_clear")) \
                and os.path.isfile(layout.session_path):
            restored, _total = _guard_bulk_lyric_clear(layout, segments)
        # plain saves only snapshot the audio + context text files; the
        # scene-media ingest belongs to save-as/export (:8380-8498 vs
        # :8501-8553) — running it per save would duplicate every
        # history image into a fresh preview file on each autosave
        audio_path, session = snapshot_context_assets(layout, session,
                                                      audio_path)
        backup_session_file(layout)
        result = _persist_session(layout, session, audio_path, segments)
    result["model_defaults_path"] = save_model_defaults(session,
                                                        output_root)
    if restored:
        result["restored_lyric_lines"] = restored
    return result


def save_project_as(payload: dict, output_root: str | None = None) -> dict:
    """Copy the working session into a brand-new project folder
    (``:674-739``)."""
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    source = _clean(payload.get("source_project_folder")) or _clean(
        payload.get("project_folder"))
    source = os.path.abspath(source) if source else ""
    target = unique_folder(project_target(payload, output_root,
                                          "target_project_folder"))
    if source and os.path.isdir(source) and _inside(source, target):
        raise ValueError(
            "Save Project As target cannot be inside the current project "
            "folder.")
    layout = ProjectLayout(target)
    layout.ensure_base_folders()
    if source and os.path.isdir(source):
        for name in ("Browser AI References", "Browser AI Images"):
            browser_source = os.path.join(source, name)
            if os.path.isdir(browser_source):
                shutil.copytree(browser_source,
                                os.path.join(target, name),
                                dirs_exist_ok=True)

    session = (payload.get("session")
               if isinstance(payload.get("session"), dict) else {})
    segments, _overlays = _session_lists(session)
    audio_raw = _clean(payload.get("audio_path"))
    audio_path = require_file(audio_raw, "Audio file") if audio_raw else ""
    audio_path, session = snapshot_context_assets(layout, session,
                                                  audio_path, source)
    session = ingest_session_assets(layout, session)
    session = rebase_session_paths(layout, source, session)
    # rebase_session_paths builds a new tree; re-read the segment lists
    # from it so the persisted segments carry the rebased paths
    segments, _overlays = _session_lists(session)
    return _persist_session(layout, session, audio_path, segments)


def load_session(project_folder) -> dict:
    """Load + rehydrate a saved session (``:9397-9424``)."""
    layout = layout_for(project_folder)
    if not os.path.isfile(layout.session_path):
        raise FileNotFoundError(
            f"Builder session was not found: {layout.session_path}")
    session = _read_json(layout.session_path)
    if not isinstance(session, dict):
        raise ValueError("Builder session is not a JSON object.")
    session = rehydrate_session(layout, session)
    notes = read_scene_notes(layout)
    for index, seg in enumerate(session.get("segments", []), start=1):
        if (isinstance(seg, dict) and notes.get(index)
                and not str(seg.get("timeline_note", "") or "").strip()):
            seg["timeline_note"] = notes[index]
    return {"project_folder": layout.root,
            "session_path": layout.session_path,
            "srt_path": layout.srt_path,
            "scene_notes_path": layout.scene_notes_path,
            "session": session}


def list_projects(output_root: str | None = None,
                  project_root: str = "") -> dict:
    """Every folder holding a builder session under the output root and
    an optional extra absolute root (``:9426-9474``)."""
    output_root = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
    roots = [output_root]
    custom = _clean(project_root)
    if custom and os.path.isabs(custom):
        custom = os.path.abspath(custom)
        if os.path.normcase(custom) != os.path.normcase(output_root):
            roots.append(custom)
    projects, seen = [], set()
    for root in roots:
        if not os.path.isdir(root):
            continue
        for name in sorted(os.listdir(root)):
            folder = os.path.abspath(os.path.join(root, name))
            key = os.path.normcase(folder)
            if key in seen or not os.path.isdir(folder):
                continue
            layout = ProjectLayout(folder)
            if not os.path.isfile(layout.session_path):
                continue
            seen.add(key)
            session = _read_json(layout.session_path, {})
            segments = (session.get("segments", [])
                        if isinstance(session, dict) else [])
            try:
                mtime = os.path.getmtime(layout.session_path)
            except OSError:
                mtime = 0
            projects.append({
                "name": name,
                "project_folder": folder,
                "session_path": layout.session_path,
                "updated": mtime,
                "scene_count": (len(segments)
                                if isinstance(segments, list) else 0),
                "can_delete": _inside(output_root, folder),
            })
    projects.sort(key=lambda item: item.get("updated", 0), reverse=True)
    return {"projects": projects, "output_dir": output_root,
            "project_roots": roots}


def delete_project(payload: dict, output_root: str | None = None) -> dict:
    """Delete a project folder; only inside the output root, and only
    when it actually holds a builder session (``:9476-9493``)."""
    output_root = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
    layout = layout_for(payload)
    if not _inside(output_root, layout.root):
        raise ValueError("Project is outside the managed output folder, "
                         "so it was not deleted.")
    if not os.path.isdir(layout.root):
        return {"deleted": False, "project_folder": layout.root,
                "reason": "Project folder was already missing."}
    if not os.path.isfile(layout.session_path):
        raise ValueError(
            "This folder does not look like a Music Video Builder "
            "project.")
    shutil.rmtree(layout.root)
    return {"deleted": True, "project_folder": layout.root}


# --------------------------------------------------------------------------
# portable ZIP export / import
# --------------------------------------------------------------------------

PORTABLE_EXTENSIONS = frozenset(
    IMAGE_EXTENSIONS + (".gif", ".bmp") + VIDEO_EXTENSIONS
    + AUDIO_EXTENSIONS + (".srt", ".txt", ".json", ".csv"))
_STORED_EXTENSIONS = frozenset(
    VIDEO_EXTENSIONS + (".mp3", ".m4a", ".flac", ".ogg")
    + IMAGE_EXTENSIONS + (".gif", ".zip"))


def _localize_external_assets(layout: ProjectLayout, session: dict) -> dict:
    """Copy session-referenced files living OUTSIDE the project into
    ``portable_assets/`` so the export is self-contained (``:8519-8553``)."""
    copied: dict[str, str] = {}

    def visit(value, key_path):
        if isinstance(value, dict):
            return {key: visit(item, f"{key_path}_{key}")
                    for key, item in value.items()}
        if isinstance(value, list):
            return [visit(item, f"{key_path}_{index + 1}")
                    for index, item in enumerate(value)]
        if not isinstance(value, str):
            return value
        source = _clean(value)
        if not os.path.isabs(source) or not os.path.isfile(source):
            return value
        if _inside(layout.root, source):
            return os.path.abspath(source)
        if os.path.splitext(source)[1].lower() not in PORTABLE_EXTENSIONS:
            return value
        cache_key = os.path.normcase(os.path.abspath(source))
        if cache_key in copied:
            return copied[cache_key]
        safe_key = re.sub(r"[^A-Za-z0-9_.-]+", "_",
                          key_path).strip("._")[-80:] or "asset"
        safe_base = re.sub(r"[^A-Za-z0-9_.-]+", "_",
                           os.path.basename(source)).strip("._") or "file"
        destination = os.path.join(
            layout.portable_folder,
            f"{len(copied) + 1:04d}_{safe_key}_{safe_base}")
        target = copy_file_into(source, destination)
        if target:
            copied[cache_key] = target
            return target
        return value

    return visit(session, "session")


def export_project(project_folder) -> tuple[str, str]:
    """Package a project as a portable ZIP; returns ``(zip_path,
    download_name)`` — caller deletes the temp file (``:8501-8591``)."""
    import tempfile

    layout = layout_for(project_folder)
    if not os.path.isdir(layout.root) \
            or not os.path.isfile(layout.session_path):
        raise FileNotFoundError(
            "The Builder project or its session file was not found.")
    with project_write_lock(layout.root):
        session = _read_json(layout.session_path)
        if not isinstance(session, dict):
            raise ValueError("The Builder project session is invalid.")
        old_root = str(session.get("project_folder", "") or layout.root)
        session = ingest_session_assets(layout, session)
        session = _localize_external_assets(layout, session)
        session = rebase_session_paths(layout, old_root, session)
        session["project_folder"] = layout.root
        session["updated"] = time.time()
        _write_json(layout.session_path, session)

    project_name = safe_component(os.path.basename(layout.root))
    handle = tempfile.NamedTemporaryFile(prefix="vrgdg_builder_export_",
                                         suffix=".zip", delete=False)
    zip_path = handle.name
    handle.close()
    try:
        with zipfile.ZipFile(zip_path, "w",
                             compression=zipfile.ZIP_DEFLATED,
                             allowZip64=True) as archive:
            archive.writestr(PACKAGE_MANIFEST, json.dumps(
                {"format": "vrgdg_builder_project", "version": 1,
                 "project_name": project_name, "created": time.time()},
                indent=2))
            for root, folders, files in os.walk(layout.root):
                folders[:] = [name for name in folders
                              if name != "__pycache__"]
                for filename in files:
                    source = os.path.join(root, filename)
                    relative = os.path.relpath(
                        source, layout.root).replace(os.sep, "/")
                    stored = (os.path.splitext(filename)[1].lower()
                              in _STORED_EXTENSIONS)
                    archive.write(
                        source, relative,
                        compress_type=(zipfile.ZIP_STORED if stored
                                       else zipfile.ZIP_DEFLATED))
        return zip_path, f"{project_name}.vrgdg.zip"
    except Exception:
        try:
            os.remove(zip_path)
        except OSError:
            pass
        raise


def _checked_zip_members(archive: zipfile.ZipFile):
    """Validate archive members: no absolute/traversal paths, no
    symlinks, bounded size/ratio, session file present (``:8594-8613``)."""
    members = archive.infolist()
    if not members:
        raise ValueError("The selected ZIP file is empty.")
    total = 0
    for member in members:
        normalized = member.filename.replace("\\", "/")
        parts = [part for part in normalized.split("/")
                 if part not in ("", ".")]
        if normalized.startswith("/") \
                or re.match(r"^[A-Za-z]:", normalized) \
                or ".." in parts:
            raise ValueError(
                f"Unsafe path in project ZIP: {member.filename}")
        if (member.external_attr >> 16) & 0o170000 == 0o120000:
            raise ValueError("Symbolic links are not allowed in project "
                             f"ZIPs: {member.filename}")
        total += max(0, int(member.file_size or 0))
        if member.file_size > 1 << 30 and member.compress_size \
                and member.file_size > member.compress_size * 1000:
            raise ValueError("Suspicious compression ratio in project "
                             f"ZIP: {member.filename}")
    if total > 500 * (1 << 30):
        raise ValueError("The uncompressed project is larger than the "
                         "500 GB safety limit.")
    names = {member.filename.replace("\\", "/").strip("/")
             for member in members}
    if SESSION_FILENAME not in names:
        raise ValueError(
            "This ZIP is not a portable Video Builder project "
            f"({SESSION_FILENAME} is missing).")
    return members


def import_project(zip_path, requested_name: str = "",
                   output_root: str | None = None) -> dict:
    """Unpack a portable project ZIP into a fresh folder under the
    output root and rehydrate it (``:8616-8656``)."""
    output_root = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
    with zipfile.ZipFile(zip_path, "r") as archive:
        members = _checked_zip_members(archive)
        manifest = {}
        try:
            manifest = json.loads(
                archive.read(PACKAGE_MANIFEST).decode("utf-8"))
        except (KeyError, ValueError, UnicodeDecodeError):
            manifest = {}
        default_name = (manifest.get("project_name")
                        or os.path.basename(str(zip_path))
                        .replace(".vrgdg.zip", "").replace(".zip", ""))
        project_name = safe_component(requested_name or default_name)
        target = unique_folder(os.path.join(output_root, project_name))
        os.makedirs(target, exist_ok=False)
        try:
            target_real = os.path.realpath(target)
            for member in members:
                name = member.filename.replace("\\", "/").strip("/")
                if not name or name == PACKAGE_MANIFEST:
                    continue
                destination = os.path.realpath(
                    os.path.join(target, *name.split("/")))
                if not _inside(target_real, destination):
                    raise ValueError(
                        f"Unsafe path in project ZIP: {member.filename}")
                if member.is_dir():
                    os.makedirs(destination, exist_ok=True)
                    continue
                os.makedirs(os.path.dirname(destination), exist_ok=True)
                with archive.open(member, "r") as source, \
                        open(destination, "wb") as output:
                    shutil.copyfileobj(source, output, length=1 << 20)
            result = load_session(target)
            imported = result.get("session")
            if isinstance(imported, dict):
                imported["project_folder"] = target
                imported["updated"] = time.time()
                _write_json(ProjectLayout(target).session_path, imported)
            result["imported_project_name"] = project_name
            return result
        except Exception:
            shutil.rmtree(target, ignore_errors=True)
            raise


# --------------------------------------------------------------------------
# wizard drafts, render logs, model defaults
# --------------------------------------------------------------------------

def save_wizard_draft(payload: dict) -> dict:
    """Persist the wizard draft JSON + lyrics text + raw LLM outputs
    (``:8658-8698``)."""
    layout = layout_for(payload)
    os.makedirs(layout.wizard_folder, exist_ok=True)
    draft = (payload.get("draft")
             if isinstance(payload.get("draft"), dict) else {})
    lyrics = str(payload.get("lyrics", "") or draft.get("lyrics", "")
                 or "").replace("\r\n", "\n").replace("\r", "\n")
    draft = {**draft, "lyrics": lyrics, "updated": time.time()}
    draft_path = os.path.join(layout.wizard_folder, "wizard_draft.json")
    lyrics_path = os.path.join(layout.wizard_folder, "lyrics.txt")
    _write_json(draft_path, draft)
    with open(lyrics_path, "w", encoding="utf-8") as handle:
        handle.write(lyrics)
        if lyrics and not lyrics.endswith("\n"):
            handle.write("\n")
    raw_outputs = (payload.get("raw_outputs")
                   if isinstance(payload.get("raw_outputs"), dict) else {})
    for name, value in raw_outputs.items():
        safe = re.sub(r"[^a-zA-Z0-9_.-]+", "_",
                      _clean(name)).strip("._") or "raw_output"
        if not safe.endswith((".txt", ".json")):
            safe += ".txt"
        path = os.path.join(layout.wizard_folder, safe)
        if isinstance(value, (dict, list)):
            _write_json(path, value)
        else:
            with open(path, "w", encoding="utf-8") as handle:
                text = str(value or "")
                handle.write(text)
                if text and not text.endswith("\n"):
                    handle.write("\n")
    return {"wizard_folder": layout.wizard_folder,
            "wizard_draft_path": draft_path,
            "wizard_lyrics_path": lyrics_path, "draft": draft}


def load_wizard_draft(payload: dict) -> dict:
    layout = layout_for(payload)
    draft_path = os.path.join(layout.wizard_folder, "wizard_draft.json")
    lyrics_path = os.path.join(layout.wizard_folder, "lyrics.txt")
    draft = _read_json(draft_path)
    draft = draft if isinstance(draft, dict) else {}
    if os.path.isfile(lyrics_path) \
            and not str(draft.get("lyrics", "")).strip():
        with open(lyrics_path, "r", encoding="utf-8") as handle:
            draft["lyrics"] = handle.read()
    return {"wizard_folder": layout.wizard_folder,
            "wizard_draft_path": draft_path,
            "wizard_lyrics_path": lyrics_path, "draft": draft,
            "exists": bool(draft)}


def duration_label_ms(milliseconds) -> str:
    """``90500 -> '1m 31s'`` (``:757-768``)."""
    try:
        total = max(0, int(round(float(milliseconds or 0) / 1000.0)))
    except (TypeError, ValueError):
        total = 0
    hours, rest = divmod(total, 3600)
    minutes, seconds = divmod(rest, 60)
    if hours:
        return f"{hours}h {minutes:02d}m {seconds:02d}s"
    if minutes:
        return f"{minutes}m {seconds:02d}s"
    return f"{seconds}s"


def render_log_text(log) -> str:
    """Human-readable render report (``:771-821``)."""
    log = log if isinstance(log, dict) else {}
    summary = (log.get("summary")
               if isinstance(log.get("summary"), dict) else {})
    scenes = log.get("scenes") if isinstance(log.get("scenes"),
                                             list) else []
    completed = int(summary.get("completed_scenes", 0) or 0)
    target = int(summary.get("target_scenes", len(scenes)) or 0)
    lines = [
        "VRGDG Video Builder Render Log", "=" * 32,
        f"Session: {log.get('id', '')}",
        f"Status: {str(log.get('status') or 'unknown').upper()}",
        f"Project: {log.get('project_folder', '')}",
        f"Mode: {log.get('mode_label') or log.get('scene_scope') or 'Render All'}",
        f"Started: {log.get('started_at', '')}",
        f"Finished: {log.get('ended_at', '')}",
        "", "Summary", "-" * 32,
        "Total wall time: " + duration_label_ms(
            summary.get("total_ms", log.get("total_ms", 0))),
        "Active scene rendering: "
        + duration_label_ms(summary.get("render_ms", 0)),
        "Between-render time: "
        + duration_label_ms(summary.get("between_render_ms", 0)),
        "Setup time: " + duration_label_ms(summary.get("setup_ms", 0)),
        "Final stitching: "
        + duration_label_ms(summary.get("stitch_ms", 0)),
        "Other overhead: "
        + duration_label_ms(summary.get("overhead_ms", 0)),
        f"Scenes completed: {completed}/{target}",
        "Existing scenes skipped: "
        + str(int(summary.get("skipped_existing_scenes", 0) or 0)),
        "Average render per completed scene: "
        + duration_label_ms(summary.get("average_render_ms", 0)),
    ]
    if log.get("final_video_path"):
        lines.append(f"Final video: {log.get('final_video_path')}")
    if log.get("error"):
        lines += ["", f"Error: {log.get('error')}"]
    lines += ["", "Scene Details", "-" * 32]
    if not scenes:
        lines.append("No scene render timing has been recorded yet.")
    for scene in scenes:
        if not isinstance(scene, dict):
            continue
        label = (scene.get("label")
                 or f"Scene {scene.get('scene_number', '?')}")
        lines += [
            f"{label} [{str(scene.get('status') or 'pending').upper()}]",
            "  Total scene step: "
            + duration_label_ms(scene.get("total_ms", 0)),
            "  Preparation: "
            + duration_label_ms(scene.get("preparation_ms", 0)),
            "  Video render: "
            + duration_label_ms(scene.get("render_ms", 0)),
            "  Post-processing/cleanup: "
            + duration_label_ms(scene.get("post_ms", 0)),
            "  Time since previous render: "
            + duration_label_ms(scene.get("gap_before_render_ms", 0)),
        ]
        if scene.get("video_path"):
            lines.append(f"  Video: {scene.get('video_path')}")
        if scene.get("error"):
            lines.append(f"  Error: {scene.get('error')}")
    return "\n".join(lines).rstrip() + "\n"


def save_render_log(payload: dict) -> dict:
    """Write a render log as JSON + text report and fold it into the
    session's last-20 log list (``:823-877``)."""
    layout = layout_for(payload)
    os.makedirs(layout.root, exist_ok=True)
    log = payload.get("log") if isinstance(payload.get("log"),
                                           dict) else {}
    if not log:
        raise ValueError("Render log data is empty.")
    log_id = re.sub(r"[^A-Za-z0-9._-]+", "_",
                    _clean(log.get("id"))).strip("._")
    log_id = log_id or f"render_{time.strftime('%Y%m%d_%H%M%S')}"
    log = {**log, "id": log_id, "project_folder": layout.root}
    json_path = os.path.join(layout.render_logs_folder, f"{log_id}.json")
    text_path = os.path.join(layout.render_logs_folder, f"{log_id}.txt")
    log["report_json_path"] = json_path
    log["report_text_path"] = text_path
    _write_json(json_path, log)
    os.makedirs(layout.render_logs_folder, exist_ok=True)
    temp = text_path + ".tmp"
    with open(temp, "w", encoding="utf-8") as handle:
        handle.write(render_log_text(log))
    os.replace(temp, text_path)

    with project_write_lock(layout.root):
        session = _read_json(layout.session_path)
        if isinstance(session, dict):
            logs = (session.get("render_logs")
                    if isinstance(session.get("render_logs"), list)
                    else [])
            logs = [item for item in logs
                    if isinstance(item, dict)
                    and item.get("id") != log_id]
            logs.append(log)
            session["render_logs"] = logs[-20:]
            session["active_render_log_id"] = (
                log_id if log.get("status") == "running" else "")
            session["updated"] = time.time()
            _write_json(layout.session_path, session)
    return {"log": log, "report_json_path": json_path,
            "report_text_path": text_path}


def _model_defaults_path(output_root: str) -> str:
    folder = os.path.join(os.path.abspath(output_root),
                          "VRGDG_Model_Defaults")
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, "model_defaults.json")


def _scrub_model_defaults(defaults) -> dict:
    """Strip project-specific image-to-image sources from saved defaults
    (``:8289-8302``)."""
    if not isinstance(defaults, dict):
        return {}
    cleaned = json.loads(json.dumps(defaults))
    for key in ("zimage_settings", "ernie_image_settings",
                "krea2_2pass_settings"):
        settings = cleaned.get(key)
        if isinstance(settings, dict):
            settings["use_image_to_image"] = False
            settings["image_to_image_path"] = ""
            settings["image_to_image_data"] = ""
            settings["image_to_image_name"] = ""
    return cleaned


def save_model_defaults(session, output_root: str | None = None) -> str:
    """Remember cross-project model settings from a session save
    (``:8305-8328``)."""
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    if not isinstance(session, dict):
        return ""
    defaults = {key: session[key] for key in MODEL_DEFAULT_KEYS
                if session.get(key) is not None}
    defaults = _scrub_model_defaults(defaults)
    if not defaults:
        return ""
    return _write_json(_model_defaults_path(output_root),
                       {"saved_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                        "defaults": defaults})


def load_model_defaults(output_root: str | None = None) -> dict:
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    target = _model_defaults_path(output_root)
    payload = _read_json(target)
    payload = payload if isinstance(payload, dict) else {}
    defaults = payload.get("defaults")
    return {"path": target,
            "defaults": _scrub_model_defaults(
                defaults if isinstance(defaults, dict) else {}),
            "saved_at": str(payload.get("saved_at", "") or "")}


# --------------------------------------------------------------------------
# scene media
# --------------------------------------------------------------------------

def _incoming_image_target(payload: dict, layout: ProjectLayout,
                           scene: int, archive: bool) -> str:
    """Write the payload's image (data URL or source path) to either the
    approved slot or a new preview path; returns the saved path."""
    image_data = _clean(payload.get("image_data"))
    if image_data:
        target = (layout.new_preview_path(scene, ".png") if archive
                  else layout.scene_image_path(scene, ".png"))
        return save_data_url_image(image_data, target)
    source = require_file(payload.get("source_path"), "Image file")
    ext = os.path.splitext(source)[1] or ".png"
    target = (layout.new_preview_path(scene, ext) if archive
              else layout.scene_image_path(scene, ext))
    os.makedirs(os.path.dirname(target), exist_ok=True)
    shutil.copy2(source, target)
    return target


def save_scene_image(payload: dict) -> dict:
    """Store a scene's approved image at the canonical slot
    (``:8724-8751``)."""
    layout = layout_for(payload)
    os.makedirs(layout.images_folder, exist_ok=True)
    scene = int(payload.get("scene_number") or 1)
    saved = _incoming_image_target(payload, layout, scene, archive=False)
    return {"saved_path": saved, "images_folder": layout.images_folder,
            "scene_number": scene}


def archive_scene_image(payload: dict) -> dict:
    """Store an image into the scene's preview history (``:8772-8798``)."""
    layout = layout_for(payload)
    scene = int(payload.get("scene_number") or 1)
    saved = _incoming_image_target(payload, layout, scene, archive=True)
    return {"saved_path": saved,
            "preview_folder": layout.preview_folder(scene),
            "scene_number": scene}


def delete_media(payload: dict) -> dict:
    """Delete one media file, only inside the project (``:8753-8770``)."""
    layout = layout_for(payload)
    media_path = os.path.abspath(_clean(payload.get("path")))
    if not media_path:
        raise ValueError("Media path is empty.")
    if not os.path.isfile(media_path):
        return {"deleted": False, "path": media_path,
                "reason": "File was already missing."}
    if not _inside(layout.root, media_path):
        raise ValueError("This file is outside the current project "
                         "folder, so it was not deleted.")
    os.remove(media_path)
    return {"deleted": True, "path": media_path}


def extract_final_frame(payload: dict) -> dict:
    """Grab the last frame of a project video into the scene's preview
    history (``:8800-8848``). cv2 seek-to-last with an ffmpeg ``-sseof``
    fallback for containers cv2 mis-seeks."""
    layout = layout_for(payload)
    source = require_file(payload.get("source_path"), "Source video")
    if not _inside(layout.root, source):
        raise ValueError(
            "Source video must be inside the current project folder.")
    scene = int(payload.get("scene_number")
                or payload.get("target_scene_number") or 1)
    target = layout.new_preview_path(scene, ".png")

    frame = None
    capture = cv2.VideoCapture(source)
    try:
        if capture.isOpened():
            total = int(capture.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            for back in (1, 3, 12):
                if total > back:
                    capture.set(cv2.CAP_PROP_POS_FRAMES, total - back)
                okay, candidate = capture.read()
                if okay and candidate is not None:
                    frame = candidate
                    # read forward to the true last decodable frame
                    while True:
                        okay, candidate = capture.read()
                        if not okay or candidate is None:
                            break
                        frame = candidate
                    break
    finally:
        capture.release()
    if frame is not None and cv2.imwrite(target, frame):
        return {"saved_path": target,
                "preview_folder": layout.preview_folder(scene),
                "scene_number": scene, "source_path": source}

    from ..runtime.video_io import find_ffmpeg
    import subprocess

    ffmpeg = find_ffmpeg()
    if ffmpeg:
        for offset in ("-0.04", "-0.12", "-0.5"):
            result = subprocess.run(
                [ffmpeg, "-y", "-sseof", offset, "-i", source,
                 "-frames:v", "1", "-update", "1", target],
                capture_output=True, text=True, errors="replace",
                check=False)
            if result.returncode == 0 and os.path.isfile(target) \
                    and os.path.getsize(target) > 0:
                return {"saved_path": target,
                        "preview_folder": layout.preview_folder(scene),
                        "scene_number": scene, "source_path": source}
    raise RuntimeError("Could not extract a final frame from: "
                       + source)


def save_reference_image(payload: dict) -> dict:
    """Store a flux subject/location/ingredients-sheet reference image
    under ``project_context/flux_references`` (``:8851-8887``)."""
    layout = layout_for(payload)
    kind = _clean(payload.get("reference_type")).lower()
    if kind not in ("subject", "location", "ingredients_sheet"):
        kind = "location"
    safe_name = safe_component(_clean(payload.get("name")) or kind)
    folder_name = ("ingredients_sheets" if kind == "ingredients_sheet"
                   else f"{kind}s")
    target_dir = os.path.join(layout.context_folder, "flux_references",
                              folder_name)
    image_data = _clean(payload.get("image_data"))
    if image_data:
        target = unique_file(os.path.join(target_dir,
                                          f"{safe_name}.png"))
        save_data_url_image(image_data, target)
    else:
        source = require_file(payload.get("source_path"),
                              "Reference image")
        ext = os.path.splitext(source)[1] or ".png"
        target = unique_file(os.path.join(target_dir,
                                          f"{safe_name}{ext}"))
        shutil.copy2(source, target)
    return {"saved_path": target, "reference_type": kind,
            "folder": target_dir}


def import_reference_cards(payload: dict, kind: str) -> dict:
    """Scan ``subject_location/<kind>`` for image+description card pairs
    (``:8913-9011``; the reference has twin subject/location functions —
    here one parameterized scanner)."""
    layout = layout_for(payload)
    if not os.path.isdir(layout.root):
        raise ValueError("Create or load a project first so the "
                         f"{kind} folder can be found.")
    base_dir = os.path.join(layout.root, "subject_location")
    folder = os.path.join(base_dir, kind)
    if kind == "location" and not os.path.isdir(folder):
        typo = os.path.join(base_dir, "locaton")  # reference-era typo dirs
        if os.path.isdir(typo):
            folder = typo
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"{kind.capitalize()} folder does not exist:\n"
            f"{os.path.join(base_dir, kind)}")
    prefix = "subj" if kind == "subject" else "loc"
    cards, missing = [], []
    for filename in sorted(os.listdir(folder), key=str.lower):
        path = os.path.join(folder, filename)
        stem, ext = os.path.splitext(filename)
        if not os.path.isfile(path) \
                or ext.lower() not in IMAGE_EXTENSIONS + (".bmp",):
            continue
        text_path = os.path.join(folder, f"{stem}.txt")
        description = ""
        if os.path.isfile(text_path):
            with open(text_path, "r", encoding="utf-8",
                      errors="ignore") as handle:
                description = handle.read().strip()
        else:
            missing.append(f"{stem}.txt")
        safe_id = re.sub(r"[^a-zA-Z0-9_]+", "_", stem).strip("_") \
            or f"{kind}_{len(cards) + 1}"
        cards.append({
            "id": f"{prefix}_import_{len(cards) + 1}_{safe_id}",
            "name": stem,
            "description": description,
            "image": {"path": path,
                      "data": image_preview_data_url(path),
                      "name": filename},
        })
    if not cards:
        raise ValueError(
            f"No {kind} images were found in:\n{folder}")
    key = "subjects" if kind == "subject" else "locations"
    return {"folder": folder, key: cards,
            "missing_descriptions": missing}


# --------------------------------------------------------------------------
# audio: save / trim / mix / analyze
# --------------------------------------------------------------------------

def _peaks(path, target_peaks=600) -> dict:
    from ..runtime.audio import read_audio_peaks

    return read_audio_peaks(path, int(target_peaks))


def estimate_beats(audio_path, peaks, duration,
                   include_tempo: bool = False):
    """Musical beat grid for the waveform strip (``:2900-2945``): the
    native DP beat tracker (:mod:`vrgdg_tpu_torch.runtime.beats`, standing in
    for the reference's librosa path), falling back to RMS peak picking
    when decode fails."""
    try:
        from ..runtime import audio_toolkit as at
        from ..runtime import beats as beats_mod

        wave_ct, rate = at.decode_audio_file(audio_path)
        mono = wave_ct.mean(axis=0)
        if mono.size < 2:
            raise ValueError("Audio contains no samples.")
        bpm, times = beats_mod.track_beats(mono, rate)
        maximum = max(0.0, float(duration or mono.size / float(rate)))
        result = []
        for value in np.asarray(times, float):
            beat = round(float(value), 3)
            if beat < 0 or (maximum > 0 and beat > maximum + 0.001):
                continue
            if not result or beat > result[-1]:
                result.append(beat)
        if result:
            bpm = (round(float(bpm), 6)
                   if np.isfinite(bpm) and bpm > 0 else 0.0)
            bpm = bpm or tempo_from_beats(result)
            return (result, bpm) if include_tempo else result
    except Exception:
        pass
    result = beats_from_peaks(peaks, duration)
    bpm = tempo_from_beats(result)
    return (result, bpm) if include_tempo else result


def beats_from_peaks(peaks, duration) -> list[float]:
    """Threshold+local-max beat fallback over the RMS peak strip
    (``:2836-2871``): mean + 0.65 sigma threshold, minimum gap
    ``max(0.22, min(0.55, duration/500))``, strongest-in-window wins."""
    values = np.asarray([float(v or 0) for v in peaks or []], float)
    total = float(duration or 0)
    if values.size < 8 or total <= 0:
        return []
    step = total / values.size
    threshold = values.mean() + values.std() * 0.65
    min_gap = max(0.22, min(0.55, total / 500))
    inner = values[1:-1]
    local_max = ((inner >= threshold) & (inner >= values[:-2])
                 & (inner >= values[2:]))
    beats: list[float] = []
    strengths: list[float] = []
    last_time = -999.0
    for index in np.nonzero(local_max)[0] + 1:
        value = float(values[index])
        beat_time = index * step
        if beat_time - last_time < min_gap:
            if beats and value > strengths[-1]:
                beats[-1] = round(beat_time, 3)
                strengths[-1] = value
                last_time = beat_time
            continue
        beats.append(round(beat_time, 3))
        strengths.append(value)
        last_time = beat_time
    return beats


def tempo_from_beats(beats) -> float:
    """Median inter-beat interval -> BPM (``:2885-2897``)."""
    values = sorted(float(v) for v in beats or []
                    if np.isfinite(float(v)))
    intervals = sorted(b - a for a, b in zip(values, values[1:])
                       if b - a > 0.05)
    if not intervals:
        return 0.0
    middle = len(intervals) // 2
    median = (intervals[middle] if len(intervals) % 2
              else (intervals[middle - 1] + intervals[middle]) / 2.0)
    return round(60.0 / median, 6) if median > 0 else 0.0


def analyze_audio(payload: dict, output_root: str | None = None) -> dict:
    """Waveform peaks + beat grid for the timeline strip (route
    ``analyze_audio``, ``:9793-9813``); ``.m4a`` sources are converted
    into the project first when one is active."""
    audio_path = require_file(payload.get("audio_path"), "Audio file")
    project_folder = _clean(payload.get("project_folder"))
    if os.path.splitext(audio_path)[1].lower() == ".m4a" \
            and project_folder:
        layout = layout_for(project_folder)
        audio_path = convert_audio_to_wav(
            audio_path, os.path.join(layout.project_audio_folder,
                                     "project_audio.wav"))
    result = _peaks(audio_path, payload.get("target_peaks", 1600))
    result["beats"], result["tempo_bpm"] = estimate_beats(
        audio_path, result.get("peaks", []),
        result.get("duration", 0), include_tempo=True)
    return {"audio_path": audio_path, **result}


def save_scene_audio(payload: dict) -> dict:
    """Store one scene's custom audio clip (``:9013-9039``)."""
    layout = layout_for(payload)
    scene = int(payload.get("scene_number") or 1)
    os.makedirs(layout.scene_audio_folder, exist_ok=True)
    source_ext = os.path.splitext(
        _clean(payload.get("audio_name")))[1].lower()
    audio_data = _clean(payload.get("audio_data"))
    if audio_data:
        target = layout.scene_audio_path(scene, source_ext or ".wav")
        with open(target, "wb") as handle:
            handle.write(data_url_bytes(audio_data))
    else:
        source = require_file(payload.get("source_path"), "Audio file")
        target = layout.scene_audio_path(
            scene, os.path.splitext(source)[1] or ".wav")
        shutil.copy2(source, target)
    return {"saved_path": target,
            "audio_folder": layout.scene_audio_folder,
            "scene_number": scene, **_peaks(target, 600)}


def save_project_audio(payload: dict) -> dict:
    """Store the project's master audio; ``.m4a`` converts to WAV
    (``:9041-9079``)."""
    layout = layout_for(payload)
    folder = layout.project_audio_folder
    os.makedirs(folder, exist_ok=True)
    name = _clean(payload.get("audio_name")) or "project_audio.wav"
    ext = os.path.splitext(name)[1].lower()
    if ext not in AUDIO_EXTENSIONS:
        ext = ".wav"
    needs_convert = ext == ".m4a"
    target = os.path.join(
        folder, f"project_audio{'.wav' if needs_convert else ext}")
    raw_target = (os.path.join(folder, f"project_audio_source{ext}")
                  if needs_convert else target)
    audio_data = _clean(payload.get("audio_data"))
    if audio_data:
        with open(raw_target, "wb") as handle:
            handle.write(data_url_bytes(audio_data))
    else:
        source = require_file(payload.get("source_path"), "Audio file")
        shutil.copy2(source, raw_target)
    if needs_convert:
        target = convert_audio_to_wav(raw_target, target)
        if os.path.abspath(raw_target) != os.path.abspath(target):
            try:
                os.remove(raw_target)
            except OSError:
                pass
    info = _peaks(target, 1600)
    beats, tempo_bpm = estimate_beats(target, info.get("peaks", []),
                                      info.get("duration", 0),
                                      include_tempo=True)
    return {"saved_path": target, "audio_folder": folder, **info,
            "beats": beats, "tempo_bpm": tempo_bpm}


def _decoded_stereo_44k(path, cache: dict) -> np.ndarray:
    """``(2, T) float32 @ 44100`` with per-call caching by path."""
    from ..runtime import audio_toolkit as at

    key = os.path.normcase(os.path.abspath(path))
    if key not in cache:
        wave_ct, rate = at.decode_audio_file(path)
        wave_ct = at.resample_waveform(wave_ct, rate, 44100)
        if wave_ct.shape[0] == 1:
            wave_ct = np.repeat(wave_ct, 2, axis=0)
        cache[key] = np.ascontiguousarray(wave_ct[:2], np.float32)
    return cache[key]


def trim_scene_audio(payload: dict) -> dict:
    """Cut ``[start, start+duration]`` of a scene's audio to a 44.1 kHz
    stereo WAV (``:9119-9172``). Native decode/slice/write — the
    reference shells out to ffmpeg; behavior (duration clamping, empty-
    trim errors) is kept."""
    layout = layout_for(payload)
    source = require_file(payload.get("source_path"), "Audio file")
    scene = int(payload.get("scene_number") or 1)
    start = max(0.0, float(payload.get("start") or 0))
    duration = max(0.05, float(payload.get("duration") or 0))
    cache: dict = {}
    wave_ct = _decoded_stereo_44k(source, cache)
    source_duration = wave_ct.shape[1] / 44100.0
    if source_duration > 0:
        remaining = source_duration - start
        if remaining <= 0.01:
            raise ValueError(
                f"Scene {scene} audio trim starts after the source audio "
                f"ends. Trim start: {start:.3f}s; audio length: "
                f"{source_duration:.3f}s. Shorten or move the scene, "
                "load longer audio, or add silence before rendering.")
        duration = min(duration, max(0.05, remaining))
    first = int(round(start * 44100))
    last = min(wave_ct.shape[1], first + int(round(duration * 44100)))
    clip = wave_ct[:, first:last]
    trimmed_duration = clip.shape[1] / 44100.0
    if trimmed_duration <= 0.01:
        raise ValueError(
            f"Scene {scene} audio trim was empty. Trim start: "
            f"{start:.3f}s; requested duration: "
            f"{float(payload.get('duration') or 0):.3f}s. Shorten or "
            "move the scene, load longer audio, or add silence before "
            "rendering.")
    from ..runtime import audio_toolkit as at

    target = os.path.join(layout.trimmed_audio_folder,
                          f"scene_audio_{scene:04d}.wav")
    os.makedirs(layout.trimmed_audio_folder, exist_ok=True)
    at.save_wav(target, at.make_audio(clip, 44100))
    return {"audio_path": target, "scene_number": scene, "start": start,
            "duration": trimmed_duration,
            "requested_duration": float(payload.get("duration") or 0),
            "format": "pcm_s16le_wav"}


def _mix_timeline_items(segments, global_audio_path: str,
                        allow_missing: bool) -> list[dict]:
    """Validated, ordered clip list for the scene audio mix
    (``:9222-9283``)."""
    items, missing = [], []
    for index, seg in enumerate(segments, start=1):
        if not isinstance(seg, dict):
            missing.append(f"Scene {index}: invalid scene data.")
            continue
        path = _clean(seg.get("custom_audio_path"))
        seg_start = max(0.0, float(seg.get("start", 0) or 0))
        seg_end = max(seg_start + 0.05,
                      float(seg.get("end", seg_start + 4)
                            or seg_start + 4))
        if not path:
            duration = max(0.05, seg_end - seg_start)
            if global_audio_path:
                items.append({"index": index, "path": global_audio_path,
                              "start": seg_start, "duration": duration,
                              "source_start": seg_start,
                              "silent": False})
            elif allow_missing:
                items.append({"index": index, "path": "",
                              "start": seg_start, "duration": duration,
                              "source_start": 0.0, "silent": True})
            else:
                missing.append(f"Scene {index}: custom audio is missing.")
            continue
        path = os.path.abspath(path)
        if not os.path.isfile(path):
            missing.append(
                f"Scene {index}: custom audio file was not found: {path}")
            continue
        start = max(0.0, float(seg.get("custom_audio_timeline_start",
                                       seg_start) or seg_start))
        duration = float(seg.get("custom_audio_duration", 0) or 0)
        if duration <= 0:
            duration = seg_end - seg_start
        items.append({"index": index, "path": path, "start": start,
                      "duration": max(0.05, duration),
                      "source_start": max(0.0, float(
                          seg.get("custom_audio_source_start", 0) or 0)),
                      "silent": False})
    if missing:
        raise ValueError("\n".join(missing))
    items.sort(key=lambda item: (item["start"], item["index"]))
    return items


def mix_scene_audio(payload: dict) -> dict:
    """Assemble per-scene audio clips into one project track
    (``:9200-9395``).

    Cursor semantics match the reference's concat pipeline: clips are
    laid end-to-end ordered by timeline start, a silence part fills any
    gap to the next clip's start, and a source that runs out early
    simply yields a shorter clip. The assembly is pure numpy (decode
    once per distinct source) instead of two ffmpeg runs per scene."""
    from ..runtime import audio_toolkit as at

    layout = layout_for(payload)
    segments = payload.get("segments", [])
    if not isinstance(segments, list) or not segments:
        raise ValueError("No scenes were provided for scene audio mix.")
    global_audio = os.path.abspath(_clean(
        payload.get("global_audio_path")))
    if not os.path.isfile(global_audio):
        global_audio = ""
    items = _mix_timeline_items(
        segments, global_audio,
        bool(payload.get("allow_missing_scene_audio", False)))

    cache: dict = {}
    parts: list[np.ndarray] = []
    cursor = 0.0
    for item in items:
        gap = max(0.0, item["start"] - cursor)
        if gap > 0.01:
            parts.append(np.zeros((2, int(round(gap * 44100))),
                                  np.float32))
        length = int(round(item["duration"] * 44100))
        if item["silent"]:
            parts.append(np.zeros((2, length), np.float32))
        else:
            source = _decoded_stereo_44k(item["path"], cache)
            first = int(round(item["source_start"] * 44100))
            parts.append(source[:, first:first + length])
        cursor = max(cursor, item["start"] + item["duration"])
    parts = [part for part in parts if part.shape[1] > 0]
    if not parts:
        raise ValueError("No scene audio parts were created.")
    mix = np.concatenate(parts, axis=1)
    os.makedirs(layout.project_audio_folder, exist_ok=True)
    mix_path = os.path.join(layout.project_audio_folder,
                            "scene_audio_mix.wav")
    at.save_wav(mix_path, at.make_audio(mix, 44100))

    with open(layout.srt_path, "w", encoding="utf-8") as handle:
        handle.write(segments_to_srt(segments))
    info = _peaks(mix_path, 1600)
    beats, tempo_bpm = estimate_beats(
        mix_path, info.get("peaks", []),
        info.get("duration", cursor), include_tempo=True)
    return {"audio_path": mix_path, "srt_path": layout.srt_path,
            "duration": info.get("duration", cursor),
            "peaks": info.get("peaks", []), "beats": beats,
            "tempo_bpm": tempo_bpm, "scene_count": len(items),
            "used_scene_audio": True}


def save_project_srt(payload: dict) -> dict:
    """Overwrite the project SRT and return re-parsed scenes
    (``:9081-9094``)."""
    layout = layout_for(payload)
    os.makedirs(layout.root, exist_ok=True)
    srt_text = str(payload.get("srt_text", "") or "")
    if not srt_text.strip():
        raise ValueError("SRT text is empty.")
    with open(layout.srt_path, "w", encoding="utf-8") as handle:
        handle.write(srt_text)
    return {"srt_path": layout.srt_path,
            "segments": parse_srt_segments(srt_text)}


def save_scene_srt(payload: dict) -> dict:
    """One-scene SRT used by per-scene render flows (``:9096-9117``)."""
    layout = layout_for(payload)
    scene = int(payload.get("scene_number") or 1)
    duration = max(0.1, float(payload.get("duration") or 4))
    start = max(0.0, float(payload.get("start_time") or 0))
    label = str(payload.get("label")
                or f"Scene {scene}").strip() or f"Scene {scene}"
    os.makedirs(layout.scene_srt_folder, exist_ok=True)
    path = os.path.join(layout.scene_srt_folder,
                        f"scene_{scene:04d}.srt")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("\n".join([
            "1",
            f"{format_srt_time(start)} --> "
            f"{format_srt_time(start + duration)}",
            label, ""]))
    return {"srt_path": path, "scene_number": scene,
            "start_time": start, "duration": duration}


# --------------------------------------------------------------------------
# scene video scan / restore / thumbnails
# --------------------------------------------------------------------------

def _thumbnail_path(video_path) -> str:
    root, _ext = os.path.splitext(os.path.abspath(str(video_path or "")))
    return f"{root}.jpg"


def ensure_video_thumbnail(video_path) -> str:
    """480-wide JPEG next to the video (``:9499-9532``); cv2 grab of the
    frame nearest 0.5 s, empty string on failure."""
    video_path = os.path.abspath(_clean(video_path))
    if not os.path.isfile(video_path):
        return ""
    thumb = _thumbnail_path(video_path)
    if os.path.isfile(thumb):
        return thumb
    capture = cv2.VideoCapture(video_path)
    try:
        if not capture.isOpened():
            return ""
        capture.set(cv2.CAP_PROP_POS_MSEC, 500)
        okay, frame = capture.read()
        if not okay or frame is None:
            capture.set(cv2.CAP_PROP_POS_FRAMES, 0)
            okay, frame = capture.read()
        if not okay or frame is None:
            return ""
    finally:
        capture.release()
    height, width = frame.shape[:2]
    scale = 480.0 / max(1, width)
    target_h = max(2, int(round(height * scale / 2)) * 2)
    frame = cv2.resize(frame, (480, target_h),
                       interpolation=cv2.INTER_AREA)
    okay = cv2.imwrite(thumb, frame,
                       [int(cv2.IMWRITE_JPEG_QUALITY), 85])
    return thumb if okay else ""


def probe_video_duration(video_path) -> float:
    video_path = os.path.abspath(_clean(video_path))
    if not os.path.isfile(video_path):
        return 0.0
    from ..runtime.video_io import probe_video

    try:
        info = probe_video(video_path)
    except Exception:
        return 0.0
    fps = float(info.get("fps") or 0)
    frames = float(info.get("frame_count") or 0)
    return frames / fps if fps > 0 else 0.0


def restore_scene_video(payload: dict) -> dict:
    """Manually (re)attach a rendered video to a scene slot, backing up
    any existing one (``:9573-9631``)."""
    layout = layout_for(payload)
    source = os.path.abspath(_clean(payload.get("source_path")))
    if not os.path.isfile(source):
        raise FileNotFoundError(f"Video file was not found: {source}")
    if os.path.splitext(source)[1].lower() not in VIDEO_EXTENSIONS:
        raise ValueError("Choose a supported video file: .mp4, .mov, "
                         ".mkv, .webm, or .avi")
    scene = max(1, int(payload.get("scene_number") or 1))
    duration = probe_video_duration(source)
    expected = max(0.0, float(payload.get("expected_duration") or 0))
    tolerance = max(0.1, float(payload.get("duration_tolerance") or 0.5))
    delta = abs(duration - expected) if duration and expected else 0.0
    if delta > tolerance \
            and not bool(payload.get("confirm_duration_mismatch")):
        return {"needs_confirmation": True, "source_path": source,
                "scene_number": scene, "duration": duration,
                "expected_duration": expected, "duration_delta": delta,
                "duration_tolerance": tolerance}
    target = layout.scene_video_path(scene)
    thumb = _thumbnail_path(target)
    backup_path = backup_thumb = ""
    if os.path.isfile(target) and os.path.normcase(source) \
            != os.path.normcase(os.path.abspath(target)):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        backup_dir = os.path.join(layout.video_backup_root,
                                  f"scene_{scene:04d}")
        os.makedirs(backup_dir, exist_ok=True)
        backup_path = os.path.join(
            backup_dir,
            f"video_{scene:04d}-audio_manual_restore_{stamp}.mp4")
        shutil.move(target, backup_path)
        if os.path.isfile(thumb):
            backup_thumb = _thumbnail_path(backup_path)
            shutil.move(thumb, backup_thumb)
    copied = copy_file_into(source, target)
    if not copied:
        raise RuntimeError(
            "Could not copy the selected video into the project.")
    if os.path.isfile(thumb):
        try:
            os.remove(thumb)
        except OSError:
            pass
    return {"video_path": copied, "video_folder": layout.videos_folder,
            "thumbnail_path": ensure_video_thumbnail(copied),
            "scene_number": scene, "source_path": source,
            "duration": duration, "backup_path": backup_path,
            "backup_thumbnail_path": backup_thumb}


_SCRATCH_PREFIXES = ("image_to_video_clips", "text_to_video_clips",
                     "reference_to_video_clips",
                     "ingredients_to_video_clips")


def _scene_srt_history(layout: ProjectLayout) -> list[tuple[str, float]]:
    """(scene_key, mtime) of per-scene SRTs, oldest first — used to
    guess which scene a scratch render belonged to (``:9643-9661``)."""
    history = []
    if os.path.isdir(layout.scene_srt_folder):
        pattern = re.compile(r"^scene_(\d+)\.srt$", re.IGNORECASE)
        for name in os.listdir(layout.scene_srt_folder):
            match = pattern.match(name)
            path = os.path.join(layout.scene_srt_folder, name)
            if match and os.path.isfile(path):
                try:
                    history.append((str(int(match.group(1))),
                                    os.path.getmtime(path)))
                except OSError:
                    continue
    history.sort(key=lambda item: item[1])
    return history


def _scratch_candidates(layout: ProjectLayout, videos: dict,
                        srt_history) -> dict:
    """Best recoverable scratch render per scene key (``:9683-9737``)."""
    scene_folder_re = re.compile(r"scene[_-](\d+)", re.IGNORECASE)
    name_re = re.compile(r"^video_(\d+)(?:[-_].*)?\.mp4$", re.IGNORECASE)

    def infer_key(path, raw_key, modified):
        for part in reversed(os.path.abspath(path).split(os.sep)):
            match = scene_folder_re.search(part)
            if match:
                return str(int(match.group(1)))
        if raw_key != "1" and raw_key not in videos:
            return raw_key
        earlier = [(key, mtime) for key, mtime in srt_history
                   if mtime <= modified + 2.0 and key not in videos]
        if earlier:
            return max(earlier, key=lambda item: item[1])[0]
        return raw_key

    candidates: dict = {}
    for name in os.listdir(layout.root) if os.path.isdir(layout.root) \
            else []:
        scratch = os.path.join(layout.root, name)
        if not os.path.isdir(scratch):
            continue
        if not any(name == prefix or name.startswith(f"{prefix}_")
                   for prefix in _SCRATCH_PREFIXES):
            continue
        for root, _dirs, names in os.walk(scratch):
            if not _inside(layout.root, root):
                continue
            for file_name in names:
                match = name_re.match(file_name)
                if not match or not file_name.lower().endswith(".mp4"):
                    continue
                path = os.path.abspath(os.path.join(root, file_name))
                try:
                    size = os.path.getsize(path)
                    modified = os.path.getmtime(path)
                except OSError:
                    continue
                if size <= 0:
                    continue
                key = infer_key(path, str(int(match.group(1))), modified)
                score = 100 if file_name.lower().endswith("-audio.mp4") \
                    else (10 if "-audio" in file_name.lower() else 0)
                current = candidates.get(key)
                if not current or (score, modified) > current[:2]:
                    candidates[key] = (score, modified, path)
    return candidates


def scan_scene_videos(project_folder) -> dict:
    """Inventory rendered scene videos, recover strays from scratch
    render folders, and collect per-scene backups (``:9633-9791``)."""
    layout = layout_for(project_folder)
    os.makedirs(layout.videos_folder, exist_ok=True)
    videos, thumbnails = {}, {}
    recovered = {}
    pattern = re.compile(r"^video_(\d+)-audio\.mp4$", re.IGNORECASE)
    for name in os.listdir(layout.videos_folder):
        match = pattern.match(name)
        path = os.path.join(layout.videos_folder, name)
        if match and os.path.isfile(path):
            key = str(int(match.group(1)))
            videos[key] = path
            thumb = ensure_video_thumbnail(path)
            if thumb:
                thumbnails[key] = thumb

    srt_history = _scene_srt_history(layout)
    for key, (_score, _mtime, source) in _scratch_candidates(
            layout, videos, srt_history).items():
        if key in videos or not key.isdigit():
            continue
        target = layout.scene_video_path(int(key))
        try:
            copied = copy_file_into(source, target)
        except OSError:
            copied = ""
        if copied:
            videos[key] = copied
            recovered[key] = source
            thumb = ensure_video_thumbnail(copied)
            if thumb:
                thumbnails[key] = thumb

    backups: dict = {}
    backup_thumbs: dict = {}
    if os.path.isdir(layout.video_backup_root):
        backup_re = re.compile(r"^video_(\d+)-audio_.*\.mp4$",
                               re.IGNORECASE)
        for root, _dirs, names in os.walk(layout.video_backup_root):
            for name in names:
                match = backup_re.match(name)
                path = os.path.join(root, name)
                if not match or not os.path.isfile(path):
                    continue
                try:
                    modified = os.path.getmtime(path)
                except OSError:
                    modified = 0
                backups.setdefault(str(int(match.group(1))),
                                   []).append((path, modified))
        for key, pairs in backups.items():
            pairs.sort(key=lambda item: item[1], reverse=True)
            kept = pairs[:12]
            kept.reverse()
            backups[key] = [item[0] for item in kept]
            backup_thumbs[key] = [ensure_video_thumbnail(item[0])
                                  for item in kept]
    return {"project_folder": layout.root,
            "video_folder": layout.videos_folder, "videos": videos,
            "video_thumbnails": thumbnails, "video_backups": backups,
            "video_backup_thumbnails": backup_thumbs,
            "recovered_from_scratch": recovered}


# --------------------------------------------------------------------------
# prompt-creator import + default paths
# --------------------------------------------------------------------------

def _newest_file(folder, extensions) -> str:
    if not os.path.isdir(folder):
        return ""
    found = [os.path.join(folder, name) for name in os.listdir(folder)
             if name.lower().endswith(tuple(extensions))
             and os.path.isfile(os.path.join(folder, name))]
    return max(found, key=os.path.getmtime) if found else ""


def default_context_paths(output_root: str | None = None) -> dict:
    """Legacy shared text-file locations under the output root
    (``:192-209``)."""
    output_root = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)

    def path(folder, name):
        return os.path.join(output_root, "VRGDG_TEMP", "TextFiles",
                            folder, name)

    return {
        "concept_prompts_path": path("ConceptPrompts",
                                     "ConceptPrompts.txt"),
        "i2v_motion_notes_path": path("I2VMotionNotes",
                                      "I2VMotionNotes.txt"),
        "theme_style_path": path("themestyle", "themestyle.txt"),
        "story_idea_path": path("storyconcept", "storyconcept.txt"),
        "subject_scene_path": path("subjectandscenes",
                                   "subjectsandscenes.txt"),
    }


def prompt_creator_paths(project_folder) -> dict:
    """Where a project's Prompt Creator outputs live + readiness flags
    (``:212-233``)."""
    layout = layout_for(project_folder)
    context = layout.context_folder
    paths = {
        "project_folder": layout.root,
        "audio_path": _newest_file(os.path.join(layout.root, "audio"),
                                   AUDIO_EXTENSIONS + (".mp4",)),
        "srt_path": layout.srt_path,
        "lyric_segments_path": os.path.join(layout.prompts_folder,
                                            "lyric_segments.json"),
        "concept_prompts_path": os.path.join(context,
                                             "ConceptPrompts.txt"),
        "i2v_motion_notes_path": os.path.join(context,
                                              "I2VMotionNotes.txt"),
        "theme_style_path": os.path.join(context, "themestyle.txt"),
        "story_idea_path": os.path.join(context, "storyconcept.txt"),
        "subject_scene_path": os.path.join(context,
                                           "subjectsandscenes.txt"),
    }
    exists = {key: bool(value and os.path.isfile(value))
              for key, value in paths.items() if key.endswith("_path")}
    paths["exists"] = exists
    paths["ready"] = bool(exists.get("srt_path")
                          and exists.get("concept_prompts_path"))
    return paths


def _has_text_values(path) -> bool:
    """True when a JSON (or plain text) file carries any non-blank value
    (``:236-253``)."""
    if not path or not os.path.isfile(path):
        return False
    data = _read_json(path)
    if data is None:
        try:
            with open(path, "r", encoding="utf-8-sig") as handle:
                return bool(handle.read().strip())
        except OSError:
            return False
    if isinstance(data, dict):
        return any(str(value or "").strip() for value in data.values())
    if isinstance(data, list):
        return any(str(item or "").strip() for item in data)
    return bool(str(data or "").strip())


def _is_prompt_creator_output(context_folder) -> bool:
    marker = os.path.join(context_folder, "prompt_creator_output.json")
    if os.path.isfile(marker):
        data = _read_json(marker)
        if not isinstance(data, dict):
            return True  # unreadable marker still marks the folder
        if str(data.get("type", "") or "") \
                == "vrgdg_prompt_creator_output":
            return True
    project = os.path.dirname(context_folder)
    return any(os.path.isfile(path) for path in (
        os.path.join(project, "prompt_creator_draft.json"),
        os.path.join(project, "prompts", "lyric_segments.json"),
        os.path.join(context_folder, "full_lyrics.txt")))


def _pointer_source(output_root: str, exclude: str) -> tuple[str, str]:
    """Most recent Prompt Creator project per the pointer file
    (``:275-301``)."""
    data = _read_json(os.path.join(
        output_root, "VRGDG_LastPromptCreatorProject.json"))
    if not isinstance(data, dict) or str(data.get("type", "") or "") \
            != "vrgdg_last_prompt_creator_project":
        return "", ""
    project = os.path.abspath(_clean(data.get("project_folder")))
    if not project or not os.path.isdir(project):
        return "", ""
    if exclude and os.path.normcase(project) == exclude:
        return "", ""
    raw_context = _clean(data.get("context_folder"))
    context = (os.path.abspath(raw_context) if raw_context
               else ProjectLayout(project).context_folder)
    concept = os.path.join(context, "ConceptPrompts.txt")
    if not os.path.isfile(concept) \
            or not os.path.isfile(ProjectLayout(project).srt_path) \
            or not _has_text_values(concept):
        return "", ""
    return project, context


def latest_prompt_creator_source(output_root: str | None = None,
                                 exclude_project: str = ""
                                 ) -> tuple[str, str]:
    """Pointer file first, then newest valid ``project_context`` under
    the output root (``:303-341``)."""
    output_root = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
    exclude = (os.path.normcase(os.path.abspath(exclude_project))
               if exclude_project else "")
    project, context = _pointer_source(output_root, exclude)
    if project:
        return project, context
    candidates = []
    for root, _dirs, _files in os.walk(output_root):
        if os.path.basename(root) != "project_context":
            continue
        project = os.path.dirname(root)
        if exclude and os.path.normcase(os.path.abspath(project)) \
                == exclude:
            continue
        concept = os.path.join(root, "ConceptPrompts.txt")
        srt_path = ProjectLayout(project).srt_path
        if not os.path.isfile(concept) or not os.path.isfile(srt_path):
            continue
        if not _is_prompt_creator_output(root) \
                or not _has_text_values(concept):
            continue
        motion = os.path.join(root, "I2VMotionNotes.txt")
        related = [concept, srt_path, motion,
                   os.path.join(root, "themestyle.txt"),
                   os.path.join(root, "storyconcept.txt"),
                   os.path.join(root, "subjectsandscenes.txt")]
        newest = max((os.path.getmtime(path) for path in related
                      if os.path.isfile(path)), default=0)
        candidates.append((1 if _has_text_values(motion) else 0,
                           newest, project, root))
    if not candidates:
        raise ValueError(
            "No previous Prompt Creator output was found. Run Prompt "
            "Creator first, then import it into this project.")
    candidates.sort(reverse=True)
    return candidates[0][2], candidates[0][3]


def copy_prompt_creator_outputs(project_folder,
                                source_project: str = "",
                                output_root: str | None = None) -> dict:
    """Copy a Prompt Creator run's outputs into this project
    (``:343-384``)."""
    layout = layout_for(project_folder)
    layout.ensure_base_folders()
    audio_folder = os.path.join(layout.root, "audio")
    os.makedirs(audio_folder, exist_ok=True)
    if source_project:
        source = os.path.abspath(_clean(source_project))
        source_context = ProjectLayout(source).context_folder
        if os.path.normcase(source) == os.path.normcase(layout.root):
            return prompt_creator_paths(layout.root)
        if not os.path.isfile(os.path.join(source_context,
                                           "ConceptPrompts.txt")) \
                or not os.path.isfile(ProjectLayout(source).srt_path):
            raise ValueError(
                "The selected Prompt Creator project does not have "
                "saved ConceptPrompts.txt and builder_segments.srt "
                "outputs.")
    else:
        source, source_context = latest_prompt_creator_source(
            output_root, layout.root)
    copied = {}
    for filename in CONTEXT_FILENAMES + ("subject.txt",
                                         "full_lyrics.txt"):
        source_path = os.path.join(source_context, filename)
        if os.path.isfile(source_path):
            copied[filename] = copy_file_into(
                source_path, os.path.join(layout.context_folder,
                                          filename))
    source_lyrics = os.path.join(source, "prompts",
                                 "lyric_segments.json")
    if os.path.isfile(source_lyrics):
        copied["lyric_segments.json"] = copy_file_into(
            source_lyrics, os.path.join(layout.prompts_folder,
                                        "lyric_segments.json"))
    source_srt = ProjectLayout(source).srt_path
    if os.path.isfile(source_srt):
        copied[SRT_FILENAME] = copy_file_into(source_srt,
                                              layout.srt_path)
    source_audio = _newest_file(os.path.join(source, "audio"),
                                AUDIO_EXTENSIONS + (".mp4",))
    if source_audio:
        if os.path.splitext(source_audio)[1].lower() == ".m4a":
            copied["audio"] = convert_audio_to_wav(
                source_audio, os.path.join(audio_folder,
                                           "project_audio.wav"))
        else:
            copied["audio"] = copy_file_into(
                source_audio, os.path.join(
                    audio_folder, os.path.basename(source_audio)))
    result = prompt_creator_paths(layout.root)
    result["source_project_folder"] = source
    result["copied"] = copied
    return result


def default_audio_srt_paths(output_root: str | None = None,
                            srt_folders=()) -> dict:
    """Newest audio under ``VRGDG_AudioFiles`` + newest SRT in the given
    folders (``:399-410``)."""
    output_root = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
    audio_folder = os.path.join(output_root, "VRGDG_AudioFiles")
    srt_folders = list(srt_folders) or [
        os.path.join(output_root, "srt_files")]
    srt_path = ""
    for folder in srt_folders:
        srt_path = _newest_file(folder, (".srt",))
        if srt_path:
            break
    return {"audio_path": _newest_file(audio_folder, AUDIO_EXTENSIONS),
            "srt_path": srt_path, "audio_folder": audio_folder,
            "srt_folder": srt_folders[0]}


# --------------------------------------------------------------------------
# CapCut beat import
# --------------------------------------------------------------------------

def _capcut_dicts(field) -> list[dict]:
    """The dict entries of a possibly-absent CapCut list field."""
    return [item for item in (field or []) if isinstance(item, dict)]


def _capcut_nonneg_seconds(raw, divisor: float, *,
                           missing_is_zero: bool = False) -> float | None:
    """A CapCut time value scaled to seconds, 6-decimal rounded; None
    for malformed or negative input.  ``missing_is_zero`` maps a
    null/empty value to 0.0 instead — the timeline-marker path treats a
    missing ``time_range.start`` as t=0 while the AI-beat-cache path
    skips unparseable entries (``:2971-2996``)."""
    if missing_is_zero:
        raw = raw or 0
    try:
        seconds = float(raw) / divisor
    except (TypeError, ValueError):
        return None
    return round(seconds, 6) if seconds >= 0 else None


def _capcut_audio_binding(draft: dict, materials: dict) -> tuple[dict, set]:
    """The draft's primary audio binding: the material record behind the
    first segment on any audio track, plus the set of extra-material ids
    that segment references (markers/beats link through these)."""
    segment: dict = {}
    for track in _capcut_dicts(draft.get("tracks")):
        if str(track.get("type") or "").lower() != "audio":
            continue
        segments = _capcut_dicts(track.get("segments"))
        if segments:
            segment = segments[0]
            break
    wanted = str(segment.get("material_id") or "")
    # later duplicate ids shadow earlier ones, hence the reversed scan
    material = next(
        (item for item in reversed(_capcut_dicts(materials.get("audios")))
         if str(item.get("id") or "") and str(item.get("id")) == wanted),
        {})
    refs = {str(v) for v in (segment.get("extra_material_refs") or [])
            if str(v)}
    return material, refs


def _linked_first(items: list[dict], referenced: set) -> list[dict]:
    """Entries whose id the audio segment references, else all of them."""
    hits = [it for it in items if str(it.get("id") or "") in referenced]
    return hits or items


def extract_capcut_beats(draft, draft_path: str = "") -> dict | None:
    """Beat markers out of one CapCut draft JSON (``:2946-3025``):
    timeline markers when they pair one-for-one (within 1) with the AI
    beat cache, otherwise the raw cache times. The schema walk
    (materials -> audios / tracks -> extra_material_refs ->
    time_marks / beats -> ai_beats) is dictated by CapCut's draft
    format; behavior is locked by the oracle fuzz suite."""
    if not isinstance(draft, dict):
        return None
    materials = (draft.get("materials")
                 if isinstance(draft.get("materials"), dict) else {})
    audio_material, referenced = _capcut_audio_binding(draft, materials)

    marker_times = sorted({
        seconds
        for collection in _linked_first(
            _capcut_dicts(materials.get("time_marks")), referenced)
        for marker in _capcut_dicts(collection.get("mark_items"))
        for seconds in [_capcut_nonneg_seconds(
            (marker.get("time_range")
             if isinstance(marker.get("time_range"), dict)
             else {}).get("start"), 1e6, missing_is_zero=True)]
        if seconds is not None})

    beat_entries = _linked_first(_capcut_dicts(materials.get("beats")),
                                 referenced) or [{}]
    ai_beats = (beat_entries[0].get("ai_beats")
                if isinstance(beat_entries[0].get("ai_beats"), dict)
                else {})
    cache_path = os.path.normpath(_clean(ai_beats.get("beats_path")) or "")
    cache_times: list[float] = []
    beat_values: list = []
    if cache_path and os.path.isfile(cache_path):
        cache = _read_json(cache_path)
        if isinstance(cache, dict):
            cache_times = [
                s for raw in (cache.get("time") or [])
                for s in [_capcut_nonneg_seconds(raw, 1000.0)]
                if s is not None]
            beat_values = list(cache.get("value") or [])

    markers_match_cache = (not cache_times
                           or abs(len(marker_times) - len(cache_times)) <= 1)
    if marker_times and markers_match_cache:
        beats, source = marker_times, "timeline_markers"
    else:
        beats, source = sorted(set(cache_times)), "ai_beat_cache"
    if len(beats) < 2:
        return None
    return {
        "project_name": _clean(draft.get("name"))
        or os.path.basename(os.path.dirname(draft_path)),
        "draft_path": os.path.abspath(draft_path) if draft_path else "",
        "project_fps": float(draft.get("fps") or 0),
        "project_duration": float(draft.get("duration") or 0) / 1e6,
        "audio_name": _clean(audio_material.get("name")),
        "audio_path": _clean(audio_material.get("path")),
        "beat_cache_path": cache_path,
        "beat_source": source,
        "beats": beats,
        "raw_ai_beats": cache_times,
        "beat_values": beat_values,
    }


def capcut_index_path() -> str:
    local = os.environ.get("LOCALAPPDATA") or os.path.join(
        os.path.expanduser("~"), "AppData", "Local")
    return os.path.join(local, "CapCut", "User Data", "Projects",
                        "com.lveditor.draft", "root_meta_info.json")


def find_latest_capcut_beats(audio_duration=0,
                             index_path: str | None = None) -> dict:
    """Newest CapCut project whose duration matches the loaded audio
    (+-0.75 s) and that carries beat data (``:3028-3078``)."""
    index_path = index_path or capcut_index_path()
    if not os.path.isfile(index_path):
        raise FileNotFoundError(
            f"CapCut project index was not found: {index_path}")
    index_data = _read_json(index_path)
    entries = (index_data.get("all_draft_store", [])
               if isinstance(index_data, dict) else [])
    entries = sorted(
        (item for item in entries
         if isinstance(item, dict) and not item.get("tm_draft_removed")),
        key=lambda item: float(item.get("tm_draft_modified") or 0),
        reverse=True)
    requested = max(0.0, float(audio_duration or 0))
    first_with_beats = None
    for entry in entries[:150]:
        draft_path = os.path.normpath(
            _clean(entry.get("draft_json_file")) or "")
        if not draft_path or not os.path.isfile(draft_path):
            continue
        try:
            result = extract_capcut_beats(_read_json(draft_path),
                                          draft_path)
        except Exception:
            continue
        if not result:
            continue
        result["project_name"] = _clean(
            entry.get("draft_name")) or result.get("project_name", "")
        result["project_modified"] = float(
            entry.get("tm_draft_modified") or 0)
        first_with_beats = first_with_beats or result
        if requested <= 0 or abs(float(result.get("project_duration")
                                       or 0) - requested) <= 0.75:
            return result
    if first_with_beats and requested <= 0:
        return first_with_beats
    if first_with_beats:
        raise ValueError(
            "CapCut projects with beat data were found, but none "
            "matched the loaded audio duration within 0.75 seconds.")
    raise ValueError(
        "No CapCut project containing beat data was found.")
