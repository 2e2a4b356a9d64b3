"""Video editor session store + remake-clip queue.

A copy of :mod:`vrgdg_tpu.api.video_editor` (which cannot be imported
without JAX): every function keeps its original's source.

Framework-native re-derivation of the reference's timeline-editor
backend (``VRGDG_VideoEditorNodes.py``): clip listing
with staged-remake visibility, editor-session persistence that stages
selected clips into ``remake/``, captured-frame saving, the session
loader, and the remake queue that hands one pending clip (with its
frame-locked audio slice) to a re-render loop.

Parity targets:

- folder/extension/clip-number helpers: ``:104-176``,
- SRT parsing: ``:178-207`` (shared with
  :func:`vrgdg_tpu_torch.runtime.audio_toolkit.parse_srt`),
- clip listing incl. staged remakes: ``:230-303``,
- session load/save + remake staging + queue-state reset: ``:305-380``,
- captured-frame save: ``:382-412``,
- session loader node: ``:903-996``,
- remake queue: ``:997-1445`` — file staging (main -> remake ->
  backup), pending selection, and the 8N+1 frame-locked audio slice
  (the slice itself is :func:`audio_toolkit.split_audio_srt`'s math).

Deliberate departures: explicit roots instead of ComfyUI
``folder_paths``; the auto-queue does not push ComfyUI queue events —
:func:`next_remake` returns ``remaining_remakes`` so any driver loop
(CLI ``while``, HTTP poller) can keep calling until the queue drains;
images decode via cv2.

Excluded (LLM): the ``generate_visual_t2i`` / ``generate_i2v`` Gemma
routes (``:524-678``).
"""

from __future__ import annotations

import json
import os
import re
import time
from urllib.parse import quote

import numpy as np

from .builder import (_clean, _read_json, _write_json,
                      project_write_lock, save_data_url_image)
from .paths import DEFAULT_OUTPUT_ROOT, _inside

VIDEO_EXTENSIONS = (".mp4", ".mov", ".mkv", ".webm", ".avi", ".m4v")
SESSION_RELPATH = os.path.join("vrgdg_temp", "editor_session.json")
QUEUE_STATE_RELPATH = os.path.join("vrgdg_temp",
                                   "remake_clip_queue_state.json")
FRAMES_DIRNAME = "vrgdg_editor_frames"


def resolve_editor_folder(raw_path, roots=()) -> str:
    """Existing clips folder: absolute paths as-is, relative names tried
    against the given roots (``:104-129``)."""
    text = _clean(raw_path)
    if not text:
        raise ValueError("Output folder path is empty.")
    candidates = ([text] if os.path.isabs(text)
                  else [text] + [os.path.join(root, text)
                                 for root in (roots
                                              or (DEFAULT_OUTPUT_ROOT,))])
    for candidate in candidates:
        folder = os.path.normpath(os.path.abspath(candidate))
        if os.path.isdir(folder):
            return folder
    raise FileNotFoundError(f"Output folder was not found: {text}")


def parse_extensions(raw) -> tuple:
    values = []
    for item in re.split(r"[,;\s]+", str(raw or "")):
        ext = item.strip().lower()
        if ext:
            values.append(ext if ext.startswith(".") else f".{ext}")
    return tuple(values or VIDEO_EXTENSIONS)


def natural_key(text):
    return [int(part) if part.isdigit() else part.lower()
            for part in re.split(r"(\d+)", str(text or ""))]


def guess_clip_number(filename, fallback: int) -> int:
    match = re.match(r"video_(\d+)", str(filename or ""),
                     flags=re.IGNORECASE)
    if not match:
        match = re.search(r"(\d+)", str(filename or ""))
    return int(match.group(1)) if match else int(fallback)


def format_seconds(sec) -> str:
    sec = max(0.0, float(sec or 0.0))
    return f"{int(sec // 60)}:{sec % 60:06.3f}"


def session_path_for(folder) -> str:
    return os.path.join(folder, SESSION_RELPATH)


def _clip_entry(path, clip_number=0):
    stat = os.stat(path)
    name = os.path.basename(path)
    return {
        "name": name,
        "path": path,
        "size": int(stat.st_size),
        "mtime": float(stat.st_mtime),
        "clip_number": int(clip_number or 0),
        "url": ("/vrgdg/video_editor/video?path=" + quote(path)
                + f"&v={int(stat.st_mtime)}_{int(stat.st_size)}"),
    }


def list_clips(folder_path, extensions="", roots=()) -> dict:
    """Folder inventory plus any selected clips already staged into
    ``remake/`` (which a plain listdir would hide) (``:230-303``)."""
    folder = resolve_editor_folder(folder_path, roots)
    wanted = parse_extensions(extensions)

    def listable(path):
        lower = os.path.basename(path).lower()
        return (os.path.isfile(path) and lower.endswith(wanted)
                and not lower.startswith("final_video")
                and lower != "00001.mp4")

    clips = []
    for name in os.listdir(folder):
        path = os.path.join(folder, name)
        if not listable(path):
            continue
        try:
            clips.append(_clip_entry(path))
        except OSError:
            continue

    visible = {os.path.normcase(os.path.abspath(item["path"]))
               for item in clips}
    session = _read_json(session_path_for(folder), {})
    session_clips = (session.get("clips", {})
                     if isinstance(session, dict) else {})
    if isinstance(session_clips, dict):
        for item in session_clips.values():
            if not isinstance(item, dict) \
                    or not item.get("selected_for_remake"):
                continue
            raw = _clean(item.get("path"))
            basename = (os.path.basename(raw) if raw
                        else str(item.get("name", "") or "").strip())
            for candidate in filter(None, (
                    raw, os.path.join(folder, "remake", basename)
                    if basename else "")):
                candidate = os.path.abspath(candidate)
                key = os.path.normcase(candidate)
                if key in visible or not listable(candidate):
                    continue
                try:
                    clips.append(_clip_entry(
                        candidate, item.get("clip_number", 0)))
                except OSError:
                    continue
                visible.add(key)
                break

    clips.sort(key=lambda item: natural_key(item["name"]))
    for index, item in enumerate(clips, start=1):
        if not item.get("clip_number"):
            item["clip_number"] = guess_clip_number(item["name"], index)
    return {"folder_path": folder,
            "remake_folder": os.path.join(folder, "remake"),
            "session_path": session_path_for(folder),
            "clips": clips}


def load_session(folder_path, roots=()) -> dict:
    folder = resolve_editor_folder(folder_path, roots)
    path = session_path_for(folder)
    if not os.path.isfile(path):
        return {"project_folder": folder, "clips": {}, "updated": None}
    data = _read_json(path)
    if not isinstance(data, dict):
        raise ValueError("Editor session must be a JSON object.")
    return data


def stage_selected_remakes(folder, session) -> list[dict]:
    """Move every clip selected for remake out of the main folder into
    ``remake/`` so the re-render can overwrite the original slot
    (``:354-380``)."""
    clips = session.get("clips", {}) if isinstance(session, dict) else {}
    if not isinstance(clips, dict):
        return []
    selected = [item for item in clips.values()
                if isinstance(item, dict)
                and item.get("selected_for_remake")]
    remake_dir = os.path.join(folder, "remake")
    os.makedirs(remake_dir, exist_ok=True)
    staged = []
    for item in selected:
        raw = _clean(item.get("path"))
        basename = (os.path.basename(raw) if raw
                    else str(item.get("name", "") or "").strip())
        if not basename:
            continue
        main_path = os.path.join(folder, basename)
        remake_path = os.path.join(remake_dir, basename)
        if os.path.isfile(remake_path):
            item["path"] = remake_path
            staged.append({"name": basename, "from": "",
                           "to": remake_path, "already_staged": True})
        elif os.path.isfile(main_path):
            os.replace(main_path, remake_path)
            item["path"] = remake_path
            staged.append({"name": basename, "from": main_path,
                           "to": remake_path, "already_staged": False})
    return staged


def save_session(folder_path, session, roots=()) -> dict:
    """Persist the editor session; staging + queue-state reset happen as
    side effects exactly like the reference (``:317-352``)."""
    folder = resolve_editor_folder(folder_path, roots)
    if not isinstance(session, dict):
        raise ValueError("Session must be a JSON object.")
    payload = dict(session)
    with project_write_lock(folder):
        staged = stage_selected_remakes(folder, payload)
        payload.update(project_folder=folder, updated=time.time(),
                       staged_remakes=staged)
        try:
            os.remove(os.path.join(folder, QUEUE_STATE_RELPATH))
        except OSError:
            pass
        path = _write_json(session_path_for(folder), payload)
    return {"session_path": path, "session": payload,
            "staged_remakes": staged}


def save_frame(payload, roots=()) -> dict:
    """Write a captured player frame as PNG under
    ``vrgdg_editor_frames`` (``:382-412``)."""
    folder = resolve_editor_folder(payload.get("folder_path"), roots)
    stem = os.path.splitext(os.path.basename(
        _clean(payload.get("clip_name")) or "clip"))[0]
    stem = re.sub(r"[^A-Za-z0-9_.-]+", "_", stem).strip("._") or "clip"
    frame_time = max(0.0, float(payload.get("frame_time", 0.0) or 0.0))
    time_tag = f"{frame_time:09.3f}".replace(".", "_")
    target_dir = os.path.join(folder, FRAMES_DIRNAME)
    frame_path = os.path.join(target_dir,
                              f"{stem}_frame_{time_tag}.png")
    save_data_url_image(payload.get("image_data"), frame_path)
    return {"frame_path": frame_path, "frames_folder": target_dir,
            "filename": os.path.basename(frame_path)}


# --------------------------------------------------------------------------
# session loader
# --------------------------------------------------------------------------

def _session_clips(session_path) -> tuple[str, dict, dict]:
    path = _clean(session_path)
    if not path:
        raise ValueError("session_path is empty.")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"Editor session file was not found: {path}")
    data = _read_json(path)
    if not isinstance(data, dict):
        raise ValueError("Editor session must be a JSON object.")
    clips = data.get("clips", {})
    if not isinstance(clips, dict):
        raise ValueError(
            "Editor session JSON does not contain a valid clips object.")
    return path, data, clips


def load_clip(session_path, clip_number: int = 1,
              clip_path: str = "") -> dict:
    """One clip's editor state by exact path first, then clip number
    (``VRGDG_VideoEditorSessionLoader``, ``:903-996``)."""
    _path, _data, clips_obj = _session_clips(session_path)

    def norm(value):
        text = _clean(value)
        return os.path.normcase(os.path.normpath(
            os.path.abspath(text))) if text else ""

    found = None
    wanted_path = norm(clip_path)
    entries = [(key, item) for key, item in clips_obj.items()
               if isinstance(item, dict)]
    if wanted_path:
        found = next((item for key, item in entries
                      if norm(item.get("path") or key) == wanted_path),
                     None)
    if found is None:
        found = next(
            (item for _key, item in entries
             if int(item.get("clip_number", 0) or 0)
             == int(clip_number)), None)
    if found is None:
        return {"found": False, "t2i_prompt": "", "i2v_prompt": "",
                "captured_frame_path": "", "selected_for_remake": False,
                "clip_name": "", "clip_path": ""}
    return {"found": True,
            "t2i_prompt": str(found.get("t2i_prompt", "") or ""),
            "i2v_prompt": str(found.get("i2v_prompt", "") or ""),
            "captured_frame_path":
                str(found.get("captured_frame_path", "") or ""),
            "selected_for_remake":
                bool(found.get("selected_for_remake", False)),
            "clip_name": str(found.get("name", "") or ""),
            "clip_path": str(found.get("path", "") or "")}


# --------------------------------------------------------------------------
# remake queue
# --------------------------------------------------------------------------

def _matches_clip_number(filename, clip_number) -> bool:
    match = re.match(r"video_(\d+)", str(filename or ""),
                     flags=re.IGNORECASE)
    return bool(match) and int(match.group(1)) == int(clip_number)


def _find_in_folder(folder, item, fallback_name="") -> str:
    """A clip's file inside ``remake/`` or ``backup/``: exact name, else
    lowest-sorting ``video_<N>*`` match (``:1128-1143``)."""
    if not folder or not os.path.isdir(folder):
        return ""
    fallback_name = os.path.basename(str(fallback_name or ""))
    exact = os.path.join(folder, fallback_name) if fallback_name else ""
    if exact and os.path.isfile(exact):
        return exact
    matches = sorted(
        (os.path.join(folder, name) for name in os.listdir(folder)
         if os.path.isfile(os.path.join(folder, name))
         and _matches_clip_number(name,
                                  item.get("clip_number", 0) or 0)),
        key=lambda value: natural_key(os.path.basename(value)))
    return matches[0] if matches else ""


def selected_clips(clips_obj) -> list[dict]:
    items = [item for item in clips_obj.values()
             if isinstance(item, dict)
             and item.get("selected_for_remake")]
    items.sort(key=lambda item: int(item.get("clip_number", 0) or 0))
    return items


def prepare_remake_files(selected, output_folder) -> list[dict]:
    """Per-clip staging state: ``pending`` = file sits in ``remake/``,
    ``done`` = already moved on to ``backup/`` (``:1145-1175``)."""
    remake_dir = os.path.join(output_folder, "remake")
    backup_dir = os.path.join(output_folder, "backup")
    for folder in (output_folder, remake_dir, backup_dir):
        os.makedirs(folder, exist_ok=True)
    prepared = []
    for item in selected:
        raw = _clean(item.get("path"))
        basename = (os.path.basename(raw) if raw
                    else str(item.get("name", "") or "").strip())
        basename = basename or \
            f"video_{int(item.get('clip_number', 0) or 0):04d}.mp4"
        remake_path = _find_in_folder(remake_dir, item, basename) \
            or os.path.join(remake_dir, basename)
        existing_backup = _find_in_folder(backup_dir, item, basename)
        remake_exists = os.path.isfile(remake_path)
        prepared.append({
            "item": item,
            "main_path": os.path.join(output_folder, basename),
            "remake_path": remake_path,
            "backup_path": existing_backup
            or os.path.join(backup_dir, basename),
            "basename": basename,
            "done": bool(existing_backup) and not remake_exists,
            "pending": remake_exists,
        })
    return prepared


def move_remake_to_backup(entry, output_folder) -> str:
    """Consume the queue head: remake/ -> backup/ (timestamped when the
    slot is taken) (``:1177-1196``)."""
    remake_path = _clean(entry.get("remake_path"))
    if not remake_path or not os.path.isfile(remake_path):
        return _clean(entry.get("backup_path"))
    backup_dir = os.path.join(output_folder, "backup")
    os.makedirs(backup_dir, exist_ok=True)
    basename = os.path.basename(remake_path)
    backup_path = os.path.join(backup_dir, basename)
    if os.path.exists(backup_path):
        stem, ext = os.path.splitext(basename)
        backup_path = os.path.join(
            backup_dir, f"{stem}_{time.strftime('%Y%m%d_%H%M%S')}{ext}")
    os.replace(remake_path, backup_path)
    entry.update(backup_path=backup_path, remake_path="",
                 pending=False, done=True)
    return backup_path


def next_remake(session_path, srt_file, audio, queue_index: int = 0,
                fps: int = 24, tail_loss_frames: int = 5,
                pre_frames: int = 0) -> dict:
    """One step of the remake queue (``VRGDG_RemakeClipQueue.run``,
    ``:1320-1445``): pick the first pending staged clip (or an explicit
    1-based ``queue_index``), move its file to ``backup/``, and slice
    the project audio to the clip's SRT window, frame-locked to 8N+1.

    ``audio`` is a path or an ``{"waveform", "sample_rate"}`` dict.
    Returns ``is_valid: False`` with instructions when nothing is
    pending — callers loop until then (no ComfyUI queue events)."""
    from ..runtime import audio_toolkit as at

    path, session, clips_obj = _session_clips(session_path)
    selected = selected_clips(clips_obj)
    output_folder = _clean(session.get("project_folder")) \
        or os.path.dirname(os.path.dirname(path))
    with project_write_lock(output_folder):
        prepared = (prepare_remake_files(selected, output_folder)
                    if selected else [])
        pending = [entry for entry in prepared if entry["pending"]]

        entry = None
        queue_position = 0
        if int(queue_index) > 0:
            position = int(queue_index) - 1
            queue_position = int(queue_index)
            if 0 <= position < len(prepared):
                entry = prepared[position]
        elif pending:
            entry = pending[0]
            number = int(entry["item"].get("clip_number", 0) or 0)
            queue_position = next(
                (index for index, other in enumerate(prepared, start=1)
                 if int(other["item"].get("clip_number", 0) or 0)
                 == number), 1)
        else:
            queue_position = len(prepared) + 1

        if entry is not None:
            item = entry["item"]
            clip_number = int(item.get("clip_number", 0) or 0)
            backup_path = move_remake_to_backup(entry, output_folder)

    if entry is None:
        instructions = (
            "No selected remake clips were found. Select clips for "
            "remake, then save the editor session."
            if not selected else
            "No clips are currently in the remake folder. Save the "
            "editor session to move selected clips into remake.")
        return {"is_valid": False, "instructions": instructions,
                "queue_position": queue_position,
                "total_selected": len(selected),
                "remaining_remakes": len(pending),
                "output_folder": output_folder}

    if isinstance(audio, (str, os.PathLike)):
        audio = at.load_audio(str(audio))
    waveform, rate = at.as_waveform(audio)
    total_duration = waveform.shape[-1] / rate
    srt_path = _clean(srt_file)
    if not srt_path or not os.path.isfile(srt_path):
        raise FileNotFoundError(f"SRT file was not found: {srt_path}")
    # last scene extends to the audio end, like the reference (:1377-1378)
    segments = at.srt_segments_for_audio(audio, srt_path)
    if not 1 <= clip_number <= len(segments):
        raise ValueError(
            f"Clip number {clip_number} is out of range for SRT "
            f"entries ({len(segments)}).")

    # frame-locked slice; preroll skipped for the first clip (:1286-1289)
    preroll = 0 if clip_number <= 1 else max(0, int(pre_frames))
    start_sec, end_sec = segments[clip_number - 1]
    fps = max(1, int(fps))
    start_frame = int(round(start_sec * fps))
    end_frame = int(round(end_sec * fps))
    frames_per_scene = max(1, end_frame - start_frame)
    base_frames = frames_per_scene + preroll \
        + max(0, int(tail_loss_frames))
    frames_for_ltx = at.round_up_8n1(base_frames)
    samples_per_frame = rate / fps
    start_samp = max(0, int(round(start_frame * samples_per_frame))
                     - int(round(preroll * samples_per_frame)))
    end_samp = min(waveform.shape[-1],
                   start_samp + int(round(base_frames
                                          * samples_per_frame)))
    segment = waveform[..., start_samp:end_samp].copy()
    out_rate = 44100
    if rate != out_rate:
        segment = at.resample_waveform(segment, rate, out_rate)
    desired = int(round(frames_for_ltx * out_rate / fps))
    if segment.shape[-1] < desired:
        segment = np.pad(
            segment, [(0, 0), (0, 0), (0, desired - segment.shape[-1])])
    else:
        segment = segment[..., :desired]

    return {
        "is_valid": True,
        "audio": at.make_audio(segment, out_rate),
        "total_duration": total_duration,
        "clip_number": clip_number,
        "index": max(0, clip_number - 1),
        "frames_for_ltx": frames_for_ltx,
        "frames_per_scene": frames_per_scene,
        "pre_frames": preroll,
        "start_time": format_seconds(start_frame / fps),
        "end_time": format_seconds(end_frame / fps),
        "start_seconds": start_frame / fps,
        "end_seconds": end_frame / fps,
        "t2i_prompt": str(item.get("t2i_prompt", "") or ""),
        "i2v_prompt": str(item.get("i2v_prompt", "") or ""),
        "captured_frame_path":
            str(item.get("captured_frame_path", "") or ""),
        "clip_name": str(item.get("name", "") or ""),
        "clip_path": backup_path or str(item.get("path", "") or ""),
        "backup_path": backup_path,
        "replacement_path": entry["main_path"],
        "queue_position": queue_position,
        "total_selected": len(selected),
        "remaining_remakes": max(0, len(pending) - 1),
        "total_sets": len(segments),
        "output_folder": output_folder,
        "overwrite_mode": "overwrite",
        "audio_meta": {"durations_frames": [frames_per_scene]},
        "instructions": (
            f"Remake queue item {queue_position} / {len(selected)}; "
            f"remaining after this one: {max(0, len(pending) - 1)}. "
            f"Clip {clip_number} "
            f"{format_seconds(start_frame / fps)} -> "
            f"{format_seconds(end_frame / fps)}; original moved to "
            f"{backup_path}"),
    }


def is_editor_media(path) -> bool:
    """True when ``path`` sits inside an editor-managed clips folder —
    its directory (or a parent up to two levels, covering ``remake/``
    and ``vrgdg_editor_frames/``) holds the editor session file. The
    media GET routes use this so the playback URLs ``list_clips`` emits
    for arbitrary absolute folders stay servable without opening the
    whole filesystem."""
    folder = os.path.dirname(os.path.normpath(os.path.abspath(
        str(path or ""))))
    for _level in range(3):
        if os.path.isfile(session_path_for(folder)):
            return True
        parent = os.path.dirname(folder)
        if parent == folder:
            break
        folder = parent
    return False
