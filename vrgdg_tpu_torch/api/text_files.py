"""Shared text-file and audio-file libraries under the output root.

A copy of :mod:`vrgdg_tpu.api.text_files` (which cannot be imported
without JAX): every function keeps its original's source.

Framework-native re-derivation of the reference's small file-library
routes:

- text-file browser over ``VRGDG_TEMP/TextFiles``
  (``VRGDG_GeneralNodes.py:1606-1830``): category
  listing, manual folder listing with newest-first merge across root
  candidates, folder enumeration, and the custom-base-path
  normalization that accepts any ancestor of the TextFiles layout,
- the builder's editable text-file load/save
  (``VRGDG_MusicVideoBuilderNodes.py:2666-2694``): ``.txt``/``.json``
  only,
- the audio library list/upload
  (``VRGDG_AudioNodes.py:497-560``): the reference stores uploads in
  ComfyUI's input dir; standalone they live under
  ``<output_root>/VRGDG_AudioFiles`` — the same folder
  :func:`vrgdg_tpu_torch.api.builder.default_audio_srt_paths` reads,
- ``part2/load_concept_prompts``
  (``VRGDG_GeneralNodes2.py:1220-1250``): the shared ConceptPrompts
  handoff file,
- the quick-input popup (``VRGDG_GeneralNodes2.py:519-520``,
  ``:561-563``, the ``test_popup`` routes at ``:1205-1310``): six fixed
  text targets under ``VRGDG_TEMP/TextFiles`` plus a single-slot audio
  drop into ``VRGDG_AudioFiles``.
"""

from __future__ import annotations

import json
import os
import re

from .builder import _clean, safe_component
from .paths import DEFAULT_OUTPUT_ROOT

TEXT_ROOT_FOLDER = "VRGDG_TEMP"
TEXT_SUBFOLDER = "TextFiles"
CATEGORY_OPTIONS = ("subject1", "subject2", "scene1", "scene2",
                    "other1", "other2")
# the reference library accepts audio AND video containers
# (filter_files_content_types([..., "audio", "video"])); the builder's
# default-audio discovery reads only the pure-audio subset
# (builder.AUDIO_EXTENSIONS)
AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".m4a", ".ogg", ".mp4",
                    ".mov", ".webm")


def normalize_category(category) -> str:
    value = str(category or "").strip().lower()
    return value if value in CATEGORY_OPTIONS else CATEGORY_OPTIONS[0]


def sanitize_segment(value, fallback: str = "default") -> str:
    text = re.sub(r"[^A-Za-z0-9_\- ]+", "_",
                  str(value or "").strip()).strip(" .")
    return text or fallback


def text_files_root(output_root=None) -> str:
    return os.path.normpath(os.path.join(
        os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT),
        TEXT_ROOT_FOLDER, TEXT_SUBFOLDER))


def normalize_custom_root(custom_base_path) -> str:
    """Accept any level of the ``VRGDG_TEMP/TextFiles`` layout — the
    base dir, either layout component, or a folder inside it — and
    return the TextFiles root (``:1704-1721``)."""
    raw = str(custom_base_path or "").strip().strip("\"'")
    if not raw:
        return ""
    path = os.path.normpath(os.path.abspath(
        os.path.expandvars(os.path.expanduser(raw))))
    layout = [TEXT_ROOT_FOLDER.lower(), TEXT_SUBFOLDER.lower()]
    parts = path.split(os.sep)
    tail = [part.lower() for part in parts[-3:]]
    # locate where the given path sits relative to the two-component
    # layout and re-anchor onto its TextFiles directory
    if tail[-2:] == layout:
        return path
    if tail[-1:] == layout[:1]:
        return os.path.normpath(os.path.join(path, TEXT_SUBFOLDER))
    if tail[:2] == layout:
        return os.path.normpath(os.sep.join(parts[:-1]))
    return os.path.normpath(os.path.join(path, TEXT_ROOT_FOLDER,
                                         TEXT_SUBFOLDER))


def list_category(category, output_root=None) -> dict:
    """``.txt`` names in a category folder (``:1730-1753``)."""
    category = normalize_category(category)
    folder = os.path.join(text_files_root(output_root), category)
    files = []
    if os.path.isdir(folder):
        files = sorted((name for name in os.listdir(folder)
                        if name.lower().endswith(".txt")
                        and os.path.isfile(os.path.join(folder, name))),
                       key=str.lower)
    return {"category": category, "files": files, "folder": folder}


def list_folders(output_root=None) -> dict:
    root = text_files_root(output_root)
    folders = []
    if os.path.isdir(root):
        folders = sorted((name for name in os.listdir(root)
                          if os.path.isdir(os.path.join(root, name))),
                         key=str.lower)
    return {"folders": folders, "root": root}


def list_folder_files(folder_name, use_most_recent: bool = False,
                      custom_base_path: str = "",
                      output_root=None) -> dict:
    """Newest-first ``.txt`` listing for a named folder (``:1768-1808``);
    ``use_most_recent`` keeps only the newest file."""
    safe_folder = sanitize_segment(folder_name)
    root = (normalize_custom_root(custom_base_path)
            if custom_base_path else text_files_root(output_root))
    folder_path = os.path.normpath(os.path.join(root, safe_folder))
    rows = []
    if os.path.isdir(folder_path):
        for name in os.listdir(folder_path):
            full = os.path.join(folder_path, name)
            if not os.path.isfile(full) \
                    or not name.lower().endswith(".txt"):
                continue
            try:
                rows.append((name, os.path.getmtime(full)))
            except OSError:
                rows.append((name, 0.0))
    rows.sort(key=lambda row: (-row[1], row[0].lower()))
    files = [name for name, _mtime in rows]
    if use_most_recent and files:
        files = files[:1]
    return {"folder": safe_folder, "folder_path": folder_path,
            "use_most_recent": bool(use_most_recent),
            "custom_text_files_root":
                normalize_custom_root(custom_base_path)
                if custom_base_path else "",
            "files": files}


# ------------------------------------------------------------------
# editable text files (builder load_text_file / save_text_file)
# ------------------------------------------------------------------

_EDITABLE_SUFFIXES = frozenset({".txt", ".json"})


def _editable_text_file(payload, content=None) -> dict:
    """Shared read/write body for the builder's editable-file routes;
    only ``.txt``/``.json`` may pass, and writes create parents."""
    file_path = os.path.normpath(os.path.abspath(
        _clean(payload.get("path"))))
    if not _clean(payload.get("path")):
        raise ValueError("Text file path is empty.")
    if os.path.splitext(file_path)[1].lower() not in _EDITABLE_SUFFIXES:
        raise ValueError("Only .txt or .json files can be edited here.")
    if content is None:
        if not os.path.isfile(file_path):
            raise FileNotFoundError(
                f"Text file was not found: {file_path}")
        with open(file_path, "r", encoding="utf-8-sig",
                  errors="replace") as handle:
            return {"path": file_path, "content": handle.read()}
    os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
    with open(file_path, "w", encoding="utf-8", newline="") as handle:
        handle.write(content)
    return {"path": file_path}


def load_text_file(payload: dict) -> dict:
    return _editable_text_file(payload)


def save_text_file(payload: dict) -> dict:
    return _editable_text_file(
        payload, str(payload.get("content", "") or ""))


# ------------------------------------------------------------------
# audio library
# ------------------------------------------------------------------

def audio_library_folder(output_root=None) -> str:
    folder = os.path.join(os.path.abspath(output_root
                                          or DEFAULT_OUTPUT_ROOT),
                          "VRGDG_AudioFiles")
    os.makedirs(folder, exist_ok=True)
    return folder


def list_audio(output_root=None) -> dict:
    folder = audio_library_folder(output_root)
    files = sorted(name for name in os.listdir(folder)
                   if os.path.isfile(os.path.join(folder, name))
                   and name.lower().endswith(AUDIO_EXTENSIONS))
    return {"files": files, "input_dir": folder}


def save_audio_upload(filename, data: bytes, overwrite: bool = False,
                      output_root=None) -> dict:
    """Store an uploaded audio file, suffixing ``(N)`` unless
    overwriting (``VRGDG_AudioNodes.py:519-560``)."""
    folder = audio_library_folder(output_root)
    name = os.path.basename(_clean(filename))
    stem, ext = os.path.splitext(name)
    stem = safe_component(stem, "audio_upload")
    if ext.lower() not in AUDIO_EXTENSIONS:
        raise ValueError("Unsupported audio type.")
    candidate = os.path.join(folder, f"{stem}{ext}")
    if not overwrite:
        index = 1
        while os.path.exists(candidate):
            candidate = os.path.join(folder, f"{stem} ({index}){ext}")
            index += 1
    with open(candidate, "wb") as handle:
        handle.write(data)
    # response contract: {"name", "files"} (VRGDG_AudioNodes.py:546-548)
    return {"name": os.path.basename(candidate),
            "files": list_audio(output_root)["files"],
            "path": candidate, "input_dir": folder}


# ------------------------------------------------------------------
# quick-input popup (test_popup routes, VRGDG_GeneralNodes2.py:1205-1310)
# ------------------------------------------------------------------

# field -> path parts under the output root (``_VRGDG_TEST_TEXT_TARGETS``,
# ``:49-56``) — the files the HuMo automation nodes read back
POPUP_TEXT_TARGETS = {
    "full_lyrics": (TEXT_ROOT_FOLDER, TEXT_SUBFOLDER, "fulllyrics",
                    "full_lyrics.txt"),
    "style_theme": (TEXT_ROOT_FOLDER, TEXT_SUBFOLDER, "themestyle",
                    "themestyle.txt"),
    "story_idea": (TEXT_ROOT_FOLDER, TEXT_SUBFOLDER, "storyconcept",
                   "storyconcept.txt"),
    "subjects_and_scenes": (TEXT_ROOT_FOLDER, TEXT_SUBFOLDER,
                            "subjectandscenes", "subjectsandscenes.txt"),
    "text_to_image_notes": (TEXT_ROOT_FOLDER, TEXT_SUBFOLDER, "t2iNotes",
                            "t2iNotes.txt"),
    "image_to_video_notes": (TEXT_ROOT_FOLDER, TEXT_SUBFOLDER,
                             "i2vNotes", "i2vNotes.txt"),
}


def vrgdg_text_file_path(folder_name, file_name,
                         output_root=None) -> str:
    """``<root>/VRGDG_TEMP/TextFiles/<folder>/<file>``
    (``_get_vrgdg_text_file_path``, ``VRGDG_GeneralNodes2.py:576-585``).
    The t2i/t2v-from-concepts flow reads its inputs from
    ``themestyle``/``storyconcept`` and writes its generated prompts to
    ``t2i_Prompts/t2i_Prompts.txt`` / ``t2v_Prompts/t2v_Prompts.txt``
    (``:588-593``) — external-LLM users keep the same layout (see
    docs/MIGRATION.md)."""
    return os.path.normpath(os.path.join(text_files_root(output_root),
                                         sanitize_segment(folder_name),
                                         str(file_name)))


def popup_text_path(field_name, output_root=None) -> str:
    """``_get_test_popup_text_path`` (``:561-563``)."""
    parts = POPUP_TEXT_TARGETS[field_name]
    return os.path.normpath(os.path.join(
        os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT), *parts))


def popup_config(output_root=None) -> dict:
    """GET ``test_popup/config`` payload (``:1205-1218``); the
    reference's multi-output-root concept-prompts search collapses to
    the single managed root standalone."""
    return {
        "audio_dir": audio_library_folder(output_root),
        "text_targets": {field: popup_text_path(field, output_root)
                         for field in POPUP_TEXT_TARGETS},
        "concept_prompts_path": os.path.join(
            text_files_root(output_root), "ConceptPrompts",
            "ConceptPrompts.txt"),
    }


def popup_save_text(payload: dict, output_root=None) -> dict:
    """POST ``test_popup/save_text`` (``:1248-1277``): every known
    field writes its fixed target (missing fields write empty)."""
    saved_paths = {}
    for field in POPUP_TEXT_TARGETS:
        path = popup_text_path(field, output_root)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as handle:
            handle.write(str(payload.get(field, "") or ""))
        saved_paths[field] = path
    return {"saved_paths": saved_paths}


def popup_upload_audio(filename, data: bytes,
                       output_root=None) -> dict:
    """POST ``test_popup/upload_audio`` (``:1279-1307``): a single-slot
    drop — every existing file in the library folder is removed before
    the new one lands (the popup feeds exactly one mix downstream)."""
    name = os.path.basename(str(filename or "").strip())
    if not name:
        raise ValueError("Invalid audio filename.")
    folder = audio_library_folder(output_root)
    for existing in os.listdir(folder):
        existing_path = os.path.join(folder, existing)
        if os.path.isfile(existing_path):
            os.remove(existing_path)
    path = os.path.join(folder, name)
    with open(path, "wb") as handle:
        handle.write(data)
    return {"path": path, "filename": name}


def load_shared_concept_prompts(output_root=None) -> dict:
    """The Step-1 -> Step-2 ConceptPrompts handoff file
    (``VRGDG_GeneralNodes2.py:1220-1250``)."""
    path = os.path.join(text_files_root(output_root), "ConceptPrompts",
                        "ConceptPrompts.txt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            "ConceptPrompts.txt was not found. Run Step 1 first or "
            "paste the prompt JSON manually.")
    with open(path, "r", encoding="utf-8-sig") as handle:
        # response contract: {"text", "path"} (GeneralVideoNodes2:1246)
        return {"path": path, "text": handle.read()}


# ------------------------------------------------------------------
# advanced text savers (VRGDG_SaveTextAdvanced :1922-1960,
# VRGDG_SaveTextAdvancedConcat :3152-3260)
# ------------------------------------------------------------------

def coerce_text_payload(text) -> str:
    """Tolerant text coercion (``_coerce_text_payload``, ``:1852-1859``):
    dict/list payloads render as pretty JSON."""
    if text is None:
        return ""
    if isinstance(text, str):
        return text
    if isinstance(text, (dict, list)):
        return json.dumps(text, ensure_ascii=False, indent=2)
    return str(text)


def next_incremental_file_name(folder_path: str, base_name: str) -> str:
    """``{base}_NNN.txt`` with the next free number.

    The reference's non-overwrite save calls
    ``_next_incremental_prefixed_file_name`` (``:1948``, ``:3222``) which
    is never defined anywhere in the pack — a latent NameError on that
    branch. This implements the evidently intended behavior (numbered
    siblings that never clobber) rather than the crash."""
    taken = set()
    pattern = re.compile(rf"^{re.escape(base_name)}_(\d+)\.txt$",
                         re.IGNORECASE)
    if os.path.isdir(folder_path):
        for name in os.listdir(folder_path):
            match = pattern.match(name)
            if match:
                taken.add(int(match.group(1)))
    number = 1
    while number in taken:
        number += 1
    return f"{base_name}_{number:03d}.txt"


def _manual_folder(folder_name, output_root=None) -> str:
    folder = os.path.normpath(os.path.join(
        text_files_root(output_root), sanitize_segment(folder_name)))
    os.makedirs(folder, exist_ok=True)
    return folder


def save_text_advanced(payload: dict, output_root=None) -> dict:
    """Folder-based text save with overwrite/incremental naming
    (``VRGDG_SaveTextAdvanced.run``, ``:1942-1960``)."""
    folder = _manual_folder(payload.get("folder_name", "story"),
                            output_root)
    base = sanitize_segment(payload.get("file_name", "text"), "text")
    if payload.get("overwrite"):
        name = f"{base}.txt"
    else:
        name = next_incremental_file_name(folder, base)
    path = os.path.normpath(os.path.join(folder, name))
    text = coerce_text_payload(payload.get("text"))
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(text)
    return {"text": text, "file_path": path}


def _clean_prompt_for_json(text) -> str:
    """Drop blank lines / trailing whitespace (``:3171-3176``)."""
    return "\n".join(line.rstrip()
                     for line in str(text or "").splitlines()
                     if line.strip()).strip()


def _prompt_sidecar_state(json_path: str, existing_text: str) -> dict:
    """Renumbered ``Prompt{N}`` mapping from the JSON sidecar, falling
    back to the existing text as Prompt1 (``:3178-3204``)."""
    if os.path.isfile(json_path):
        try:
            with open(json_path, "r", encoding="utf-8") as handle:
                loaded = json.load(handle)
            if isinstance(loaded, dict):
                def order_key(key):
                    return (int(key[6:])
                            if re.fullmatch(r"Prompt\d+", key) else 999999)

                prompts = [str(loaded[key])
                           for key in sorted(loaded, key=order_key)
                           if str(loaded[key]).strip()]
                if prompts:
                    return {f"Prompt{i}": prompt
                            for i, prompt in enumerate(prompts, start=1)}
        except Exception:
            pass
    cleaned = _clean_prompt_for_json(existing_text)
    return {"Prompt1": cleaned} if cleaned else {}


def save_text_concat(payload: dict, output_root=None) -> dict:
    """Concat-mode story saver with a ``Prompt{N}`` JSON sidecar
    (``VRGDG_SaveTextAdvancedConcat.run``, ``:3212-3260``): concat
    appends with a blank-line separator and extends the sidecar; plain
    saves follow the advanced naming rules."""
    folder = _manual_folder(payload.get("folder_name", "story"),
                            output_root)
    base = sanitize_segment(payload.get("file_name", "story"), "text")
    concat = bool(payload.get("concat"))
    if concat or payload.get("overwrite"):
        name = f"{base}.txt"
    else:
        name = next_incremental_file_name(folder, base)
    path = os.path.normpath(os.path.join(folder, name))
    json_path = os.path.splitext(path)[0] + ".json"
    text_to_add = coerce_text_payload(payload.get("text"))
    saved_text = text_to_add
    existing_text = ""
    if concat and os.path.isfile(path):
        try:
            with open(path, "r", encoding="utf-8") as handle:
                existing_text = handle.read()
        except UnicodeDecodeError:
            with open(path, "r", encoding="utf-8-sig") as handle:
                existing_text = handle.read()
        if existing_text and text_to_add:
            saved_text = (existing_text.rstrip("\r\n") + "\n\n"
                          + text_to_add.lstrip("\r\n"))
        elif existing_text:
            saved_text = existing_text
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(saved_text)

    prompt_json = dict(_prompt_sidecar_state(json_path, existing_text)
                       if concat else {})
    cleaned = _clean_prompt_for_json(text_to_add)
    if cleaned:
        prompt_json[f"Prompt{len(prompt_json) + 1}"] = cleaned
    rendered = json.dumps(prompt_json, ensure_ascii=False, indent=2)
    with open(json_path, "w", encoding="utf-8") as handle:
        handle.write(rendered)
    return {"text": saved_text, "file_path": path, "json": prompt_json,
            "json_string": rendered, "json_path": json_path}
