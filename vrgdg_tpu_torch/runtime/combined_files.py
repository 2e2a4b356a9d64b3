"""Combined-batch JSON browsing + remake prompt editing.

A copy of :mod:`vrgdg_tpu.runtime.combined_files` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

Re-derivation of the reference's combined-file UI cluster
(``VRGDG_GeneralNodes.py:24-437`` — constants, the
latest-batch-folder scan, combined-file listing/resolution, the
prompt-row extraction the UI renders, and the remake-mode update
mechanics; the four HTTP handlers at ``:447-601``).  This is the edit
loop for LLM batch outputs: `runtime/llm_batches.py` plans and combines
the batches, this module lets the user browse the newest
``*_COMBINED.json``, rewrite individual ``promptN`` entries (remake
mode), and derive which prompt numbers a ``remake/`` folder wants
re-rendered from its ``video_N_*`` filenames.

All pure host-side file/JSON math — oracle-fuzzed against the
AST-extracted reference functions in ``tests/test_combined_files.py``.
Unlike the reference (which reads ComfyUI's ``folder_paths``), every
entry point takes the managed ``llm_batches`` root explicitly.
"""

from __future__ import annotations

import json
import os
import re

# batch-type table (ref ``:29-31``, ``:84-89``): anything that is not
# exactly Image2Video normalizes to Text2Image
_BATCH_PREFIXES = {
    "Image2Video": "Image2Video_Batch_",
    "Text2Image": "Text2Image_Batch_",
}
DEFAULT_BATCH_TYPE = "Text2Image"
COMBINED_SUFFIX = "_COMBINED.json"
NO_FILES_OPTION = "<no files found>"  # UI placeholder entry (``:28``)
MAX_PROMPT_EDIT_SLOTS = 120  # ``:32``

_PROMPT_KEY = re.compile(r"^prompt(\d+)$", re.IGNORECASE)
_REMAKE_VIDEO = re.compile(r"^video_(\d+)_", re.IGNORECASE)


def normalize_batch_type(value) -> str:
    """``:78-82`` — strict match on Image2Video, else the default."""
    text = str(value or "").strip()
    return text if text in _BATCH_PREFIXES else DEFAULT_BATCH_TYPE


def batch_prefix(batch_type) -> str:
    return _BATCH_PREFIXES[normalize_batch_type(batch_type)]


def latest_batch_folder(root, batch_type) -> str | None:
    """Most-recently-modified batch folder for the type (``:40-74``
    with the prefix filter the routes always pass)."""
    newest, newest_mtime = None, -1.0
    prefix = batch_prefix(batch_type)
    try:
        entries = list(os.scandir(root))
    except OSError:
        return None
    for entry in entries:
        if not entry.name.startswith(prefix) or not entry.is_dir():
            continue
        try:
            mtime = entry.stat().st_mtime
        except OSError:
            continue
        if mtime > newest_mtime:
            newest, newest_mtime = entry.path, mtime
    return newest


def list_combined_files(root, batch_type):
    """``(names, folder)`` of ``*_COMBINED.json`` in the latest batch
    folder, case-insensitively sorted (``:92-106``)."""
    folder = latest_batch_folder(root, batch_type)
    if not folder:
        return [], None
    names = [entry.name for entry in os.scandir(folder)
             if entry.is_file()
             and entry.name.endswith(COMBINED_SUFFIX)]
    return sorted(names, key=str.lower), folder


def latest_combined_file(root, batch_type) -> str | None:
    """Newest combined file by max(ctime, mtime) (``:126-146``)."""
    names, folder = list_combined_files(root, batch_type)
    newest, newest_stamp = None, -1.0
    for name in names:
        path = os.path.normpath(os.path.join(folder, name))
        if not os.path.isfile(path):
            continue
        try:
            stamp = max(os.path.getctime(path), os.path.getmtime(path))
        except OSError:
            continue
        if stamp > newest_stamp:
            newest, newest_stamp = path, stamp
    return newest


def resolve_combined_file(root, batch_type, selected,
                          allow_auto_latest: bool = False):
    """``(path, error)`` for a UI file selection (``:150-172``): the
    basename must exist in the latest batch folder; empty/placeholder
    selections (and stale ones, when allowed) fall back to the newest
    file on disk."""
    name = os.path.basename(str(selected or "").strip())
    batch_type = normalize_batch_type(batch_type)

    def _auto():
        return latest_combined_file(root, batch_type) \
            if allow_auto_latest else None

    if not name or name == NO_FILES_OPTION:
        path = _auto()
        return (path, "") if path else \
            (None, "No combined JSON file selected.")
    names, folder = list_combined_files(root, batch_type)
    if not folder:
        return None, f"No latest {batch_type} batch folder found."
    if name not in names:
        path = _auto()
        return (path, "") if path else \
            (None, f"Selected file not found in latest {batch_type} "
                   f"batch folder.")
    path = os.path.normpath(os.path.join(folder, name))
    if not os.path.isfile(path):
        return None, "Selected combined JSON file does not exist on disk."
    return path, ""


def load_combined(file_path) -> dict:
    """``:175-190`` — utf-8 with a utf-8-sig retry on decode errors
    (note the retry never fires for BOM files: utf-8 decodes the BOM
    fine and ``json.loads`` then rejects it — reference behavior, locked
    by the fuzz); blank file is an empty mapping; anything but an object
    is rejected."""
    try:
        with open(file_path, "r", encoding="utf-8") as fh:
            raw = fh.read()
    except UnicodeDecodeError:
        with open(file_path, "r", encoding="utf-8-sig") as fh:
            raw = fh.read()
    data = json.loads(raw) if (raw or "").strip() else {}
    if not isinstance(data, dict):
        raise ValueError("Combined JSON must be a JSON object.")
    return data


def write_combined(file_path, data) -> None:
    """``:193-196``."""
    with open(file_path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, ensure_ascii=False, indent=2)
        fh.write("\n")


def prompt_number(key) -> int | None:
    """Positive N from a ``promptN`` key, else None (``:199-207``)."""
    match = _PROMPT_KEY.match(str(key or ""))
    if match:
        value = int(match.group(1))
        if value > 0:
            return value
    return None


def normalize_image_indexes(value) -> list:
    """int-coercible entries of a list, everything else drops
    (``:210-219``)."""
    out = []
    for item in value if isinstance(value, list) else ():
        try:
            out.append(int(item))
        except Exception:  # noqa: BLE001 — parity: every bad entry drops
            continue
    return out


def parse_image_index_input(raw):
    """``(present, indexes)`` from a UI image-index field
    (``:222-251``): absent -> not present; lists pass through; strings
    try JSON, then comma-separated ints."""
    if raw is None:
        return False, []
    if isinstance(raw, list):
        return True, normalize_image_indexes(raw)
    text = str(raw).strip()
    if not text:
        return True, []
    try:
        parsed = json.loads(text)
    except Exception:  # noqa: BLE001 — fall through to comma parsing
        parsed = None
    if isinstance(parsed, list):
        return True, normalize_image_indexes(parsed)
    parts = text.split(",") if "," in text else [text]
    out = []
    for part in parts:
        part = part.strip()
        if part:
            try:
                out.append(int(part))
            except Exception:  # noqa: BLE001
                continue
    return True, out


def clean_folder_text(folder_path) -> str:
    """Pasted-path cleanup (``:254-264``): file URLs and wrapping
    quotes/backticks peel off."""
    raw = str(folder_path or "").strip()
    if raw.startswith("file:///"):
        raw = raw[len("file:///") :]
    return raw.strip().strip("\"'`").strip()


def resolve_remake_folder(folder_path):
    """``(path, error)`` — the folder itself when already named
    ``remake``, else its ``remake/`` child (``:267-280``)."""
    raw = clean_folder_text(folder_path)
    if not raw:
        return None, "Folder path is empty."
    base = os.path.normpath(raw)
    folder = base if os.path.basename(base).lower() == "remake" \
        else os.path.normpath(os.path.join(base, "remake"))
    if not os.path.isdir(folder):
        return None, f"Remake folder not found: {folder}"
    return folder, ""


def remake_prompt_indexes(folder_path,
                          max_items: int = MAX_PROMPT_EDIT_SLOTS):
    """``(sorted prompt numbers, error)`` mined from ``video_N_*``
    filenames in the remake folder (``:283-309``)."""
    folder, error = resolve_remake_folder(folder_path)
    if not folder:
        return None, error
    found = set()
    for entry in os.scandir(folder):
        if not entry.is_file():
            continue
        match = _REMAKE_VIDEO.match(entry.name)
        if match and int(match.group(1)) > 0:
            found.add(int(match.group(1)))
    return sorted(found)[:max_items] if found else [], ""


def prompt_rows(data, max_items=None) -> list:
    """UI rows from a combined object (``:312-351``): one row per
    ``promptN`` key sorted by N; dict values surface their ``text`` (or
    a pretty JSON dump when the schema is foreign) plus the normalized
    ``imageIndex``; scalars stringify."""
    rows = []
    if not isinstance(data, dict):
        return rows
    for key, value in data.items():
        number = prompt_number(key)
        if number is None:
            continue
        indexes = []
        if isinstance(value, dict):
            indexes = normalize_image_indexes(value.get("imageIndex"))
            if "text" in value:
                text = value.get("text")
                text = "" if text is None else \
                    (text if isinstance(text, str) else str(text))
            else:
                try:
                    text = json.dumps(value, ensure_ascii=False,
                                      indent=2)
                except Exception:  # noqa: BLE001 — unserializable dict
                    text = str(value)
        else:
            text = str(value) if value is not None else ""
        rows.append({"prompt_number": number, "prompt": text,
                     "image_index": indexes})
    rows.sort(key=lambda row: row["prompt_number"])
    if isinstance(max_items, int) and max_items > 0:
        rows = rows[:max_items]
    return rows


def coerce_updates(raw_updates,
                   max_items: int = MAX_PROMPT_EDIT_SLOTS) -> list:
    """Validated update rows from the UI payload (``:354-390``)."""
    rows = []
    if not isinstance(raw_updates, list):
        return rows
    for item in raw_updates:
        if not isinstance(item, dict):
            continue
        try:
            number = int(item.get("prompt_number"))
        except Exception:  # noqa: BLE001 — parity: bad rows drop
            continue
        if number <= 0:
            continue
        text = item.get("prompt", "")
        text = "" if text is None else \
            (text if isinstance(text, str) else str(text))
        present, indexes = parse_image_index_input(
            item.get("image_index"))
        rows.append({"prompt_number": number, "prompt": text,
                     "has_image_index": present,
                     "image_index": indexes})
        if len(rows) >= max_items:
            break
    return rows


def apply_updates(data, updates,
                  batch_type=DEFAULT_BATCH_TYPE):
    """Mutate the combined object in place; ``(changed, keys touched)``
    (``:393-437``).  Text2Image entries are ``{"text", "imageIndex"}``
    objects (image indexes only rewrite when the payload carried the
    field); Image2Video entries are plain strings."""
    structured = normalize_batch_type(batch_type) == "Text2Image"
    changed = 0
    touched = []
    for item in updates:
        key = f"prompt{item.get('prompt_number')}"
        text = item.get("prompt", "")
        current = data.get(key)
        if isinstance(current, dict):
            if current.get("text") != text:
                current["text"] = text
                changed += 1
            if structured and item.get("has_image_index"):
                new_indexes = item.get("image_index", [])
                if normalize_image_indexes(
                        current.get("imageIndex")) != new_indexes:
                    current["imageIndex"] = new_indexes
                    changed += 1
        elif structured:
            replacement = {"text": text}
            if item.get("has_image_index"):
                replacement["imageIndex"] = item.get("image_index", [])
            if current != replacement:
                data[key] = replacement
                changed += 1
        elif current != text:
            data[key] = text
            changed += 1
        touched.append(key)
    return changed, touched


# ------------------------------------------------------------------
# route-shaped entry points (handlers at ``:447-601``)
# ------------------------------------------------------------------

def combined_files_state(root, batch_type="",
                         combined_json_file="") -> dict:
    """GET ``combined_files`` payload (``:447-463``)."""
    batch_type = normalize_batch_type(batch_type)
    names, folder = list_combined_files(root, batch_type)
    resolved, _error = resolve_combined_file(
        root, batch_type, combined_json_file, allow_auto_latest=True)
    return {"batch_type": batch_type, "files": names,
            "latest_folder": folder or "",
            "resolved_file": os.path.basename(resolved)
            if resolved else ""}


def combined_file_prompt_values(root, batch_type="",
                                combined_json_file="") -> dict:
    """GET ``combined_file_prompt_values`` payload (``:465-496``)."""
    batch_type = normalize_batch_type(batch_type)
    path, error = resolve_combined_file(root, batch_type,
                                        combined_json_file)
    if not path:
        raise ValueError(error or "Unable to resolve target file.")
    try:
        data = load_combined(path)
    except Exception as exc:  # noqa: BLE001 — parity error string
        raise ValueError(f"Failed to parse combined JSON: "
                         f"{type(exc).__name__}: {exc}") from exc
    rows = prompt_rows(data)
    return {"batch_type": batch_type, "file_path": path,
            "prompt_count": len(rows), "prompts": rows}


def update_combined_file_prompts(root, payload: dict) -> dict:
    """POST ``combined_file_update_prompts`` (``:499-569``): a no-op
    unless the UI is in remake mode; ``use_plain_text`` forces the
    Image2Video (plain-string) write shape onto any batch type."""
    def _flag(name):
        return str(payload.get(name, False)).strip().lower() \
            in ("1", "true", "yes", "on")  # ref _normalize_bool :1628

    batch_type = normalize_batch_type(payload.get("batch_type", ""))
    if not _flag("remake_mode"):
        return {"ignored": True, "updated": 0, "updated_keys": [],
                "file_path": "",
                "message": "Remake mode is disabled; update ignored."}
    updates = coerce_updates(payload.get("updates", []))
    if not updates:
        raise ValueError("No valid prompt updates were provided.")
    path, error = resolve_combined_file(
        root, batch_type, payload.get("combined_json_file", ""))
    if not path:
        raise ValueError(error or "Unable to resolve target file.")
    try:
        data = load_combined(path)
    except Exception as exc:  # noqa: BLE001 — parity error string
        raise ValueError(f"Failed to parse combined JSON: "
                         f"{type(exc).__name__}: {exc}") from exc
    write_type = "Image2Video" if _flag("use_plain_text") else batch_type
    changed, touched = apply_updates(data, updates,
                                     batch_type=write_type)
    write_combined(path, data)
    return {"ignored": False, "updated": changed,
            "updated_keys": touched, "file_path": path}


def remake_prompt_state(folder_path) -> dict:
    """POST ``remake_prompt_indexes`` payload (``:572-601``)."""
    indexes, error = remake_prompt_indexes(folder_path)
    if indexes is None:
        raise ValueError(error or "Unable to inspect remake folder.")
    folder, _error = resolve_remake_folder(folder_path)
    return {"folder_path": str(folder_path or ""),
            "remake_folder": folder or "",
            "prompt_count": len(indexes),
            "prompt_numbers": indexes,
            "empty": not indexes}
