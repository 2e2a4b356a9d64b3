"""LLM batch-run pipeline: batcher, output saver/combiner, splitter.

A copy of :mod:`vrgdg_tpu.runtime.llm_batches` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

Re-derivation of the reference's HuMo LLM batch plumbing
(``HumoAutomationExtra1.py``): the prompt batcher's
folder lifecycle and resume-by-file-scan (``:939-1390``), the output
saver's per-batch persistence and numbered combine (``:1392-1595``),
the prompt splitter's JSON hygiene + 16-slot flatten (``:770-919``),
and the story-mode chapter threading of the V3 prompt creator
(``:171-276``).

The ComfyUI graph glue stays out (PromptServer auto-queue events,
popup notifications, ``ExecutionBlocker`` gating): a standalone caller
drives the loop directly — :func:`plan_batch` → run the external LLM →
:func:`save_batch` → repeat until ``is_final`` → :func:`combine_batches`
→ :func:`split_prompt_json` per run.  The *file layout* is the
reference's, so a folder produced by either side is readable by the
other: ``llm_batches/Text2Image_Batch_NNN/`` run folders,
``<prefix>_NNN.txt`` batch files, ``<prefix>_COMBINED.json``, and the
splitter's ``prompt<i>.json`` / ``summary<i>.json`` pair.
"""

from __future__ import annotations

import json
import math
import os
import re

# reference :937 — the run-folder prefix is shared on-disk state
BATCH_FOLDER_PREFIX = "Text2Image_Batch_"

SPLITTER_SLOTS = 16

_SPLIT_ERROR_TEXT = (
    "invalid JSON prompt structure: the LLM output could not be "
    "parsed even after cleanup — regenerate and try again")


# ---------------------------------------------------------------------------
# LLM-output JSON hygiene (reference :794-826 and :1439-1489)
# ---------------------------------------------------------------------------

# ordered repair pipeline for near-JSON prompt payloads; each row is
# (pattern, replacement, flags).  The *effects* mirror the reference's
# cleaner: fence removal, smart-quote normalization, promptN key
# repair (a stray symbol before `promptN":` is consumed by the opening
# quote, reference :809), bare-key quoting, trailing-comma removal,
# control-character collapse.
_REPAIRS = (
    (r"^```(json)?", "", re.IGNORECASE),
    (r"```$", "", re.MULTILINE),
    (r'([^\w"])(prompt\d+)":', r'"\2":', 0),
    (r'(?<!")(\bprompt\d+\b)(?=\s*:)', r'"\1"', 0),
    (r",(\s*[}\]])", r"\1", 0),
    (r"[\x00-\x1f]+", " ", 0),
)

_SMART_QUOTES = str.maketrans({"“": '"', "”": '"',
                               "‘": "'", "’": "'"})

# invisible characters scrubbed before any JSON scan (reference
# :1455): BOM and zero-width space
_INVISIBLES = str.maketrans({"\ufeff": None, "\u200b": None})

_FENCED_JSON = re.compile(r"```(?:json)?\s*(\{.*?\}|\[.*?\])\s*```",
                          re.DOTALL | re.IGNORECASE)


def clean_prompt_json(text: str) -> str:
    """Repair common LLM JSON-output damage (reference :794-826).

    Order matters and is part of the behavior: fences first (so the
    brace-closure step sees the payload), key repairs before comma
    cleanup, control characters last, then brace closure on the
    stripped view.
    """
    out = str(text).strip()
    for index, (pattern, repl, flags) in enumerate(_REPAIRS):
        if index == 2:  # quotes normalized between fence and key steps
            out = out.translate(_SMART_QUOTES)
        if index < 2:
            out = out.strip()
        out = re.sub(pattern, repl, out, flags=flags)
    if not out.strip().startswith("{"):
        out = "{" + out
    if not out.strip().endswith("}"):
        out = out.rstrip(",") + "}"
    return out.strip()


def extract_json_block(text, label: str = "(text)") -> str:
    """Pull the JSON object/array out of surrounding LLM chatter
    (reference :1439-1489): fenced block first, then a widest
    first-opener/last-closer brace scan."""
    if text is None:
        raise ValueError(f"{label}: text is None")
    cleaned = str(text).translate(_INVISIBLES).strip()
    fenced = _FENCED_JSON.search(cleaned)
    if fenced:
        return fenced.group(1).strip()
    openers = [pos for pos in (cleaned.find("{"), cleaned.find("["))
               if pos != -1]
    if not openers:
        raise ValueError(f"{label}: no JSON opener found")
    start = min(openers)
    end = max(cleaned.rfind("}"), cleaned.rfind("]"))
    if end <= start:
        raise ValueError(f"{label}: no JSON closer after opener")
    return cleaned[start:end + 1].strip()


def _trailing_number(key) -> int:
    """Numeric sort key for ``prompt12``-style names (reference
    :1491-1495); names without a trailing number sort last, stably."""
    digits = re.search(r"(\d+)$", str(key))
    return int(digits.group(1)) if digits else 10 ** 9


# ---------------------------------------------------------------------------
# Prompt splitter (reference :770-919)
# ---------------------------------------------------------------------------

def _flatten_prompt_value(value) -> str:
    """One prompt slot from one JSON value (reference :881-898):
    mappings and lists collapse to their scalar members joined by
    spaces; scalars stringify; anything else yields an empty slot."""
    if isinstance(value, dict):
        members = value.values()
    elif isinstance(value, list):
        members = value
    elif isinstance(value, (str, int, float)):
        return str(value).strip()
    else:
        return ""
    return " ".join(str(item) for item in members
                    if isinstance(item, (str, int, float))).strip()


def split_prompt_json(prompt_text, folder: str | None = None,
                      index: int = 0,
                      slots: int = SPLITTER_SLOTS) -> dict:
    """Clean + parse one LLM run's JSON and fan it out into fixed
    prompt slots plus the story summary (reference :828-919).

    Returns ``{ok, prompts, summary, error, saved}``; ``prompts`` is
    always exactly ``slots`` strings.  On unparseable input every slot
    carries the same error text (the reference's downstream nodes rely
    on the error flooding all outputs).  When ``folder`` is given the
    cleaned JSON persists as ``prompt<index>.json`` and a present
    summary as ``summary<index>.json``; save failures are non-fatal.
    """
    saved: list[str] = []
    try:
        data = json.loads(clean_prompt_json(prompt_text))
        if not isinstance(data, dict):
            raise ValueError("JSON root must be an object")
    except Exception as exc:
        return {"ok": False, "error": f"{_SPLIT_ERROR_TEXT} ({exc})",
                "prompts": [_SPLIT_ERROR_TEXT] * slots,
                "summary": _SPLIT_ERROR_TEXT, "saved": saved}

    def _persist(name: str, payload) -> None:
        if not folder:
            return
        try:
            os.makedirs(folder, exist_ok=True)
            path = os.path.join(folder, name)
            with open(path, "w", encoding="utf-8") as handle:
                json.dump(payload, handle, indent=2)
            saved.append(path)
        except OSError:
            pass

    _persist(f"prompt{index}.json", data)
    summary_data = data.get("summary")
    summary_text = json.dumps(summary_data, indent=2) if summary_data \
        else ""
    if summary_data:
        _persist(f"summary{index}.json", summary_data)

    parts = [_flatten_prompt_value(value) for key, value in data.items()
             if not str(key).startswith("summary")]
    prompts = (parts + [""] * slots)[:slots]
    return {"ok": True, "error": "", "prompts": prompts,
            "summary": summary_text, "saved": saved}


# ---------------------------------------------------------------------------
# Batch-run folder lifecycle (reference :1032-1106, :1153-1164)
# ---------------------------------------------------------------------------

def latest_batch_folder(root: str) -> str | None:
    """Highest-numbered ``Text2Image_Batch_NNN`` run folder under
    ``root`` (reference :1053-1075)."""
    if not os.path.isdir(root):
        return None
    best_num, best_path = -1, None
    for name in os.listdir(root):
        path = os.path.join(root, name)
        suffix = name[len(BATCH_FOLDER_PREFIX):]
        if (os.path.isdir(path) and name.startswith(BATCH_FOLDER_PREFIX)
                and suffix.isdigit() and int(suffix) > best_num):
            best_num, best_path = int(suffix), path
    return best_path


def _batch_files(folder: str, prefix: str) -> list[str]:
    """Per-batch text files, sorted, combined output excluded
    (reference :1431-1437)."""
    return sorted(name for name in os.listdir(folder)
                  if name.startswith(prefix + "_")
                  and name.lower().endswith(".txt")
                  and "COMBINED" not in name)


def is_unfinished_batch_folder(folder: str, prefix: str) -> bool:
    """A run folder with batch files but no combined output yet
    (reference :1077-1094) — the resume target."""
    if not os.path.isdir(folder):
        return False
    if os.path.isfile(os.path.join(folder, f"{prefix}_COMBINED.json")):
        return False
    return bool(_batch_files(folder, prefix))


def create_next_batch_folder(root: str) -> str:
    """First free ``Text2Image_Batch_NNN`` slot (reference
    :1096-1105)."""
    os.makedirs(root, exist_ok=True)
    number = 1
    while True:
        candidate = os.path.join(
            root, f"{BATCH_FOLDER_PREFIX}{number:03d}")
        if not os.path.exists(candidate):
            os.makedirs(candidate, exist_ok=True)
            return candidate
        number += 1


def next_batch_index(folder: str, prefix: str) -> int:
    """Resume point: one past the highest ``<prefix>_<n>.txt`` already
    on disk (reference :1226-1253)."""
    highest = -1
    if os.path.isdir(folder):
        for name in _batch_files(folder, prefix):
            stem = name[len(prefix) + 1:-len(".txt")]
            if stem.isdigit():
                highest = max(highest, int(stem))
    return highest + 1


# ---------------------------------------------------------------------------
# Batch planning + prompt assembly (reference :1137-1390)
# ---------------------------------------------------------------------------

def _normalize_story_groups(story_groups):
    if isinstance(story_groups, dict):
        groups = story_groups.get("groups")
        if not isinstance(groups, list):
            raise ValueError(
                "story groups: expected a dict with a 'groups' list")
        return groups
    return story_groups


def _normalize_lyrics(lyric_segments):
    if lyric_segments is None:
        return []
    if isinstance(lyric_segments, dict):
        return [{"id": key, "text": value}
                for key, value in lyric_segments.items()]
    return lyric_segments


def build_batch_prompt(story_summary: str, story_batch: list,
                       lyrics_batch: list, batch_index: int,
                       total_batches: int) -> str:
    """The text block handed to the external LLM for one batch
    (reference :1302-1340).  The layout is on-the-wire contract: the
    reference's downstream LLM templates key off the ``story`` /
    ``lyrics`` framing, so it is reproduced exactly."""
    group_lines = "".join(
        "    " + json.dumps(group, ensure_ascii=False)
        + ("," if pos < len(story_batch) - 1 else "") + "\n"
        for pos, group in enumerate(story_batch))
    lyric_lines = "".join(
        f'  "{segment["id"]}": '
        + json.dumps(segment["text"], ensure_ascii=False)
        + ("," if pos < len(lyrics_batch) - 1 else "") + "\n"
        for pos, segment in enumerate(lyrics_batch))
    summary_json = json.dumps(str(story_summary).strip(),
                              ensure_ascii=False)
    return (f"Here is batch {batch_index + 1} of {total_batches} "
            "batches.\n\n"
            "story\n{\n"
            f'  "story_summary": {summary_json},\n'
            '  "groups": [\n' + group_lines + "  ]\n}\n\n"
            "lyrics\n{\n" + lyric_lines + "}\n\n"
            f"Please send all {len(story_batch)} prompts in the json "
            "code block now.\n")


def plan_batch(root: str, story_groups, story_summary: str,
               batch_size: int = 10, file_prefix: str = "Scene",
               manual_index: int = -1, lyric_segments=None) -> dict:
    """Plan the next LLM batch run (reference ``run`` :1137-1390 minus
    the ComfyUI queue/popup glue).

    Resolves the run folder (reuse the latest unfinished one, else
    open the next numbered slot), derives the batch index from files
    already on disk (or honors ``manual_index``), slices the story
    groups/lyrics, and assembles the prompt text.  Drive the loop:
    call, send ``prompt`` to the LLM, :func:`save_batch` the reply,
    repeat until ``is_final``.
    """
    groups = _normalize_story_groups(story_groups)
    lyrics = _normalize_lyrics(lyric_segments)
    if lyrics and len(lyrics) != len(groups):
        raise ValueError(f"lyric/story count mismatch: {len(lyrics)} "
                         f"lyrics vs {len(groups)} story groups")

    os.makedirs(root, exist_ok=True)
    resume = latest_batch_folder(root)
    if resume and is_unfinished_batch_folder(resume, file_prefix):
        folder, resumed = resume, True
    else:
        folder, resumed = create_next_batch_folder(root), False

    manual = manual_index >= 0
    batch_index = manual_index if manual \
        else next_batch_index(folder, file_prefix)
    total_batches = math.ceil(len(groups) / batch_size)
    is_final = batch_index + 1 >= total_batches

    def _slice(items):
        return items[batch_index * batch_size:
                     (batch_index + 1) * batch_size]

    story_batch = _slice(groups)
    prompt = build_batch_prompt(story_summary, story_batch,
                                _slice(lyrics) if lyrics else [],
                                batch_index, total_batches)
    if total_batches <= 1:
        note = "single batch — running now"
    elif is_final:
        note = f"final batch ({batch_index + 1} of {total_batches})"
    else:
        note = f"batch {batch_index + 1} of {total_batches}"
    return {"prompt": prompt, "batch_index": batch_index,
            "total_batches": total_batches, "is_final": is_final,
            "folder": folder, "file_prefix": file_prefix,
            "resumed": resumed, "manual": manual,
            "batch_count": len(story_batch), "note": note}


# ---------------------------------------------------------------------------
# Output saving + combine (reference :1499-1595)
# ---------------------------------------------------------------------------

def save_batch(folder: str, file_prefix: str, batch_index: int,
               text: str) -> str:
    """Persist one LLM reply as ``<prefix>_NNN.txt`` (reference
    :1520-1530)."""
    folder = os.path.normpath(folder)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{file_prefix}_{batch_index:03d}.txt")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(text)
    return path


def combine_batches(folder: str, file_prefix: str) -> dict:
    """Merge every batch file's JSON into one renumbered
    ``prompt1..N`` object and write ``<prefix>_COMBINED.json``
    (reference :1540-1592).

    Within each file, keys are ordered by their trailing number (so
    ``prompt2`` precedes ``prompt10``); across files, lexical filename
    order preserves batch order — renumbering is global and gapless.
    """
    files = _batch_files(folder, file_prefix)
    combined: dict[str, object] = {}
    position = 1
    for name in files:
        with open(os.path.join(folder, name), "r",
                  encoding="utf-8") as handle:
            payload = json.loads(extract_json_block(handle.read(),
                                                    label=name))
        if not isinstance(payload, dict):
            raise ValueError(f"{name}: combined batch JSON must be an "
                             f"object, got {type(payload).__name__}")
        for key in sorted(payload, key=_trailing_number):
            combined[f"prompt{position}"] = payload[key]
            position += 1
    path = os.path.join(folder, f"{file_prefix}_COMBINED.json")
    text = json.dumps(combined, ensure_ascii=False, indent=2)
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(text)
    return {"combined": combined, "text": text, "path": path,
            "files": files, "count": position - 1}


# ---------------------------------------------------------------------------
# Story-mode chapter threading (reference :171-276)
# ---------------------------------------------------------------------------

_SUMMARY_FIELDS = ("scene_summary", "character_arc",
                   "narrative_thread", "next_scene_suggestion")


def story_chapter_state(song_theme_style: str,
                        summary_folder: str = "",
                        summary_index: int = 0,
                        total_sets: int = 1,
                        groups_in_last_set: int = 16) -> dict:
    """Thread one chapter of a multi-run story (reference :171-276).

    Chapter ``i > 0`` loads the previous run's ``summary<i-1>.json``
    and replaces the theme with its four narrative fields; the final
    chapter swaps the 16-prompt default for ``groups_in_last_set`` and
    stops requesting a summary block from the LLM.  The instruction
    *prose* around this state is authored LLM copy and stays
    first-party (see ``api/instructions.py`` for the policy).
    """
    theme = str(song_theme_style)
    summary_data: dict = {}
    if summary_index > 0 and summary_folder \
            and os.path.isdir(summary_folder):
        path = os.path.join(summary_folder,
                            f"summary{summary_index - 1}.json")
        if os.path.isfile(path):
            try:
                with open(path, "r", encoding="utf-8") as handle:
                    summary_data = json.load(handle)
            except (OSError, ValueError) as exc:
                theme += f"\n(Note: failed to read summary file: {exc})"

    if summary_data:
        theme = "\n".join(
            f"{field}: {summary_data.get(field, '')}"
            for field in _SUMMARY_FIELDS).strip()
        theme += (f"\n\nSTORY CONTEXT: chapter {summary_index + 1} of "
                  f"{total_sets}; the lines above summarize the "
                  "previous chapter — continue the story visually and "
                  "emotionally without repeating it.")
    elif not theme.strip():
        theme = ("(derive a suitable cinematic theme and tone based "
                 "on the lyrical content)")

    is_final = summary_index >= total_sets - 1
    if is_final:
        try:
            prompts_this_run = int(groups_in_last_set)
        except (TypeError, ValueError):
            prompts_this_run = 16
        theme += (f"\n\nFINAL CHAPTER: generate exactly "
                  f"{prompts_this_run} prompts and give the last one "
                  "emotional and visual closure.")
    else:
        prompts_this_run = 16

    return {"theme": theme, "summary_loaded": bool(summary_data),
            "summary_data": summary_data, "is_final": is_final,
            "wants_summary_block": not is_final,
            "prompts_this_run": prompts_this_run}
