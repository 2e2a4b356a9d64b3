"""Prompt chunking, indexed prompt selection, and run-index state.

A copy of :mod:`vrgdg_tpu.runtime.text_tools` (which cannot be imported
without JAX): every function keeps its original's source.

The reference drives multi-scene renders by slicing a big prompt string
into per-scene chunks and by persisting a run index between queue
submissions. These are the pure-function equivalents:

- pipe-separated chunking with the reference's fixed stride of 16
  (nodes.py:1381-1423, VRGDG_IndexedPromptChunker)
- quoted-prompt chunking that strides by ``scene_count`` and errors on
  shortfall (nodes.py:1431-1489, ...ChunkerV2)
- JSON prompt-list selection returning (text, image_index)
  (GeneralVideoNodes.py:2848-2915,
  VRGDG_PromptSplitterWithIndex)
- JSON-file run-index state with reset/increment semantics
  (nodes.py:1494-1560, VRGDG_PostRunIndexStepper)
- append-only JSONL run-state log
  (GeneralVideoNodes2.py:1082-1136,
  VRGDG_RunStateLogger_SRT)
"""

from __future__ import annotations

import json
import os
import re
from datetime import datetime


def chunk_pipe_prompts(prompt_text: str, scene_count: int = 16,
                       index: int = 0, total_sets: int = 1) -> list[str]:
    """Slice a ``|``-separated prompt string into one scene chunk.

    The window starts at ``index * 16`` regardless of ``scene_count`` —
    a reference quirk preserved for workflow parity (nodes.py:1417) —
    and spans ``scene_count`` entries, padding with "" past the end.
    ``index >= total_sets`` yields an all-empty chunk.
    """
    scene_count = max(1, min(50, int(scene_count)))
    if index >= total_sets:
        return [""] * scene_count
    parts = [p.strip() for p in prompt_text.strip().split("|") if p.strip()]
    start = index * 16
    return [parts[i] if i < len(parts) else ""
            for i in range(start, start + scene_count)]


def chunk_quoted_prompts(prompt_text: str, scene_count: int = 16,
                         index: int = 0) -> list[str]:
    """Slice double-quoted prompts (``prompt 3: "..."`` style) by chunks
    of ``scene_count``, raising when the window is not fully covered —
    the V2 contract (nodes.py:1466-1485).
    """
    scene_count = max(1, min(50, int(scene_count)))
    parts = re.findall(r'"(.*?)"', prompt_text, re.DOTALL)
    start = index * scene_count
    end = start + scene_count
    if len(parts) < end:
        raise ValueError(
            f"Not enough prompts for index={index} with "
            f"scene_count={scene_count}: need {end}, have {len(parts)}")
    return parts[start:end]


def _digit_sort_keys(data: dict) -> list:
    """Dict keys ordered by their embedded digits (non-numeric first)."""
    def key(name: str) -> int:
        digits = "".join(ch for ch in str(name) if ch.isdigit())
        return int(digits) if digits else 0

    return sorted(data.keys(), key=key)


def _image_index_str(value) -> str:
    """Normalize an imageIndex payload (int, str, or list) to a
    comma-separated string, defaulting to "0"
    (GeneralVideoNodes.py:2866-2880)."""
    if value is None:
        return "0"
    if isinstance(value, list):
        parts = []
        for item in value:
            try:
                parts.append(str(int(item)))
            except (TypeError, ValueError):
                continue
        return ",".join(parts) if parts else "0"
    try:
        return str(int(value))
    except (TypeError, ValueError):
        text = str(value).strip()
        return text if text else "0"


def select_prompt(json_source: str | list | dict, index: int
                  ) -> tuple[str, str]:
    """Pick prompt ``index`` (wrapping) from a JSON list/dict of prompts.

    Supports the new ``{"text": ..., "imageIndex": [...]}`` entry format
    and plain strings; malformed JSON degrades to ``("", "0")`` like the
    reference (GeneralVideoNodes.py:2882-2915).
    """
    try:
        data = (json.loads(json_source) if isinstance(json_source, str)
                else json_source)
        if isinstance(data, dict):
            prompts = [data[k] for k in _digit_sort_keys(data)]
        elif isinstance(data, list):
            prompts = list(data)
        else:
            prompts = []
        if not prompts:
            return "", "0"
        picked = prompts[index % len(prompts)]
        if isinstance(picked, dict):
            return (str(picked.get("text", "")),
                    _image_index_str(picked.get("imageIndex")))
        return str(picked), "0"
    except (json.JSONDecodeError, TypeError, ValueError):
        return "", "0"


def read_run_index(state_path: str) -> int:
    """Current persisted run index, 0 when the file is absent/invalid."""
    try:
        with open(state_path, encoding="utf-8") as fh:
            return int(json.load(fh).get("index", 0))
    except (OSError, ValueError, json.JSONDecodeError, AttributeError):
        return 0


def step_run_index(state_path: str, reset: bool = False,
                   increment: bool = True) -> tuple[int, int]:
    """Advance the persisted run index.

    Returns ``(current_index, next_index)`` where ``current_index`` is
    what this run should use (0 after a reset) and ``next_index`` is what
    was persisted for the following run (nodes.py:1514-1552).
    """
    index = read_run_index(state_path)
    current = 0 if reset else index
    nxt = 0 if reset else (index + 1 if increment else index)
    tmp = state_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"index": nxt}, fh)
    os.replace(tmp, state_path)
    return current, nxt


def log_run_state(output_folder: str, index: int, total_sets: int,
                  trigger=None, note: str = "",
                  timestamp: str | None = None) -> str:
    """Append one JSONL record to ``<folder>/vrgdg_temp/srt_run_state.jsonl``
    and return the log path (GeneralVideoNodes2.py:1110-1136).

    ``timestamp`` is injectable for deterministic tests; non-serializable
    triggers are recorded via ``repr``.
    """
    state_dir = os.path.join(output_folder, "vrgdg_temp")
    os.makedirs(state_dir, exist_ok=True)
    log_path = os.path.join(state_dir, "srt_run_state.jsonl")
    try:
        json.dumps(trigger)
    except (TypeError, ValueError):
        trigger = repr(trigger)
    entry = {
        "timestamp": timestamp or datetime.now().strftime(
            "%Y-%m-%d %H:%M:%S"),
        "index": int(index),
        "total_sets": int(total_sets),
        "output_folder": output_folder,
        "trigger": trigger,
    }
    if note:
        entry["note"] = note
    with open(log_path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(entry, ensure_ascii=True) + "\n")
    return log_path


# ---------------------------------------------------------------------------
# Storyboard-run bookkeeping (numbered output folders)
# ---------------------------------------------------------------------------
# The reference's storyboard runner tracks progress by the leading number
# of files already rendered into the output folder and supports redo
# passes with per-scene prompt overrides
# (GeneralVideoNodes2.py:1250-1378).

def next_output_index(folder: str) -> int:
    """1-based index of the next scene to render: one past the highest
    leading file number in ``folder`` (1 when the folder is absent or
    holds no numbered files) — GeneralVideoNodes2.py:1252-1268."""
    if not os.path.isdir(folder):
        return 1
    indices = []
    for name in os.listdir(folder):
        match = re.match(r"^(\d+)", name)
        if match:
            indices.append(int(match.group(1)))
    return max(indices) + 1 if indices else 1


def parse_redo_indexes(text) -> list[int]:
    """Positive scene numbers from comma/whitespace-separated text,
    order-preserving and deduplicated (GeneralVideoNodes2.py:1270-1294)."""
    seen: set[int] = set()
    ordered: list[int] = []
    for part in re.split(r"[,\s]+", str(text or "").strip()):
        try:
            value = int(part)
        except ValueError:
            continue
        if value > 0 and value not in seen:
            ordered.append(value)
            seen.add(value)
    return ordered


def parse_override_blocks(text) -> list[str]:
    """Blank-line-separated prompt override blocks, stripped and with
    empty blocks dropped (GeneralVideoNodes2.py:1296-1301)."""
    raw = str(text or "").strip()
    if not raw:
        return []
    return [block.strip() for block in re.split(r"\n\s*\n", raw)
            if block.strip()]


def backup_numbered_files(folder: str, index: int,
                          backup_name: str = "backup",
                          timestamp: str | None = None) -> list[str]:
    """Move every file whose leading number equals ``index`` into
    ``<folder>/<backup_name>/`` with an ``_old`` suffix, timestamping on
    collision; returns the new paths (GeneralVideoNodes2.py:1327-1355).
    ``timestamp`` is injectable for deterministic tests."""
    if not os.path.isdir(folder):
        return []
    backup_dir = os.path.join(folder, backup_name)
    os.makedirs(backup_dir, exist_ok=True)
    moved: list[str] = []
    for name in sorted(os.listdir(folder)):
        source = os.path.join(folder, name)
        if not os.path.isfile(source):
            continue
        match = re.match(r"^(\d+)", name)
        if not match or int(match.group(1)) != int(index):
            continue
        stem, ext = os.path.splitext(name)
        target = os.path.join(backup_dir, f"{stem}_old{ext}")
        if os.path.exists(target):
            stamp = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
            target = os.path.join(backup_dir, f"{stem}_old_{stamp}{ext}")
        os.replace(source, target)
        moved.append(target)
    return moved


# --------------------------------------------------------------------------
# LLM prompt-output sanitizer (VRGDG_GemmaPromptSanitizer.py:1-105)
# --------------------------------------------------------------------------

# value keys that may carry the actual prompt text, tried in priority
# order (:5-15)
_PROMPT_VALUE_KEYS = ("image_prompt", "t2i_prompt",
                      "text_to_image_prompt", "prompt", "flux_prompt",
                      "nb_prompt", "nano_banana_prompt", "ernie_prompt",
                      "enhance_prompt")
_SCENE_LIST_KEYS = ("scenes", "prompts", "items", "results")


def _strip_llm_wrappers(text: str) -> str:
    """Remove role/thought prefixes and markdown fences from raw LLM
    output (:18-29)."""
    cleaned = str(text or "").strip()
    cleaned = re.sub(
        r"^\s*[^A-Za-z0-9]*(?:(?:user|assistant|model)\b)?[^A-Za-z0-9]*"
        r"(?:thought|analysis|reasoning)(?=[A-Z]|[^A-Za-z0-9]|$)"
        r"[^A-Za-z0-9]*",
        "", cleaned, flags=re.IGNORECASE).strip()
    cleaned = re.sub(r"^```(?:json)?\s*", "", cleaned,
                     flags=re.IGNORECASE)
    return re.sub(r"\s*```$", "", cleaned).strip()


def _first_number(value):
    match = re.search(r"\d+", str(value)) if value is not None else None
    if match and int(match.group(0)) > 0:
        return int(match.group(0))
    return None


def _prompt_values(value):
    """Depth-first prompt-text candidates in key-priority order (:56-66)."""
    if isinstance(value, dict):
        for key in _PROMPT_VALUE_KEYS:
            text = str(value.get(key) or "").strip()
            if text:
                yield text
        for child in value.values():
            yield from _prompt_values(child)
    elif isinstance(value, list):
        for item in value:
            yield from _prompt_values(item)


def extract_prompt_text(text, scene_number=None) -> str:
    """Best prompt string out of raw LLM output: JSON-parse the cleaned
    text (or its bracket slice), prefer the item matching
    ``scene_number``, else the first prompt value anywhere; fall back
    to the cleaned text itself (:91-105)."""
    cleaned = _strip_llm_wrappers(text)
    if not cleaned:
        return cleaned
    target = _first_number(scene_number)

    candidates = [cleaned]
    starts = [index for index in (cleaned.find("{"), cleaned.find("["))
              if index >= 0]
    if starts:
        end = max(cleaned.rfind("}"), cleaned.rfind("]"))
        if end > min(starts):
            candidates.append(cleaned[min(starts):end + 1])

    for candidate in candidates:
        try:
            parsed = json.loads(candidate)
        except ValueError:
            continue
        if isinstance(parsed, list):
            items = [item for item in parsed if isinstance(item, dict)]
        elif isinstance(parsed, dict):
            items = next(
                ([item for item in parsed[key]
                  if isinstance(item, dict)]
                 for key in _SCENE_LIST_KEYS
                 if isinstance(parsed.get(key), list)), [parsed])
        else:
            items = []
        if target:
            matched = [item for item in items if _first_number(
                item.get("scene_number") or item.get("sceneNumber")
                or item.get("scene") or item.get("number")) == target]
            items = matched or items
        for item in items:
            for prompt in _prompt_values(item):
                return prompt
        for prompt in _prompt_values(parsed):
            return prompt
    return cleaned


# --------------------------------------------------------------------------
# LLM output hygiene (VRGDG_VideoEditorNodes.py:414-522)
# --------------------------------------------------------------------------

# loop markers the reference's detector knows (alphabetical; membership
# only, so ordering is free — the strings themselves are the behavior)
_REPEAT_MARKERS = frozenset({
    "<|channel>", "<channel|>", "cast-cast-cast",
    "completion-completion-completion", "de-facto-de-facto-de-facto",
    "de-fleshed", "end_anow", "nessnessnessness",
    "ownnessownnessownness", "prompt-cast-cast",
    "thought-thought-thought", "thoughtthoughtthought",
    "thought_turn", "turn_turn",
})

_COMMON_WORDS = frozenset({"the", "and", "with", "that", "this",
                           "from", "into", "while", "during"})


def _max_count(items):
    counts: dict = {}
    for item in items:
        counts[item] = counts.get(item, 0) + 1
    return max(counts.values()) if counts else 0


def looks_like_llm_repeat_failure(text) -> bool:
    """Degenerate repeated/looping LLM output detector (``:414-480``):
    known loop markers, character-level repeats, and token/phrase
    frequency heuristics (thresholds are the reference's)."""
    sample = re.sub(r"\s+", " ", str(text or "").lower()).strip()
    if not sample:
        return False
    compact = re.sub(r"[^a-z0-9_<>\-|]+", "", sample)
    if any(marker in compact or marker in sample
           for marker in _REPEAT_MARKERS):
        return True
    if re.search(r"([a-z]{2,16})\1{5,}", compact) \
            or re.search(r"\b([a-zA-Z_]{3,})(?:[-\s]+\1){5,}\b",
                         sample):
        return True

    tokens = [token.strip("_'") for token
              in re.findall(r"[\w']+", sample, flags=re.UNICODE)
              if token.strip("_'")]
    if len(tokens) >= 16:
        top = _max_count(tokens)
        if top >= 10 and top / float(len(tokens)) >= 0.20:
            return True
        for size in (2, 3, 4):
            if len(tokens) >= size * 4 and _max_count(
                    " ".join(tokens[index:index + size])
                    for index in range(len(tokens) - size + 1)) >= 8:
                return True

    words = re.findall(r"[a-zA-Z_][a-zA-Z_']{2,}", sample)
    if len(words) < 18:
        return False
    top_word = _max_count(word for word in words
                          if word not in _COMMON_WORDS)
    if top_word >= 10 and top_word / float(len(words)) >= 0.25:
        return True
    phrases = [" ".join(pair) for pair in zip(words, words[1:])]
    return len(phrases) >= 12 and _max_count(phrases) >= 6


# chat-template control tokens to scrub, precompiled; the pattern
# strings are the behavioral contract, expressed via the shared
# _THOUGHT fragment
_THOUGHT = r"(?:thought|analysis|reasoning)"
_CHAT_CONTROL_RES = tuple(
    re.compile(pattern, re.IGNORECASE | re.DOTALL) for pattern in (
        rf"^\s*_?(?:user|assistant|model)?_?\s*{_THOUGHT}\s*[:=\-]?\s*",
        r"^\s*_?(?:start_of_)?turn\s*",
        r"^\s*<\|?start_of_turn\|?>\s*(?:model|assistant)?\s*",
        r"\s*<\|?end_of_turn\|?>\s*",
        rf"_?\s*<\|channel>\s*{_THOUGHT}?\s*",
        rf"_?\s*<\|?channel\|?>\s*{_THOUGHT}?\s*",
        rf"_?\s*<channel\|>\s*{_THOUGHT}?\s*",
        r"^\s*<?/?end[_\-][a-z0-9_\-]*>?\s*",
        r"^\s*_?name\s*[:=]\s*",
        rf"^\s*\d+\s*{_THOUGHT}\s*[:\-]?\s*",
        rf"^\s*[-_]*\s*{_THOUGHT}\s*",
        rf"^\s*{_THOUGHT}\s*[:\-]?\s*",
    ))
_ROLE_PREFIX_RE = re.compile(
    r"^(?:Assistant|Answer|Final prompt)\s*:\s*", re.IGNORECASE)
_THINK_BLOCK_RE = re.compile(r"<think>.*?</think>",
                             re.IGNORECASE | re.DOTALL)


def clean_llm_chat_text(text) -> str:
    """Strip chat-template control tokens / think blocks / role labels
    until stable, then keep the first paragraph (``:492-522``)."""
    cleaned = _THINK_BLOCK_RE.sub("", str(text or "").strip()).strip()
    cleaned = _ROLE_PREFIX_RE.sub("", cleaned).strip()
    previous = None
    while cleaned and previous != cleaned:
        previous = cleaned
        for pattern in _CHAT_CONTROL_RES:
            cleaned = pattern.sub("", cleaned).strip()
    cleaned = _ROLE_PREFIX_RE.sub("", cleaned).strip()
    paragraphs = [part.strip()
                  for part in re.split(r"\n\s*\n", cleaned)
                  if part.strip()]
    return paragraphs[0] if paragraphs else cleaned


# --------------------------------------------------------------------------
# Prompt-group parsing (VRGDG_GeneralPromptBatcher, VRGDG_GeneralNodes.py
# :607-1035): turn messy LLM output — JSON with a "groups" array,
# near-JSON, numbered plain text — into an {index: text} mapping, plus
# the batch-prompt assembly. The ComfyUI auto-queue/popup driver around
# it stays out of scope; these are the deterministic text math.
# --------------------------------------------------------------------------

_GROUP_INDEX_RE = re.compile(
    r'(?i)^\s*["\']?(?:lyricsegment|prompt|segment|group|index)'
    r'\s*[_#:\-\s]*([0-9]+)')
_LINE_GROUP_RE = re.compile(r"^\s*#?\s*([0-9]+)\s*[:.)-]\s*")
_GROUPS_KEY_RE = re.compile(r'(?i)"groups"\s*:\s*\[')
_NEAR_JSON_INDEX_RE = re.compile(r'(?i)"index"\s*:\s*([0-9]+)')
_JSON_NOISE_LINES = frozenset(("[", "]", "{", "}", "],", "},"))


def group_index_of(text, loose: bool = False):
    """Leading group index of a label like ``prompt_3`` / ``Segment #2``
    (``:716-731``); ``loose`` also accepts any bare number."""
    if text is None:
        return None
    match = _GROUP_INDEX_RE.search(str(text))
    if match:
        return int(match.group(1))
    if loose:
        match = re.search(r"\b([0-9]+)\b", str(text))
        if match:
            return int(match.group(1))
    return None


def _index_from_record(record: dict):
    for key in ("index", "id", "name"):
        found = group_index_of(record.get(key), loose=True)
        if found is not None:
            return found
    return None


def _groups_from_json(data) -> dict:
    """Decoded JSON -> {index: rendered text} (``:733-779``)."""
    if isinstance(data, list):
        out = {}
        for position, item in enumerate(data, start=1):
            if isinstance(item, dict):
                index = _index_from_record(item)
                out[position if index is None else index] = json.dumps(
                    item, ensure_ascii=False, indent=2)
            else:
                out[position] = str(item).strip()
        return {key: value for key, value in out.items() if value}
    if isinstance(data, dict):
        for key in ("groups", "items", "prompts", "segments", "lines"):
            if isinstance(data.get(key), list):
                return _groups_from_json(data[key])
        out = {}
        cursor = 1
        for key, value in data.items():
            index = group_index_of(key, loose=True)
            if index is None and isinstance(value, dict):
                index = _index_from_record(value)
            if index is None:
                while cursor in out:
                    cursor += 1
                index = cursor
            rendered = (json.dumps(value, ensure_ascii=False, indent=2)
                        if isinstance(value, (dict, list))
                        else str(value).strip())
            if rendered:
                out[index] = rendered
        return out
    return {}


def _balanced_span(text: str, start: int, open_ch: str,
                   close_ch: str) -> int:
    """End index (exclusive) of the bracketed span opening at ``start``,
    honoring JSON string escapes; -1 when unterminated."""
    depth = 0
    mode = "code"  # "code" | "string" | "escape"
    for position in range(start, len(text)):
        ch = text[position]
        if mode == "escape":
            mode = "string"
        elif mode == "string":
            mode = ("escape" if ch == "\\"
                    else "code" if ch == '"' else "string")
        elif ch == '"':
            mode = "string"
        elif ch == open_ch:
            depth += 1
        elif ch == close_ch:
            depth -= 1
            if depth == 0:
                return position + 1
    return -1


def _groups_array_text(text: str):
    """The balanced ``[...]`` following a ``"groups":`` key (``:837-871``);
    an unterminated array returns the tail."""
    match = _GROUPS_KEY_RE.search(text)
    if not match:
        return None
    start = text.find("[", match.start())
    if start < 0:
        return None
    end = _balanced_span(text, start, "[", "]")
    return text[start:end] if end > 0 else text[start:]


def _groups_from_near_json(groups_text: str) -> dict:
    """Top-level ``{...}`` objects inside a groups-array text that fails
    strict JSON (``:873-935``): decode each object alone, or fall back to
    its raw text with a regex'd index."""
    out = {}
    cursor = 0
    fallback_seq = 1
    while True:
        start = groups_text.find("{", cursor)
        if start < 0:
            break
        end = _balanced_span(groups_text, start, "{", "}")
        if end < 0:
            break
        raw = groups_text[start:end]
        cursor = end
        try:
            obj = json.loads(raw)
            index = group_index_of(obj.get("index"), loose=True)
            rendered = json.dumps(obj, ensure_ascii=False, indent=2)
        except Exception:
            match = _NEAR_JSON_INDEX_RE.search(raw)
            index = int(match.group(1)) if match else None
            rendered = raw.strip()
        if rendered:
            out[fallback_seq if index is None else index] = rendered
            fallback_seq += 1
    return out


def _groups_from_plain_text(text: str) -> dict:
    """Numbered plain text -> groups (``:797-835``): explicit labels or
    line-leading numbers open a group and collect following lines; with
    no numbering, blank-line blocks (or single lines) are enumerated."""
    out: dict[int, list] = {}
    current = None
    brace_pending = False
    for line in text.splitlines():
        raw = line.rstrip()
        if not raw.strip():
            continue
        if raw.strip() == "{":
            brace_pending = True
            continue
        index = group_index_of(raw)
        if index is None:
            match = _LINE_GROUP_RE.search(raw)
            index = int(match.group(1)) if match else None
        if index is not None:
            current = index
            out.setdefault(current, [])
            if brace_pending:
                out[current].append("{")
                brace_pending = False
            out[current].append(raw)
        elif current is not None:
            out[current].append(raw)
    if out:
        return {key: "\n".join(lines).strip()
                for key, lines in out.items() if lines}
    blocks = [block.strip() for block in re.split(r"\n\s*\n+", text)
              if block.strip()]
    if not blocks:
        return {}
    if len(blocks) == 1:
        blocks = [line.strip() for line in text.splitlines()
                  if line.strip()]
    kept = [block for block in blocks
            if block not in _JSON_NOISE_LINES]
    return {position + 1: block for position, block in enumerate(kept)}


def parse_prompt_groups(value) -> dict:
    """Messy grouped-prompt text -> {index: text} (``_parse_input_groups``,
    ``:937-963``): a ``"groups"`` array wins (strict JSON, then near-JSON
    object scan, then plain-text parse INSIDE the array only — wrapper
    keys like story_summary never leak); else whole-value JSON; else
    plain text."""
    if not isinstance(value, str):
        return {}
    cleaned = value.strip()
    if not cleaned:
        return {}
    groups_text = _groups_array_text(cleaned)
    if groups_text:
        try:
            return _groups_from_json(json.loads(groups_text))
        except Exception:
            near = _groups_from_near_json(groups_text)
            return near or _groups_from_plain_text(groups_text)
    if cleaned[:1] in "{[":
        try:
            return _groups_from_json(json.loads(cleaned))
        except Exception:
            pass
    return _groups_from_plain_text(cleaned)


def _meaningful_group_value(value) -> bool:
    text = str(value).strip() if value is not None else ""
    return bool(text) and text not in ("{}", "[]", '""', "null", "None")


def build_batch_prompt(batch_indices, grouped_inputs, global_input_1=None,
                       global_input_2=None) -> str:
    """Assemble one batch prompt (``_build_prompt``, ``:1006-1022``):
    global sections first, then per-group ``### Group N`` sections with
    each non-empty input."""
    sections = [text.strip() for text in (global_input_1, global_input_2)
                if isinstance(text, str) and text.strip()]
    for index in batch_indices:
        parts = [f"### Group {index}"]
        for name in ("input_1", "input_2", "input_3", "input_4"):
            value = grouped_inputs.get(name, {}).get(index)
            if _meaningful_group_value(value):
                parts.append(f"{name}:\n{value}")
        sections.append("\n\n".join(parts))
    return "\n\n".join(sections).strip()


def next_batch_file_index(output_path: str, file_prefix: str) -> int:
    """Next ``{prefix}_N`` file number in a batch folder (``:970-987``)."""
    if not os.path.isdir(output_path):
        return 0
    pattern = re.compile(rf"^{re.escape(file_prefix)}_(\d+)(?:\..+)?$")
    highest = -1
    for name in os.listdir(output_path):
        match = pattern.match(name)
        if match and os.path.isfile(os.path.join(output_path, name)):
            highest = max(highest, int(match.group(1)))
    return highest + 1


# ---------------------------------------------------------------------------
# concept-prompt round trips (the deterministic rim of the Gemma
# t2i/t2v-from-concepts flow, VRGDG_GeneralNodes2.py:576-682, 935-1120 —
# the LLM calls themselves stay external per SURVEY §2.5)
# ---------------------------------------------------------------------------

_FENCE_OPEN = r"^\s*```(?:{tag})?\s*"
_FENCE_CLOSE = r"\s*```\s*$"


def strip_llm_fence(text, tag: str = "json") -> str:
    """Peel one optional markdown code fence off an LLM reply
    (``_strip_json_fence`` :603-607 with tag ``json``;
    ``_clean_gemma4_text`` :651-655 with tag ``text``)."""
    value = str(text or "").strip()
    value = re.sub(_FENCE_OPEN.format(tag=re.escape(tag)), "", value,
                   flags=re.IGNORECASE)
    return re.sub(_FENCE_CLOSE, "", value).strip()


def first_clean_llm_line(text) -> str:
    """First non-empty reply line with bullet/number markers shed
    (``_first_clean_gemma4_line`` :677-682) — how single-line fields
    like camera motion are pulled from a chatty reply."""
    for line in strip_llm_fence(text, tag="text").splitlines():
        line = re.sub(r"^\s*(?:[-*]|\d+[.)])\s*", "", line).strip()
        if line:
            return line
    return ""


def parse_concept_prompt_items(text) -> list:
    """Ordered ``(key, prompt_text)`` rows from a ConceptPrompts
    payload (``_parse_concept_prompt_items`` :610-648): JSON objects
    keep key order, arrays synthesize ``prompt_N`` keys (2-tuples pass
    through as pairs), and non-JSON text falls back to blank-line
    blocks.  Raises ``ValueError`` on empty/unusable input with the
    reference's messages."""
    cleaned = strip_llm_fence(text, tag="json")
    if not cleaned:
        raise ValueError("ConceptPrompts.txt is empty.")
    try:
        data = json.loads(cleaned, object_pairs_hook=list)
    except json.JSONDecodeError as exc:
        blocks = [block.strip()
                  for block in re.split(r"(?:\r?\n){2,}", cleaned)
                  if block.strip()]
        if not blocks:
            raise ValueError(
                f"ConceptPrompts.txt is not valid JSON at line "
                f"{exc.lineno}, column {exc.colno}: {exc.msg}") from exc
        return [(f"prompt_{number}", block)
                for number, block in enumerate(blocks, start=1)]

    if isinstance(data, dict):
        pairs = list(data.items())
    elif isinstance(data, list):
        pair_shaped = all(isinstance(item, (list, tuple))
                          and len(item) == 2 for item in data)
        pairs = data if pair_shaped else \
            [(f"prompt_{number}", item)
             for number, item in enumerate(data, start=1)]
    else:
        raise ValueError(
            "ConceptPrompts.txt must contain a JSON object or array.")

    items = []
    for key, value in pairs:
        prompt_text = value.strip() if isinstance(value, str) \
            else json.dumps(value, ensure_ascii=False)
        if prompt_text:
            items.append((str(key), prompt_text))
    if not items:
        raise ValueError(
            "ConceptPrompts.txt did not contain any usable prompt rows.")
    return items
