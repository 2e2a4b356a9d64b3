"""LLM JSON repair nodes: lyric segments, prompt maps, story groups.

A copy of :mod:`vrgdg_tpu.runtime.json_fixers` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

Re-derivation of the fixer cluster in
``VRGDG_GeneralNodes2.py``: the lyric-segment JSON
fixer (``:2358-2737``), the lyric-segment text cleaner
(``:2740-2919``), the prompt-map fixer with SRT count validation
(``:2922-3113``), the subject prepender (``:3116-3217``), the
duration merger (``:3220-3374``), and the story-group fixer
(``:3460-3770``).  Each repairs a specific malformed-LLM-output
schema into its canonical JSON and reports what it changed.

The five reference classes each carry private copies of the same
hygiene helpers; here the shared repair primitives (fence strip,
invisible scrub, string-aware brace dedup / comma insertion, trailing
commas, error context) are factored once and the per-schema passes
compose them.  The note strings and raised error texts are part of the
output contract (downstream nodes display them) and are preserved.
"""

from __future__ import annotations

import json
import os
import re

__all__ = ["fix_lyric_segments_json", "clean_lyric_segments",
           "fix_prompt_map_json", "prepend_prompt_subject",
           "merge_segment_durations", "fix_story_group_json"]


# ---------------------------------------------------------------------------
# shared repair primitives
# ---------------------------------------------------------------------------

_SMART = str.maketrans({"\u201c": '"', "\u201d": '"',
                        "\u2018": "'", "\u2019": "'",
                        "\ufeff": None, "\u200b": None})
_INVISIBLE = str.maketrans({"\ufeff": None, "\u200b": None})
_TRAILING_COMMA = re.compile(r",(\s*[}\]])")


def _strip_fence(text) -> str:
    """Markdown ``...`` fence removal (identical in every fixer:
    reference :2375-2386 et al.): only a leading bare/json fence line
    and a pure trailing fence line are dropped.  Note the contract's
    asymmetry: an opening fence of another language (e.g. ```python)
    stays, yet a trailing ``` is still peeled; splitlines+join also
    normalizes \\r\\n to \\n, which downstream fixers rely on."""
    value = str(text or "").strip()
    if not value.startswith("```"):
        return value
    rows = value.splitlines()
    head = rows[0].strip().lower()
    start = 1 if head == "```" or head.startswith("```json") else 0
    stop = len(rows) - 1 if len(rows) > start and rows[-1].strip() == "```" else len(rows)
    return "\n".join(rows[start:stop]).strip()


def _scrub(text) -> str:
    """Fence + BOM/zero-width + smart-quote hygiene (reference
    :2388-2393 et al.)."""
    return _strip_fence(text).translate(_SMART).strip()


def _walk_strings(text):
    """Yield (index, char, in_string) with JSON string/escape state —
    the scanner underlying every string-aware repair below."""
    in_string = False
    escaped = False
    for index, char in enumerate(text):
        yield index, char, in_string
        if in_string:
            if escaped:
                escaped = False
            elif char == "\\":
                escaped = True
            elif char == '"':
                in_string = False
        elif char == '"':
            in_string = True
            escaped = False


def _dedupe_open_braces(text) -> tuple[str, int]:
    """Collapse ``{ {`` runs outside strings (reference :2493-2534)."""
    out = []
    changes = 0
    skip_until = -1
    chars = list(text)
    for index, char, in_string in _walk_strings(text):
        if index < skip_until:
            continue
        out.append(char)
        if not in_string and char == "{":
            probe = index + 1
            while probe < len(chars) and chars[probe].isspace():
                probe += 1
            if probe < len(chars) and chars[probe] == "{":
                changes += 1
                skip_until = probe
    return "".join(out), changes


def _drop_trailing_commas(text) -> tuple[str, int]:
    updated = _TRAILING_COMMA.sub(r"\1", text)
    return updated, int(updated != text)


def _json_error_context(exc, text, label) -> str:
    """Line/column pointer for parse failures (reference
    :2570-2580).  The caret column clamps at 0 and the context block
    is omitted entirely when the reported line is out of range."""
    if not isinstance(exc, json.JSONDecodeError):
        return f"{label}: {exc}"
    rows = str(text or "").splitlines()
    row = rows[exc.lineno - 1] if 1 <= exc.lineno <= len(rows) else None
    if row is None:
        return f"{label}: {exc.msg}."
    caret = "^".rjust(max(0, exc.colno - 1) + 1)
    return (f"{label}: {exc.msg}."
            f" Line {exc.lineno}, column {exc.colno}:\n{row}\n{caret}")


def _repair_then_parse(text, repair, label, parse):
    """The common fix_json control flow (reference :2707-2722): parse
    the scrubbed input; on failure run the schema repair pipeline and
    parse again; surface both errors when still broken."""
    original = _scrub(text)
    try:
        return parse(original), original, []
    except json.JSONDecodeError as exc:
        repaired, notes = repair(text)
        try:
            return parse(repaired), original, notes
        except json.JSONDecodeError as second:
            raise ValueError(
                f"{label}: "
                f"{_json_error_context(exc, original, 'Original JSON parse failed')}\n"
                f"{_json_error_context(second, repaired, 'Repair attempt still invalid')}")


# ---------------------------------------------------------------------------
# lyric-segment JSON fixer (reference :2358-2737)
# ---------------------------------------------------------------------------

_SEGMENT_PREFIXES = ("lyricSegment", "segment")
_SEGMENT_KEY = "lyricSegment"

_MISSING_SEGMENT_COMMA = re.compile(
    r'("(?:(?:[A-Za-z]*segment[A-Za-z]*)|(?:segment))\d+"\s*:\s*"((?:\\.|[^"\\])*)")(\s*)"(?=(?:(?:[A-Za-z]*segment[A-Za-z]*)|(?:segment))\d+"\s*:)',
    re.DOTALL | re.IGNORECASE)
_LOOSE_BEFORE_KEY = re.compile(
    r'([,{]\s*)[^"{}\[\],:\r\n]+(?="[^"\r\n]*segment[^"\r\n]*\d+"\s*:)',
    re.IGNORECASE)


def _escape_inner_quotes(text) -> str:
    """Escape a quote inside a string value unless a structural
    character follows it (reference :2396-2443)."""
    out = []
    in_string = False
    escaped = False
    length = len(text)
    pos = 0
    while pos < length:
        char = text[pos]
        if not in_string:
            out.append(char)
            if char == '"':
                in_string = True
                escaped = False
            pos += 1
            continue
        if escaped:
            out.append(char)
            escaped = False
            pos += 1
            continue
        if char == "\\":
            out.append(char)
            escaped = True
            pos += 1
            continue
        if char == '"':
            probe = pos + 1
            while probe < length and text[probe].isspace():
                probe += 1
            follower = text[probe] if probe < length else ""
            if follower not in (",", "}", "]", ":", ""):
                out.append("\\")
                out.append('"')
                pos += 1
                continue
            out.append(char)
            in_string = False
            pos += 1
            continue
        out.append(char)
        pos += 1
    return "".join(out)


def _last_object_slice(text) -> str:
    """The LAST balanced top-level ``{...}`` (reference :2445-2491);
    falls back to a first-{ / last-} slice."""
    slices = []
    depth = 0
    start = None
    for index, char, in_string in _walk_strings(text):
        if in_string or char == '"':
            continue
        if char == "{":
            if depth == 0:
                start = index
            depth += 1
        elif char == "}" and depth:
            depth -= 1
            if depth == 0 and start is not None:
                slices.append(text[start:index + 1])
                start = None
    if slices:
        return slices[-1]
    first = text.find("{")
    if first < 0:
        return text
    last = text.rfind("}")
    return text[first:last + 1] if last >= first else text[first:]


def _close_open_braces(text) -> tuple[str, int]:
    stripped = text.strip()
    if stripped.startswith("{") and \
            stripped.count("{") > stripped.count("}"):
        return (text + "}" * (stripped.count("{")
                              - stripped.count("}")), 1)
    return text, 0


def _segment_key_parts(key):
    """Recognize a segment key through the reference's fallback ladder
    (reference :2582-2605): exact prefixes, ``*segment*N`` shapes,
    punctuation-compacted variants, ``lyric…N`` / ``l…N`` / ``s…N``."""
    if not isinstance(key, str):
        return None, None
    stripped = key.strip()
    lowered = stripped.lower()
    for prefix in _SEGMENT_PREFIXES:
        if lowered.startswith(prefix.lower()):
            suffix = stripped[len(prefix):]
            if str(suffix).isdigit():
                return prefix, suffix
    hit = re.fullmatch(r"(?i)([A-Za-z]*segment[A-Za-z]*)(\d+)",
                       stripped)
    if hit:
        return _SEGMENT_KEY, hit.group(2)
    compact = re.sub(r"[^A-Za-z0-9]", "", stripped)
    for pattern in (r"(?i)([A-Za-z]*segment[A-Za-z]*)(\d+)",
                    r"(?i)((?:lyric|segment)[A-Za-z]*)(\d+)",
                    r"(?i)([ls][A-Za-z0-9]*?)(\d+)"):
        hit = re.fullmatch(pattern, compact)
        if hit:
            return _SEGMENT_KEY, hit.group(2)
    return None, None


def _segment_items(data):
    if isinstance(data, dict):
        return list(data.items())
    if isinstance(data, list) and all(
            isinstance(item, (list, tuple)) and len(item) == 2
            for item in data):
        return data
    return None


def _validate_segment_payload(data) -> list[str]:
    """Reference :2628-2660."""
    items = _segment_items(data)
    if items is None:
        return ["Top-level JSON must be an object of "
                "lyricSegment/segment keys."]
    if not items:
        return ["At least one lyricSegment or segment key is "
                "required."]
    errors = []
    valid = 0
    for key, value in items:
        prefix, suffix = _segment_key_parts(key)
        if prefix is None:
            errors.append(f"Invalid key '{key}'. Expected keys like "
                          "lyricSegment1 or segment1.")
            continue
        try:
            number = int(suffix)
        except (TypeError, ValueError):
            errors.append(f"Invalid key '{key}'. Expected numeric "
                          "suffix, e.g. lyricSegment1 or segment1.")
            continue
        if number <= 0:
            errors.append(f"Invalid segment number in '{key}'. It "
                          "must be greater than 0.")
            continue
        valid += 1
        if not isinstance(value, str):
            errors.append(f"{key} must be a string.")
    if not valid:
        errors.append("No valid lyricSegment/segment keys were "
                      "found.")
    return errors


def _repair_segment_text(text) -> tuple[str, list[str]]:
    """The lyric fixer's repair pipeline (reference :2672-2705)."""
    notes = []
    working = _scrub(text)
    sliced = _last_object_slice(working)
    if sliced != working:
        notes.append("trimmed extra text outside JSON")
        working = sliced
    working, dupes = _dedupe_open_braces(working)
    if dupes:
        notes.append(f"removed duplicate '{{' x{dupes}")
    escaped = _escape_inner_quotes(working)
    if escaped != working:
        working = escaped
        notes.append("escaped inner quotes inside segment text")
    working, commas = _drop_trailing_commas(working)
    if commas:
        notes.append("removed trailing commas")
    inserted = _MISSING_SEGMENT_COMMA.sub(r'\1,\3"', working)
    if inserted != working:
        working = inserted
        notes.append("inserted missing commas between lyric "
                     "segments x1")
    loose = _LOOSE_BEFORE_KEY.sub(r"\1", working)
    if loose != working:
        working = loose
        notes.append("removed loose text before segment keys x1")
    working, closed = _close_open_braces(working)
    if closed:
        notes.append("balanced closing braces")
    return working, notes


def fix_lyric_segments_json(text) -> dict:
    """Repair and canonicalize a ``lyricSegmentN`` JSON payload
    (reference ``fix_json`` :2707-2737).  Returns ``{fixed_text,
    data, was_fixed, notes}``; raises ``ValueError`` with both parse
    errors when unrepairable, or a schema error for invalid keys."""
    parsed, original, notes = _repair_then_parse(
        text, _repair_segment_text, "VRGDG_LyricSegmentJsonFixer",
        lambda body: json.loads(body, object_pairs_hook=list))

    numbers = []
    for key, _ in _segment_items(parsed) or []:
        _, suffix = _segment_key_parts(key)
        try:
            numbers.append(int(str(suffix)))
        except (TypeError, ValueError):
            pass
    if numbers and numbers != list(range(1, len(numbers) + 1)):
        notes.append("renumbered lyricSegment keys sequentially")

    errors = _validate_segment_payload(parsed)
    if errors:
        raise ValueError("VRGDG_LyricSegmentJsonFixer schema error: "
                         + " ".join(errors))
    normalized = {f"{_SEGMENT_KEY}{idx}": ""
                  if value is None else str(value)
                  for idx, (key, value)
                  in enumerate(_segment_items(parsed), start=1)}

    fixed_text = json.dumps(normalized, indent=2, ensure_ascii=False)
    was_fixed = bool(notes) or fixed_text.strip() != original.strip()
    note_text = "; ".join(notes) if notes else \
        ("normalized formatting" if was_fixed else "")
    return {"fixed_text": fixed_text, "data": normalized,
            "was_fixed": was_fixed, "notes": note_text}


# ---------------------------------------------------------------------------
# lyric-segment text cleaner (reference :2740-2919)
# ---------------------------------------------------------------------------

_FILLERS = {"oh", "you"}
_SEGMENT_LINE = re.compile(r"^(\s*lyricSegment)(\d+)(\s*=\s*)(.*)$",
                           re.IGNORECASE)
_LYRIC_WORD = re.compile(r"[A-Za-z0-9]+(?:['’][A-Za-z0-9]+)?")


def _lyric_words(text):
    return _LYRIC_WORD.findall(str(text or ""))


def _cap_word(word):
    value = str(word or "").strip()
    return value[0].upper() + value[1:].lower() if value else ""


def _collapse_repeats(text, repeat_count, min_repeats):
    """All-one-word segments collapse to N repetitions (reference
    :2803-2818)."""
    words = _lyric_words(text)
    if not words:
        return None
    lowered = {word.lower() for word in words}
    if len(lowered) != 1:
        return None
    word = words[0].lower()
    if len(words) < int(min_repeats) and word not in _FILLERS:
        return None
    shown = "Oh" if word in _FILLERS else _cap_word(words[0])
    return ", ".join([shown] * int(repeat_count)) + "."


def _bridge_single_word(segments, position):
    """Blend a lone word with its lyric neighbors (reference
    :2820-2866)."""
    current_words = _lyric_words(segments[position]["text"])
    if len(current_words) != 1:
        return None
    current = current_words[0]

    previous, from_phrase = "", False
    for back in range(position - 1, -1, -1):
        words = _lyric_words(segments[back].get(
            "original_text", segments[back]["text"]))
        if words:
            previous, from_phrase = words[-1], len(words) > 1
            break
    following = []
    for ahead in range(position + 1, len(segments)):
        words = _lyric_words(segments[ahead].get(
            "original_text", segments[ahead]["text"]))
        if words:
            following = words[:2] if (words[0].lower() == "the"
                                      and len(words) > 1) \
                else words[:1]
            break

    parts = []
    if previous and previous.lower() != current.lower():
        parts.append(_cap_word(previous) if from_phrase
                     else previous.lower())
    parts.append(current.lower())
    if following:
        first = following[0]
        if first.lower() != current.lower():
            if first.lower() == "the":
                tail = " ".join(_cap_word(word) for word in following)
                if len(parts) > 1:
                    return f"{parts[0]}, {parts[1]}. {tail}."
                return f"{parts[0]}. {tail}."
            parts.append(first.lower())
    if len(parts) <= 1:
        return None
    return ", ".join(parts) + "."


def clean_lyric_segments(lyrics_text, repeat_output_count: int = 3,
                         min_repeats_to_collapse: int = 4,
                         bridge_single_word_segments: bool = True,
                         fill_empty_segments: bool = True,
                         empty_segment_text: str =
                         "Instrumental section.") -> dict:
    """Smooth an extracted ``lyricSegmentN=`` sheet (reference
    ``clean`` :2868-2919): fill blanks with the instrumental
    placeholder, collapse repeated-word runs, expand lone filler
    words, and bridge single-word fragments with their neighbors.
    Returns ``{text, changed_count, notes}``."""
    lines = str(lyrics_text or "").splitlines()
    segments = []
    for line_index, line in enumerate(lines):
        hit = _SEGMENT_LINE.match(str(line or ""))
        if hit is None:
            continue
        segments.append({"line_index": line_index,
                         "prefix": hit.group(1),
                         "number": int(hit.group(2)),
                         "separator": hit.group(3),
                         "text": hit.group(4).strip(),
                         "original_text": hit.group(4).strip()})

    changed = 0
    touched = []
    for position, segment in enumerate(segments):
        original = segment["text"]
        replacement = None
        if not original and bool(fill_empty_segments):
            replacement = str(empty_segment_text
                              or "Instrumental section.").strip() \
                or "Instrumental section."
        if replacement is None:
            replacement = _collapse_repeats(
                original, repeat_output_count,
                min_repeats_to_collapse)
        if replacement is None:
            words = _lyric_words(original)
            if len(words) == 1 and words[0].lower() in _FILLERS:
                replacement = ", ".join(
                    ["Oh"] * int(repeat_output_count)) + "."
        if replacement is None and bool(bridge_single_word_segments):
            replacement = _bridge_single_word(segments, position)
        if replacement and replacement != original:
            segment["text"] = replacement
            changed += 1
            touched.append(f"lyricSegment{segment['number']}")

    output = list(lines)
    for segment in segments:
        output[segment["line_index"]] = (
            f"{segment['prefix']}{segment['number']}"
            f"{segment['separator']}{segment['text']}")
    notes = "Cleaned " + ", ".join(touched) if touched \
        else "No lyric cleanup needed"
    return {"text": "\n".join(output), "changed_count": changed,
            "notes": notes}


# ---------------------------------------------------------------------------
# prompt-map fixer (reference :2922-3113)
# ---------------------------------------------------------------------------

_PROMPT_ENTRY = re.compile(
    r'(?i)(?:^|[,{]\s*|[\r\n]\s*)[A-Za-z]*"?Prompt[A-Za-z]*(\d+)"?\s*:\s*"((?:\\.|[^"\\])*)"',
    re.DOTALL)
_SRT_TIMESTAMP_LINE = re.compile(
    r"(?m)^\s*\d{1,2}:\d{2}:\d{2}[,.]\d{1,3}\s*-->\s*"
    r"\d{1,2}:\d{2}:\d{2}[,.]\d{1,3}.*$")


def _flat_prompt_text(value) -> str:
    if value is None:
        value = ""
    elif not isinstance(value, str):
        value = str(value)
    return " ".join(value.replace("\r", " ").replace("\n", " ")
                    .split())


def _wide_json_slice(text) -> str:
    start = text.find("{")
    end = text.rfind("}")
    if start >= 0 and end >= start:
        return text[start:end + 1]
    return text[start:] if start >= 0 else text


def fix_prompt_map_json(text, srt_source=None) -> dict:
    """Repair a ``PromptN`` map (reference ``fix_json``
    :3075-3113): numbered keys are renumbered/renamed canonically;
    unparseable payloads are rebuilt by scanning for Prompt entries.
    ``srt_source`` (a path or raw SRT text) enables the scene-count
    check.  Returns ``{fixed_text, data, was_fixed, notes,
    prompt_count}``."""
    cleaned = _scrub(text)
    candidate, _ = _drop_trailing_commas(_wide_json_slice(cleaned))
    notes = []
    prompts: dict[int, str] = {}
    try:
        parsed = json.loads(candidate)
        if not isinstance(parsed, dict):
            raise ValueError("top-level JSON is not an object")
        for key, value in parsed.items():
            key_text = str(key)
            hit = re.search(r"(\d+)", key_text)
            if not hit:
                continue
            index = int(hit.group(1))
            if index <= 0:
                continue
            if not re.fullmatch(r"Prompt\d+", key_text):
                notes.append(f"renamed {key_text} to Prompt{index}")
            if index in prompts:
                notes.append(f"duplicate Prompt{index}; kept last "
                             "value")
            prompts[index] = _flat_prompt_text(value)
        if not prompts and parsed:
            prompts = {index: _flat_prompt_text(value)
                       for index, value
                       in enumerate(parsed.values(), start=1)}
            notes.append("no numbered prompt keys found; used object "
                         "order")
    except Exception:
        notes.append("rebuilt object from Prompt entries")
        for hit in _PROMPT_ENTRY.finditer(candidate):
            index = int(hit.group(1))
            if index <= 0:
                continue
            raw = hit.group(2)
            try:
                value = json.loads(f'"{raw}"')
            except Exception:
                value = raw.replace('\\"', '"')
            if index in prompts:
                notes.append(f"duplicate Prompt{index}; kept last "
                             "value")
            prompts[index] = _flat_prompt_text(value)

    normalized = {f"Prompt{index}": prompts[index]
                  for index in sorted(prompts)}
    prompt_count = len(normalized)

    if srt_source is not None:
        value = str(srt_source or "").strip().strip("\"'")
        if not value:
            raise ValueError(
                "VRGDG_PromptMapJsonFixer: Use SRT File is enabled, "
                "but no SRT file/text was connected.")
        if os.path.isfile(value):
            with open(value, "r", encoding="utf-8-sig") as handle:
                srt_text, label = handle.read(), value
        elif "-->" in value:
            srt_text, label = value, "connected SRT text"
        else:
            raise ValueError(
                "VRGDG_PromptMapJsonFixer: connected SRT value is "
                "not an existing file path and does not look like "
                "SRT text.")
        stamps = _SRT_TIMESTAMP_LINE.findall(str(srt_text or ""))
        if not stamps:
            raise ValueError(
                f"VRGDG_PromptMapJsonFixer: no SRT timestamp lines "
                f"were found in {label}.")
        if prompt_count != len(stamps):
            raise ValueError(
                "VRGDG_PromptMapJsonFixer: prompt count does not "
                "match SRT scene count. "
                f"Prompts: {prompt_count}, SRT scenes: {len(stamps)}. "
                f"Source: {label}.")
        notes.append(f"SRT scene count matched prompt count "
                     f"({prompt_count})")

    fixed_text = json.dumps(normalized, indent=2, ensure_ascii=False)
    was_fixed = fixed_text.strip() != cleaned.strip()
    if cleaned.startswith("```"):
        notes.append("removed markdown code fence")
    if candidate != cleaned:
        notes.append("trimmed text outside JSON or removed trailing "
                     "commas")
    if was_fixed and not notes:
        notes.append("normalized formatting")
    return {"fixed_text": fixed_text, "data": normalized,
            "was_fixed": was_fixed, "notes": "; ".join(notes),
            "prompt_count": prompt_count}


def prepend_prompt_subject(subject, prompt_json, separator: str = ", ",
                           skip_if_already_starts: bool = True) -> dict:
    """Prefix every prompt value with the subject (reference
    :3203-3217); prompts already opening with it are left alone when
    ``skip_if_already_starts``."""
    subject_text = _flat_prompt_text(subject)
    separator_text = str(separator or "")
    if isinstance(prompt_json, dict):
        prompt_map = prompt_json
    else:
        # the reference's loader scrubs invisibles but NOT smart
        # quotes here (:3192-3194)
        candidate = _wide_json_slice(
            _strip_fence(prompt_json).translate(_INVISIBLE))
        try:
            prompt_map = json.loads(candidate)
        except json.JSONDecodeError as exc:
            raise ValueError("VRGDG_PromptJsonSubjectPrepender: "
                             f"invalid prompt JSON: {exc}")
        if not isinstance(prompt_map, dict):
            raise ValueError("VRGDG_PromptJsonSubjectPrepender: "
                             "prompt JSON must be an object.")
    skip = str(skip_if_already_starts).strip().lower() == "true" \
        if isinstance(skip_if_already_starts, str) \
        else bool(skip_if_already_starts)

    output = {}
    for key, value in prompt_map.items():
        prompt_text = _flat_prompt_text(value)
        if subject_text and not (
                skip and prompt_text.lower().startswith(
                    subject_text.lower())):
            prompt_text = (f"{subject_text}{separator_text}"
                           f"{prompt_text}") if prompt_text \
                else subject_text
        output[str(key)] = prompt_text
    return {"fixed_text": json.dumps(output, indent=2,
                                     ensure_ascii=False),
            "data": output, "prompt_count": len(output)}


# ---------------------------------------------------------------------------
# duration merger (reference :3220-3374)
# ---------------------------------------------------------------------------

_SRT_RANGE = re.compile(
    r"(\d{2}:\d{2}:\d{2},\d{3})\s*-->\s*(\d{2}:\d{2}:\d{2},\d{3})")


def _srt_stamp_seconds(stamp) -> float:
    hours, minutes, rest = stamp.split(":")
    seconds, millis = rest.split(",")
    return int(hours) * 3600 + int(minutes) * 60 + int(seconds) \
        + int(millis) / 1000.0


def merge_segment_durations(srt_text, segments_json,
                            strict_count_match: bool = True,
                            decimal_places: int = 3,
                            use_srt_durations: bool = True) -> dict:
    """Stamp each sequential segment key with its SRT cue duration
    (reference ``merge`` :3354-3374): ``lyricSegmentN`` becomes
    ``lyricSegmentN_duration_T``.  Returns ``{fixed_text, data,
    segment_count, duration_count}``."""
    label = "VRGDG_LyricSegmentDurationMerger"
    cleaned = _strip_fence(segments_json)
    try:
        data = json.loads(cleaned)
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"{label}: segment JSON is invalid at line {exc.lineno}, "
            f"column {exc.colno}: {exc.msg}")
    if not isinstance(data, dict):
        raise ValueError(f"{label}: segment JSON must be an object.")

    prefixes = set()
    ordered = []
    for key, value in data.items():
        prefix = next((p for p in _SEGMENT_PREFIXES
                       if isinstance(key, str)
                       and key.startswith(p)), None)
        if prefix is None:
            raise ValueError(f"{label}: invalid key '{key}'. Expected "
                             "keys like lyricSegment1 or segment1.")
        prefixes.add(prefix)
        suffix = key[len(prefix):]
        try:
            index = int(suffix)
        except (TypeError, ValueError):
            raise ValueError(f"{label}: invalid key '{key}'. Numeric "
                             "suffix is required.")
        if index <= 0:
            raise ValueError(f"{label}: invalid key '{key}'. Index "
                             "must be greater than 0.")
        if not isinstance(value, str):
            raise ValueError(f"{label}: {key} must map to a string.")
        ordered.append((index, key, value))
    if not ordered:
        raise ValueError(f"{label}: no segment keys were found.")
    if len(prefixes) > 1:
        raise ValueError(f"{label}: do not mix 'segmentN' and "
                         "'lyricSegmentN' keys.")
    ordered.sort(key=lambda item: item[0])
    actual = [item[0] for item in ordered]
    if actual != list(range(1, len(ordered) + 1)):
        raise ValueError(
            f"{label}: segment keys must be sequential starting at 1. "
            f"Found: {', '.join(str(v) for v in actual)}.")

    durations = []
    if use_srt_durations:
        stamps = _SRT_RANGE.findall(str(srt_text or ""))
        if not stamps:
            raise ValueError(f"{label}: no SRT timestamps were "
                             "found.")
        for start, end in stamps:
            span = _srt_stamp_seconds(end) - _srt_stamp_seconds(start)
            if span < 0:
                raise ValueError(
                    f"{label}: found a subtitle end time earlier "
                    "than its start time.")
            durations.append(span)
        if strict_count_match and len(ordered) != len(durations):
            raise ValueError(
                f"{label}: segment count does not match SRT duration "
                f"count. Segments: {len(ordered)}, durations: "
                f"{len(durations)}.")

    merged = {}
    for position, (_, key, value) in enumerate(ordered):
        if not use_srt_durations:
            merged[key] = value
            continue
        span = durations[position] if position < len(durations) \
            else 0.0
        places = int(decimal_places)
        rounded = round(float(span), places)
        stamp = f"{rounded:.{places}f}" if places > 0 \
            else str(int(round(rounded)))
        if "." in stamp:
            stamp = stamp.rstrip("0").rstrip(".")
        merged[f"{key}_duration_{stamp or '0'}"] = value
    return {"fixed_text": json.dumps(merged, indent=2,
                                     ensure_ascii=False),
            "data": merged, "segment_count": len(ordered),
            "duration_count": len(durations)}


# ---------------------------------------------------------------------------
# story-group fixer (reference :3460-3770)
# ---------------------------------------------------------------------------

_GROUP_KEYS = ("index", "subject", "camera", "scene_and_lighting",
               "frame")


def _story_json_slice(text) -> str:
    starts = [pos for pos in (text.find("{"), text.find("["))
              if pos >= 0]
    if not starts:
        return text
    start = min(starts)
    end = max(text.rfind("}"), text.rfind("]"))
    return text[start:end + 1] if end >= start else text[start:]


def _insert_object_commas(text) -> tuple[str, int]:
    """``} {`` sequences outside strings gain the missing comma
    (reference :3556-3595)."""
    out = []
    changes = 0
    skip_until = -1
    for index, char, in_string in _walk_strings(text):
        if index < skip_until:
            continue
        out.append(char)
        if not in_string and char == "}":
            probe = index + 1
            gap = []
            while probe < len(text) and text[probe].isspace():
                gap.append(text[probe])
                probe += 1
            if probe < len(text) and text[probe] == "{":
                out.extend(gap)
                out.append(",")
                changes += 1
                skip_until = probe
    return "".join(out), changes


def _deficit(body, opener, closer, slack=0):
    return body.count(opener) - body.count(closer) - slack


def _balance_story_structure(text) -> tuple[str, int]:
    """Reference :3597-3614 — brace closure plus the groups-array
    heuristics, expressed as a rule table of (where-to-count, opener,
    closer, slack, gate) evaluated in order against the LIVE text
    (each appended closer feeds the next rule's counts, exactly like
    the reference's sequential ifs)."""
    stripped = text.strip()
    changes = 0

    def _pad(count, closer):
        nonlocal text, changes
        if count > 0:
            text += closer * count
            changes += 1

    if stripped.startswith("{"):
        _pad(_deficit(stripped, "{", "}"), "}")
    if stripped.startswith("["):
        _pad(_deficit(stripped, "[", "]"), "]")
    if '"groups"' in text:
        _pad(_deficit(text.split('"groups"', 1)[0], "[", "]", 1), "]")
        _pad(_deficit(text, "[", "]"), "]")
    return text, changes


def _validate_story_payload(data) -> list[str]:
    """Reference :3628-3673."""
    if not isinstance(data, dict):
        return ["Top-level JSON must be an object with "
                "'story_summary' and 'groups'."]
    errors = []
    # header shape: (key, required type, type-error text, fatal)
    for key, kind, kind_error, fatal in (
            ("story_summary", str, "'story_summary' must be a "
             "string.", False),
            ("groups", list, "'groups' must be a list.", True)):
        if key not in data:
            errors.append(f"Missing top-level key '{key}'.")
            if fatal:
                return errors
        elif not isinstance(data.get(key), kind):
            errors.append(kind_error)
            if fatal:
                return errors
    groups = data.get("groups")
    seen = set()
    for pos, group in enumerate(groups, start=1):
        if not isinstance(group, dict):
            errors.append(f"groups[{pos}] must be an object.")
            continue
        missing = [key for key in _GROUP_KEYS if key not in group]
        if missing:
            errors.append(f"groups[{pos}] is missing keys: "
                          f"{', '.join(missing)}.")
        if "index" in group:
            try:
                value = int(group.get("index"))
                if value <= 0:
                    errors.append(f"groups[{pos}].index must be "
                                  "greater than 0.")
                elif value in seen:
                    errors.append(f"Duplicate group index {value}.")
                else:
                    seen.add(value)
            except (TypeError, ValueError):
                errors.append(f"groups[{pos}].index must be an "
                              "integer.")
        for key in _GROUP_KEYS[1:]:
            if key in group and not isinstance(group.get(key), str):
                errors.append(f"groups[{pos}].{key} must be a "
                              "string.")
    return errors


def _repair_story_text(text) -> tuple[str, list[str]]:
    """Reference :3720-3744."""
    notes = []
    working = _scrub(text)
    sliced = _story_json_slice(working)
    if sliced != working:
        notes.append("trimmed extra text outside JSON")
        working = sliced
    working, dupes = _dedupe_open_braces(working)
    if dupes:
        notes.append(f"removed duplicate '{{' x{dupes}")
    working, commas = _drop_trailing_commas(working)
    if commas:
        notes.append("removed trailing commas")
    working, inserted = _insert_object_commas(working)
    if inserted:
        notes.append(f"inserted missing commas between objects "
                     f"x{inserted}")
    working, balanced = _balance_story_structure(working)
    if balanced:
        notes.append("balanced closing brackets/braces")
    return working, notes


def fix_story_group_json(text) -> dict:
    """Repair and canonicalize a story-groups payload (reference
    ``fix_json`` :3746-3770): groups gain their required keys,
    stringified values, and a sorted positive index.  Returns
    ``{fixed_text, data, was_fixed, notes}``."""
    parsed, original, notes = _repair_then_parse(
        text, _repair_story_text, "VRGDG_StoryGroupJsonFixer",
        json.loads)

    errors = _validate_story_payload(parsed)
    if errors:
        raise ValueError("VRGDG_StoryGroupJsonFixer schema error: "
                         + " ".join(errors))
    groups = []
    for fallback, group in enumerate(parsed.get("groups", []),
                                     start=1):
        item = group if isinstance(group, dict) else {}
        normalized = {}
        try:
            normalized["index"] = int(item.get("index", fallback))
        except (TypeError, ValueError):
            normalized["index"] = fallback
        for key in _GROUP_KEYS[1:]:
            value = item.get(key, "")
            normalized[key] = "" if value is None else (
                value if isinstance(value, str) else str(value))
        groups.append(normalized)
    groups.sort(key=lambda item: item.get("index", 0))
    for position, group in enumerate(groups, start=1):
        if group.get("index") <= 0:
            group["index"] = position
    normalized_payload = {
        "story_summary": parsed.get("story_summary", ""),
        "groups": groups}

    fixed_text = json.dumps(normalized_payload, indent=2,
                            ensure_ascii=False)
    was_fixed = bool(notes) or fixed_text.strip() != original.strip()
    note_text = "; ".join(notes) if notes else \
        ("normalized formatting" if was_fixed else "")
    return {"fixed_text": fixed_text, "data": normalized_payload,
            "was_fixed": was_fixed, "notes": note_text}
