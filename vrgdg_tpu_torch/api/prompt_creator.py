"""Prompt Creator state store + deterministic text math.

A copy of :mod:`vrgdg_tpu.api.prompt_creator` (which cannot be imported
without JAX): every function keeps its original's source.

Framework-native re-derivation of the non-LLM half of the reference
prompt-creator backend
(``VRGDG_MusicVideoPromptCreatorNodes.py``): the
draft/output persistence the Video Builder imports from, and the
deterministic parsing/normalization every LLM round trip pipes
through — whisper-segment parsing, lyric windows, canonical
segment/prompt mappings, subject prepending, fixed-duration SRT
synthesis, and malformed-JSON rescue.

Parity targets:
- project folders + payload resolution: ``:430-456``,
- JSON rescue (fence strip, quote/comma repair, bare-key quoting,
  key-value line fallback): ``:509-585``,
- whisper/lyric parsing + windows: ``:610-662``,
- canonical mappings + validation: ``:664-676``, ``:745-799``,
  ``:860-900``,
- subject prepend/strip: ``:800-858``,
- SRT timestamp math + fixed-duration synthesis: ``:692-744``,
- save_outputs ``:1320-1426``, draft save/load ``:1465-1653``,
  draft listing ``:1654-1716``, audio import ``:1893-1930``.

Also here: the hidden Whisper workflow builder + config
(``build_whisper_prompt``, ``:1815-1891`` — a deterministic template
patch like the workflow-runner builders) and the recommended LLM
settings surface.  The instruction store lives in
``api/pc_instructions.py``.

Excluded (LLM): ``create_concepts`` / ``repair_segments`` /
``extract_subject`` / ``create_i2v_motion_notes`` generation (each
drives a Gemma/LM-Studio call).
"""

from __future__ import annotations

import json
import math
import os
import re
import time

from ..runtime.text_tools import clean_llm_chat_text
from .builder import ProjectLayout, _clean, _read_json, _write_json, \
    safe_component
from .paths import DEFAULT_OUTPUT_ROOT

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".m4a", ".ogg", ".mp4")

# every key family the LLM emits for numbered mappings (:524-533)
_NUMBERED_KEY = (r"[A-Za-z_]*(?:Prompt|prompt|I2V|i2v|Motion|motion|"
                 r"segment|Segment|lyricSegment|LyricSegment|segments|"
                 r"Segments)")


_TRUTHY = frozenset({"true", "1", "yes", "on", "y"})
_FALSY = frozenset({"false", "0", "no", "off", "n", ""})


def payload_bool(value, default: bool = False) -> bool:
    """Tolerant payload-boolean coercion (word lists per ``:554-566``)."""
    if isinstance(value, (bool, int, float)):
        return bool(value)
    if value is not None:
        text = str(value).strip().lower()
        if text in _TRUTHY or text in _FALSY:
            return text in _TRUTHY
    return default


# ------------------------------------------------------------------
# malformed-JSON rescue
# ------------------------------------------------------------------

def clean_json_text(text) -> str:
    """Strip chat-template wrappers, then markdown fences
    (``:509-514``; the chat cleaning is
    :func:`text_tools.clean_llm_chat_text`)."""
    cleaned = clean_llm_chat_text(text)
    cleaned = re.sub(r"^\s*```(?:json)?\s*", "", cleaned,
                     flags=re.IGNORECASE)
    cleaned = re.sub(r"\s*```\s*$", "", cleaned)
    return cleaned.strip()


def repair_json_like(text) -> str:
    """Smart quotes -> ASCII, comments and trailing commas dropped,
    bare numbered keys quoted (``:516-534``)."""
    repaired = str(text or "").strip()
    for bad, good in (("“", '"'), ("”", '"'),
                      ("‘", "'"), ("’", "'")):
        repaired = repaired.replace(bad, good)
    repaired = re.sub(r"//.*?$", "", repaired, flags=re.MULTILINE)
    repaired = re.sub(r",\s*([}\]])", r"\1", repaired)
    repaired = re.sub(rf'([{{\[,]\s*)({_NUMBERED_KEY}\d+)\s*:',
                      r'\1"\2":', repaired)
    repaired = re.sub(rf'(^\s*)({_NUMBERED_KEY}\d+)\s*:', r'\1"\2":',
                      repaired, flags=re.MULTILINE)
    return repaired


def parse_key_value_lines(text) -> dict:
    """Last-resort rescue: ``segment3: words`` lines (with multi-line
    continuation) into a mapping (``:536-561``)."""
    values: dict[str, str] = {}
    current_key, parts = None, []
    key_pattern = re.compile(
        rf'^\s*"?({_NUMBERED_KEY}\s*\d+)"?\s*[:=]\s*(.*?)(?:,\s*)?$')
    bare_brackets = {"{", "}", "[", "]"}
    for line in map(str.strip, str(text or "").splitlines()):
        if not line or line in bare_brackets:
            continue
        match = key_pattern.match(line)
        if match:
            if current_key:
                values[current_key] = "\n".join(parts).strip().strip('"')
            current_key = match.group(1)
            parts = [match.group(2).strip().rstrip(",").strip()
                     .strip('"')]
            continue
        if current_key:
            parts.append(line.rstrip(",").strip('"'))
    if current_key:
        values[current_key] = "\n".join(parts).strip().strip('"')
    if not values:
        raise ValueError("Text did not contain a JSON object.")
    return values


def extract_json_object(text) -> dict:
    """Best-effort mapping out of LLM-ish text (``:563-584``): direct
    parse, repaired parse, brace-slice parse, then key-value lines."""
    cleaned = clean_json_text(text)
    candidates = [cleaned, repair_json_like(cleaned)]
    start, end = cleaned.find("{"), cleaned.rfind("}")
    if 0 <= start < end:
        sliced = cleaned[start:end + 1]
        candidates += [sliced, repair_json_like(sliced)]
    last_error = None
    for candidate in candidates:
        try:
            if str(candidate or "").strip():
                return json.loads(candidate)
        except Exception as error:  # noqa: BLE001 — rescue chain
            last_error = error
    try:
        return parse_key_value_lines(cleaned)
    except ValueError:
        raise last_error or ValueError(
            "Text did not contain a JSON object.")


# ------------------------------------------------------------------
# whisper segments, lyric lines, canonical mappings
# ------------------------------------------------------------------

def parse_whisper_segments(text) -> dict:
    """``lyricSegment3: words`` / ``3 - words`` lines -> ordered
    ``{lyricSegmentN: text}`` (``:610-623``)."""
    numbered = re.compile(
        r"^(?:lyricSegment|segment)?\s*(\d+)\s*[:=.-]\s*(.+)$",
        flags=re.IGNORECASE)
    matches = (numbered.match(line)
               for line in map(str.strip, str(text or "").splitlines())
               if line)
    found = [(int(m.group(1)), m.group(2).strip()) for m in matches if m]
    if not found:
        raise ValueError("No numbered Whisper segments were found.")
    found.sort(key=lambda item: item[0])
    return {f"lyricSegment{index}": value for index, value in found}


def split_lyric_lines(text) -> list[str]:
    """Real lyric lines: whitespace-collapsed, section headers dropped
    (``:632-647``)."""
    header = re.compile(
        r"^\s*(?:verse|chorus|bridge|intro|outro|pre[-\s]?chorus)\b",
        flags=re.IGNORECASE)
    collapsed = (re.sub(r"\s+", " ", raw).strip()
                 for raw in str(text or "").splitlines())
    lines = [line for line in collapsed if line and not header.match(line)]
    if not lines:
        # no real lyric lines: fall back to the whole text as one line
        whole = re.sub(r"\s+", " ", str(text or "")).strip()
        lines = [whole] if whole else []
    return lines


def lyric_window(lyric_lines, start_index: int, end_index: int,
                 total_segments: int, overlap: int = 4) -> list[str]:
    """Proportional lyric slice for a segment batch, padded by
    ``overlap`` lines each side (``:649-662``)."""
    if not lyric_lines:
        return []
    total = len(lyric_lines)
    start_ratio = max(0.0, (start_index - 1) / max(1, total_segments))
    end_ratio = min(1.0, end_index / max(1, total_segments))
    first = max(0, int(math.floor(start_ratio * total)) - overlap)
    last = min(total, int(math.ceil(end_ratio * total)) + overlap)
    if last <= first:
        last = min(total, first + 1)
    return [f"line{number + 1}={lyric_lines[number]}"
            for number in range(first, last)]


def canonical_segments(value) -> dict:
    """Any segment-key spelling -> ``{segmentN: text}`` sorted by N
    (``:668-674``)."""
    fixed = {}
    for raw_key, raw_value in (value or {}).items():
        match = re.match(r"^(?:lyricSegment|segment|segments)\s*(\d+)$",
                         str(raw_key), flags=re.IGNORECASE)
        if match:
            fixed[f"segment{int(match.group(1))}"] = \
                str(raw_value or "").strip()
    return {key: fixed[key] for key in
            sorted(fixed, key=lambda item:
                   int(re.search(r"\d+", item).group(0)))}


def canonical_prompts(value) -> dict:
    fixed = {}
    for raw_key, raw_value in (value or {}).items():
        match = re.match(r"^Prompt\s*(\d+)$", str(raw_key),
                         flags=re.IGNORECASE)
        if match:
            fixed[f"Prompt{int(match.group(1))}"] = \
                str(raw_value or "").strip()
    return {key: fixed[key] for key in
            sorted(fixed, key=lambda item:
                   int(re.search(r"\d+", item).group(0)))}


def is_scene_label_only(prompts) -> bool:
    """True when every prompt is just its own "SCENE N" label — the
    tell of an unfilled template (``:754-763``)."""
    items = list((prompts or {}).items())
    if not items:
        return False
    for key, prompt in items:
        key_match = re.search(r"(\d+)", str(key or ""))
        value_match = re.match(r"^\s*scene\s*(\d+)\s*$",
                               str(prompt or ""), flags=re.IGNORECASE)
        if not key_match or not value_match \
                or int(key_match.group(1)) != int(value_match.group(1)):
            return False
    return True


def validate_segments(value, expected_count: int) -> dict:
    """Exactly ``segment1..N``, all non-empty (``:860-873``)."""
    if not isinstance(value, dict):
        raise ValueError("Segment output is not a JSON object.")
    indexed = {int(re.search(r"\d+", key).group(0)): text
               for key, text in canonical_segments(value).items()}
    fixed = {}
    for index in range(1, int(expected_count) + 1):
        key = f"segment{index}"
        if index not in indexed:
            raise ValueError(f"Segment output is missing {key}.")
        text = str(indexed[index] or "").strip()
        if not text:
            raise ValueError(f"{key} is empty.")
        fixed[key] = text
    return fixed


def segment_subset_with_fallback(value, expected_keys,
                                 target_segments) -> dict:
    """Batch-repair fallback: missing keys take the original whisper
    text, filler-only originals become ``[instrumental]``
    (``:888-900``)."""
    canonical = canonical_segments(value) if isinstance(value, dict) \
        else {}
    fixed = {}
    for key in expected_keys:
        text = str(canonical.get(key, "") or "").strip()
        if not text:
            original = str(target_segments.get(key, "") or "").strip()
            filler = re.fullmatch(r"(?:thank you\.?|thanks\.?|"
                                  r"oh[,\s.]*)+", original,
                                  flags=re.IGNORECASE)
            text = "[instrumental]" if filler else original
        fixed[key] = text or "[instrumental]"
    return fixed


# ------------------------------------------------------------------
# subject prepending
# ------------------------------------------------------------------

def _inline(value) -> str:
    return " ".join(str(value or "").replace("\r", " ")
                    .replace("\n", " ").split())


def strip_leading_subject(prompt, subjects) -> str:
    """Remove any known subject already leading the prompt so
    re-prepending cannot stack copies (``:804-830``)."""
    prompt_text = _inline(prompt)
    known = [_inline(item) for item in (subjects or [])
             if _inline(item)]
    guard, changed = 0, True
    while changed and guard < 8:
        changed = False
        guard += 1
        for subject_text in known:
            if not prompt_text:
                break
            if prompt_text.lower() == subject_text.lower():
                prompt_text = ""
                changed = True
                break
            if prompt_text.lower().startswith(subject_text.lower()):
                prompt_text = prompt_text[len(subject_text):].lstrip()
                prompt_text = re.sub(r"^[,;:.-]\s*", "",
                                     prompt_text).strip()
                changed = True
                break
    return prompt_text


def prepend_subject(prompts, subject, separator: str = ", ",
                    previous_subjects=None) -> dict:
    """``{PromptN: "<subject>, <prompt>"}`` with double-prepend
    protection (``:833-858``)."""
    subject_text = _inline(subject)
    if not subject_text or not isinstance(prompts, dict):
        return prompts
    known = [subject_text]
    if isinstance(previous_subjects, (list, tuple, set)):
        known.extend(previous_subjects)
    elif previous_subjects:
        known.append(previous_subjects)
    output = {}
    for key, value in prompts.items():
        body = strip_leading_subject(value, known)
        output[str(key)] = (f"{subject_text}{separator}{body}"
                            if body else subject_text)
    return output


# ------------------------------------------------------------------
# SRT synthesis
# ------------------------------------------------------------------

def format_srt_timestamp(seconds) -> str:
    value = max(0.0, float(seconds or 0))
    whole = int(math.floor(value))
    millis = int(round((value - whole) * 1000))
    if millis >= 1000:
        whole += 1
        millis -= 1000
    return (f"{whole // 3600:02d}:{(whole % 3600) // 60:02d}:"
            f"{whole % 60:02d},{millis:03d}")


def parse_srt_timestamp(value):
    match = re.match(r"^\s*(\d{1,2}):(\d{2}):(\d{2})[,.](\d{1,3})\s*$",
                     str(value or ""))
    if not match:
        return None
    hours, minutes, seconds, millis = (int(part)
                                       for part in match.groups())
    return hours * 3600 + minutes * 60 + seconds + millis / 1000.0


def srt_total_duration_hint(srt_text):
    last_end = None
    for match in re.finditer(
            r"-->\s*(\d{1,2}:\d{2}:\d{2}[,.]\d{1,3})",
            str(srt_text or "")):
        parsed = parse_srt_timestamp(match.group(1))
        if parsed is not None:
            last_end = parsed
    return last_end


def fixed_duration_srt(segments, fixed_scene_duration=4,
                       total_duration_hint=None) -> str:
    """Equal-length SRT over the corrected segments; the final scene
    stretches to the known audio end (``:722-744``)."""
    canonical = canonical_segments(segments)
    if not canonical:
        return ""
    duration = max(0.05, float(fixed_scene_duration or 4))
    total_hint = float(total_duration_hint or 0)
    lines, start = [], 0.0
    items = list(canonical.items())
    for index, (_key, text) in enumerate(items, start=1):
        end = start + duration
        if index == len(items) and total_hint > start:
            end = total_hint
        lines += [str(index),
                  f"{format_srt_timestamp(start)} --> "
                  f"{format_srt_timestamp(end)}",
                  str(text or "Instrumental section."), ""]
        start = end
    return "\n".join(lines).rstrip() + "\n"


# ------------------------------------------------------------------
# persistence
# ------------------------------------------------------------------

def project_folder_from_payload(payload,
                                output_root: str | None = None) -> str:
    raw = _clean(payload.get("project_folder"))
    if raw:
        return os.path.abspath(raw)
    name = _clean(payload.get("project_name")) \
        or f"VRGDG_Project_{time.strftime('%Y_%m_%d_%H_%M_%S')}"
    return os.path.join(os.path.abspath(output_root
                                        or DEFAULT_OUTPUT_ROOT),
                        safe_component(name))


def _as_mapping(value):
    if isinstance(value, str) and value.strip():
        return extract_json_object(value)
    return value or {}


def _pointer_paths(layout: ProjectLayout, output_root: str,
                   saved_at: str, marker: dict | None = None) -> str:
    """Write the output marker + the global last-project pointer the
    Video Builder import resolves (``:1434-1463``)."""
    context = layout.context_folder
    marker_path = os.path.join(context, "prompt_creator_output.json")
    _write_json(marker_path, marker or {
        "type": "vrgdg_prompt_creator_output",
        "saved_at": saved_at,
        "has_concept_prompts": os.path.isfile(
            os.path.join(context, "ConceptPrompts.txt")),
        "has_i2v_motion_notes": os.path.isfile(
            os.path.join(context, "I2VMotionNotes.txt")),
        "has_srt": os.path.isfile(layout.srt_path),
    })
    _write_json(os.path.join(os.path.abspath(output_root),
                             "VRGDG_LastPromptCreatorProject.json"),
                {"type": "vrgdg_last_prompt_creator_project",
                 "project_folder": layout.root,
                 "context_folder": context, "saved_at": saved_at})
    return marker_path


def save_outputs(payload: dict, output_root: str | None = None) -> dict:
    """Persist a finished Prompt Creator run into the project the Video
    Builder imports from (``:1320-1426``)."""
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    layout = ProjectLayout(project_folder_from_payload(payload,
                                                       output_root))
    layout.ensure_base_folders()
    context = layout.context_folder

    segments = _as_mapping(payload.get("segments"))
    prompts = _as_mapping(payload.get("prompts"))
    motion_notes = _as_mapping(payload.get("i2v_motion_notes"))
    if segments:
        segments = canonical_segments(segments)
    if prompts:
        prompts = canonical_prompts(prompts)
        if is_scene_label_only(prompts):
            raise ValueError(
                "ConceptPrompts only contains scene labels like "
                "SCENE 1. Create or paste real concept prompts before "
                "sending to AI Video Builder.")
        if payload_bool(payload.get("append_subject_to_prompts", True),
                        True):
            prompts = prepend_subject(
                prompts, str(payload.get("subject", "") or ""),
                previous_subjects=[str(payload.get("previous_subject",
                                                   "") or "")])

    files = {}
    for filename, key in (("full_lyrics.txt", "full_lyrics"),
                          ("themestyle.txt", "style_theme"),
                          ("storyconcept.txt", "story_idea"),
                          ("subjectsandscenes.txt",
                           "subject_locations"),
                          ("subject.txt", "subject")):
        path = os.path.join(context, filename)
        with open(path, "w", encoding="utf-8") as handle:
            handle.write(str(payload.get(key, "") or ""))
        files[filename] = path
    if segments:
        files["lyric_segments.json"] = _write_json(
            os.path.join(layout.prompts_folder, "lyric_segments.json"),
            segments)
    if prompts:
        files["ConceptPrompts.txt"] = _write_json(
            os.path.join(context, "ConceptPrompts.txt"), prompts)
    if motion_notes:
        files["I2VMotionNotes.txt"] = _write_json(
            os.path.join(context, "I2VMotionNotes.txt"), motion_notes)

    srt_text = str(payload.get("srt_text", "") or "")
    if segments and not payload_bool(
            payload.get("use_srt_durations", True), True):
        srt_text = fixed_duration_srt(
            segments, float(payload.get("fixed_scene_duration", 4)
                            or 4),
            total_duration_hint=srt_total_duration_hint(srt_text))
    if srt_text.strip():
        with open(layout.srt_path, "w", encoding="utf-8") as handle:
            handle.write(srt_text)
        files["builder_segments.srt"] = layout.srt_path

    saved_at = time.strftime("%Y-%m-%d %H:%M:%S")
    files["prompt_creator_output.json"] = _pointer_paths(
        layout, output_root, saved_at,
        {"type": "vrgdg_prompt_creator_output", "saved_at": saved_at,
         "has_concept_prompts": bool(prompts),
         "has_i2v_motion_notes": bool(motion_notes),
         "has_srt": bool(srt_text.strip())})
    return {"project_folder": layout.root,
            "session_path": layout.session_path,
            "srt_path": layout.srt_path,
            "context_folder": context,
            "prompts_folder": layout.prompts_folder, "files": files}


def draft_path_for(project_folder) -> str:
    return os.path.join(str(project_folder), "prompt_creator_draft.json")


# draft fields persisted verbatim with their defaults (:1471-1504);
# booleans are payload_bool-coerced, the API key is never stored
_DRAFT_FIELDS = (
    ("audio_path", "", str),
    ("min_duration", 4, None),
    ("max_duration", 10, None),
    ("bias", 0.7, None),
    ("duration_preset", "varied_no_repeat", str),
    ("use_srt_durations", True, "bool"),
    ("fixed_scene_duration", 4, None),
    ("empty_segment_text", "Instrumental section.", str),
    ("concept_match_mode", "medium", str),
    ("append_subject_to_prompts", True, "bool"),
    ("repair_lyric_segments", False, "bool"),
    ("full_lyrics", "", str),
    ("style_theme", "", str),
    ("story_idea", "", str),
    ("subject_locations", "", str),
    ("whisper_segments", "", str),
    ("srt_text", "", str),
    ("corrected_segments_text", "", str),
    ("concept_prompts_text", "", str),
    ("i2v_motion_notes_text", "", str),
    ("subject", "", str),
)


def save_draft(payload: dict, output_root: str | None = None) -> dict:
    """Persist the full wizard state and refresh every derived project
    file it carries (``:1465-1594``)."""
    output_root = output_root or DEFAULT_OUTPUT_ROOT
    layout = ProjectLayout(project_folder_from_payload(payload,
                                                       output_root))
    layout.ensure_base_folders()
    context = layout.context_folder
    saved_at = time.strftime("%Y-%m-%d %H:%M:%S")

    draft = {}
    for key, default, kind in _DRAFT_FIELDS:
        value = payload.get(key, default)
        if kind is str:
            value = str(value or default or "")
        elif kind == "bool":
            value = payload_bool(value, default)
        draft[key] = value
    # LLM-runner settings are persisted verbatim so a reference user's
    # draft round-trips (generation itself is out of scope here); the
    # alias chains and defaults are the reference's (:1483-1492), and
    # the API key is never stored
    draft.update({
        "text_gemma_runner": str(payload.get("text_gemma_runner")
                                 or payload.get("text_runner")
                                 or "builtin"),
        "gemma_context_limit": payload.get(
            "gemma_context_limit",
            payload.get("n_ctx", payload.get("llm_max_tokens", 8000))),
        "gemma_output_token_limit": payload.get(
            "gemma_output_token_limit",
            payload.get("llm_max_tokens", 8192)),
        "lm_studio_base_url": str(payload.get("lm_studio_base_url")
                                  or payload.get("lmstudio_base_url")
                                  or "http://127.0.0.1:1234/v1"),
        "lm_studio_model": str(payload.get("lm_studio_model")
                               or payload.get("lmstudio_model") or ""),
        "lm_studio_api_key": "",
        "lm_studio_context_limit": payload.get(
            "lm_studio_context_limit",
            payload.get("lmstudio_context_limit", 32768)),
        "lm_studio_output_token_limit": payload.get(
            "lm_studio_output_token_limit",
            payload.get("lmstudio_output_token_limit",
                        payload.get("llm_max_tokens", 8192))),
        "llm_api_provider": str(payload.get("llm_api_provider")
                                or "openai"),
        "llm_api_model": str(payload.get("llm_api_model") or ""),
    })
    draft["saved_at"] = saved_at
    path = draft_path_for(layout.root)
    _write_json(path, draft)

    files = {}
    for filename, key in (("full_lyrics.txt", "full_lyrics"),
                          ("themestyle.txt", "style_theme"),
                          ("storyconcept.txt", "story_idea"),
                          ("subjectsandscenes.txt",
                           "subject_locations"),
                          ("subject.txt", "subject")):
        file_path = os.path.join(context, filename)
        with open(file_path, "w", encoding="utf-8") as handle:
            handle.write(str(draft[key] or ""))
        files[filename] = file_path

    segments = {}
    if draft["corrected_segments_text"].strip():
        segments = canonical_segments(
            extract_json_object(draft["corrected_segments_text"]))
        if segments:
            files["lyric_segments.json"] = _write_json(
                os.path.join(layout.prompts_folder,
                             "lyric_segments.json"), segments)
    if draft["concept_prompts_text"].strip():
        prompts = canonical_prompts(
            extract_json_object(draft["concept_prompts_text"]))
        if prompts:
            if is_scene_label_only(prompts):
                raise ValueError(
                    "ConceptPrompts only contains scene labels like "
                    "SCENE 1. Create or paste real concept prompts "
                    "before saving.")
            files["ConceptPrompts.txt"] = _write_json(
                os.path.join(context, "ConceptPrompts.txt"), prompts)
    if draft["i2v_motion_notes_text"].strip():
        raw_notes = extract_json_object(draft["i2v_motion_notes_text"])
        notes = {}
        for raw_key, raw_value in (raw_notes or {}).items():
            match = re.search(r"(\d+)", str(raw_key or ""))
            if match:
                notes[f"Motion{int(match.group(1))}"] = \
                    str(raw_value or "").strip()
        if notes:
            files["I2VMotionNotes.txt"] = _write_json(
                os.path.join(context, "I2VMotionNotes.txt"), notes)

    srt_text = draft["srt_text"]
    if segments and not draft["use_srt_durations"]:
        srt_text = fixed_duration_srt(
            segments, draft["fixed_scene_duration"],
            total_duration_hint=srt_total_duration_hint(srt_text))
        draft["srt_text"] = srt_text
        _write_json(path, draft)
    if str(srt_text or "").strip():
        with open(layout.srt_path, "w", encoding="utf-8") as handle:
            handle.write(srt_text)
        files["builder_segments.srt"] = layout.srt_path

    _pointer_paths(layout, output_root, saved_at, {
        "type": "vrgdg_prompt_creator_output", "saved_at": saved_at,
        "from_draft": True,
        "has_concept_prompts": os.path.isfile(
            os.path.join(context, "ConceptPrompts.txt")),
        "has_i2v_motion_notes": os.path.isfile(
            os.path.join(context, "I2VMotionNotes.txt")),
        "has_srt": os.path.isfile(layout.srt_path)})
    return {"project_folder": layout.root, "draft_path": path,
            "draft": draft, "files": files}


def _read_text(path) -> str:
    try:
        with open(path, "r", encoding="utf-8-sig") as handle:
            return handle.read()
    except OSError:
        return ""


def load_draft(payload: dict, output_root: str | None = None) -> dict:
    """Saved draft, or a synthetic one rebuilt from the project's
    context files when only outputs exist (``:1595-1653``)."""
    layout = ProjectLayout(project_folder_from_payload(payload,
                                                       output_root))
    path = draft_path_for(layout.root)
    if os.path.isfile(path):
        draft = _read_json(path)
        return {"project_folder": layout.root, "draft_path": path,
                "found": True,
                "draft": draft if isinstance(draft, dict) else {}}
    context = layout.context_folder
    synthetic = {
        "full_lyrics": _read_text(os.path.join(context,
                                               "full_lyrics.txt")),
        "style_theme": _read_text(os.path.join(context,
                                               "themestyle.txt")),
        "story_idea": _read_text(os.path.join(context,
                                              "storyconcept.txt")),
        "subject_locations": _read_text(
            os.path.join(context, "subjectsandscenes.txt")),
        "srt_text": _read_text(layout.srt_path),
        "corrected_segments_text": _read_text(
            os.path.join(layout.prompts_folder,
                         "lyric_segments.json")),
        "concept_prompts_text": _read_text(
            os.path.join(context, "ConceptPrompts.txt")),
        "i2v_motion_notes_text": _read_text(
            os.path.join(context, "I2VMotionNotes.txt")),
        "subject": _read_text(os.path.join(context,
                                           "subject.txt")).strip(),
    }
    if not any(str(value or "").strip()
               for value in synthetic.values()):
        return {"project_folder": layout.root, "draft_path": path,
                "found": False, "draft": {}}
    audio_folder = os.path.join(layout.root, "audio")
    audio_path = ""
    if os.path.isdir(audio_folder):
        for filename in sorted(os.listdir(audio_folder), reverse=True):
            candidate = os.path.join(audio_folder, filename)
            if os.path.isfile(candidate) \
                    and filename.lower().endswith(AUDIO_EXTENSIONS):
                audio_path = candidate
                break
    synthetic.update(audio_path=audio_path, use_srt_durations=True,
                     fixed_scene_duration=4,
                     empty_segment_text="Instrumental section.",
                     concept_match_mode="medium",
                     append_subject_to_prompts=True)
    return {"project_folder": layout.root, "draft_path": path,
            "found": True, "draft": synthetic, "synthetic": True}


def list_drafts(output_root: str | None = None) -> dict:
    """Every project under the output root with a draft, marker, or
    outputs (``:1654-1716``)."""
    output_dir = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
    projects = []
    if not os.path.isdir(output_dir):
        return {"projects": projects, "output_dir": output_dir}
    for name in sorted(os.listdir(output_dir)):
        folder = os.path.join(output_dir, name)
        if not os.path.isdir(folder):
            continue
        layout = ProjectLayout(folder)
        context = layout.context_folder
        draft_path = draft_path_for(folder)
        marker_path = os.path.join(context,
                                   "prompt_creator_output.json")
        concept_path = os.path.join(context, "ConceptPrompts.txt")
        i2v_path = os.path.join(context, "I2VMotionNotes.txt")
        has_draft = os.path.isfile(draft_path)
        has_marker = os.path.isfile(marker_path)
        has_outputs = (os.path.isfile(concept_path)
                       or os.path.isfile(i2v_path)
                       or os.path.isfile(layout.srt_path))
        if not (has_draft or has_marker or has_outputs):
            continue
        updated = max((os.path.getmtime(candidate) for candidate in
                       (draft_path, marker_path, concept_path,
                        i2v_path, layout.srt_path)
                       if os.path.isfile(candidate)), default=0)
        scene_count = 0
        if os.path.isfile(layout.srt_path):
            scene_count = len(re.findall(
                r"(?m)^\s*\d+\s*$", _read_text(layout.srt_path)))
        if not scene_count and os.path.isfile(concept_path):
            data = _read_json(concept_path)
            if isinstance(data, dict):
                scene_count = len([key for key in data
                                   if re.match(r"^(?:Prompt|prompt)\d+$",
                                               str(key))])
        projects.append({
            "name": name, "project_folder": os.path.abspath(folder),
            "draft_path": os.path.abspath(draft_path)
            if has_draft else "",
            "context_folder": os.path.abspath(context),
            "updated": updated, "scene_count": scene_count,
            "has_draft": has_draft, "has_outputs": has_outputs})
    projects.sort(key=lambda item: item.get("updated", 0),
                  reverse=True)
    return {"projects": projects, "output_dir": output_dir}


def import_audio(project_folder, source_name, data: bytes,
                 output_root: str | None = None) -> dict:
    """Store an uploaded audio file under ``<project>/audio``
    (``:1893-1930``); the route streams the bytes here."""
    layout = ProjectLayout(project_folder_from_payload(
        {"project_folder": project_folder}, output_root))
    layout.ensure_base_folders()
    audio_folder = os.path.join(layout.root, "audio")
    os.makedirs(audio_folder, exist_ok=True)
    stem, ext = os.path.splitext(os.path.basename(
        str(source_name or "prompt_creator_audio.wav")))
    safe_name = (safe_component(stem, "prompt_creator_audio")
                 + (ext.lower() or ".wav"))
    save_path = os.path.abspath(os.path.join(audio_folder, safe_name))
    with open(save_path, "wb") as handle:
        handle.write(data)
    if os.path.getsize(save_path) <= 0:
        raise ValueError(
            "Audio import failed because the saved file is empty.")
    return {"project_folder": layout.root, "audio_path": save_path,
            "audio_name": safe_name}


# ------------------------------------------------------------------
# hidden Whisper workflow builder (``:1815-1891``) + config
# ------------------------------------------------------------------

# the reference's recommended Gemma runtime settings, surfaced verbatim
# by GET /vrgdg/music_prompt_creator/config (``:38-46``, ``:1951-1958``);
# pure data for whatever external LLM executor the user wires up
LLM_SETTINGS = {
    "n_ctx": 14848,
    "max_new_tokens": 32000,
    "temperature": 0.30,
    "top_p": 0.80,
    "n_gpu_layers": 99,
    "n_threads": 8,
    "chat_format": "",
}

_WHISPER_TEMPLATE = "prompt_creator_whisper"


def config(base=None) -> dict:
    """GET config payload (``:1951-1958``): where the hidden Whisper
    template lives plus the recommended LLM settings."""
    from .workflow_runner import template_path
    path = template_path(_WHISPER_TEMPLATE)
    return {
        "workflow_template_path": path,
        "workflow_template_exists": os.path.isfile(path),
        "llm_settings": dict(LLM_SETTINGS),
    }


def safe_file_name(name, fallback: str = "vrgdg_audio.wav") -> str:
    """Windows-reserved-char scrub on a basename (``:471-473``)."""
    safe = re.sub(r'[<>:"/\\|?*]+', "_",
                  os.path.basename(str(name or ""))).strip()
    return safe or fallback


def stage_audio_for_upload(audio_path, base=None) -> tuple[str, str]:
    """Copy the chosen audio into the executor-visible ingest folder
    and return ``(upload_name, staged_path)`` (``:476-507``): the
    LoadAudioUpload node sees a bare filename, the stem splitter an
    absolute path.  Re-copies only when size or mtime drifted."""
    from .workflow_runner import input_dir
    raw_path = str(audio_path or "").strip().strip('"')
    if not raw_path:
        raise ValueError("Choose an audio file before running Prompt "
                         "Creator.")
    source = os.path.abspath(raw_path)
    ingest = input_dir(base)
    if not os.path.isfile(source):
        candidate = os.path.join(ingest, raw_path)
        if not os.path.isfile(candidate):
            raise FileNotFoundError(
                f"Audio file was not found: {raw_path}")
        source = os.path.abspath(candidate)
    ext = os.path.splitext(source)[1] or ".wav"
    safe_name = safe_file_name(
        source, f"vrgdg_prompt_creator_audio{ext}")
    staged = os.path.abspath(os.path.join(ingest, safe_name))
    if source != staged:
        import shutil
        stale = (not os.path.isfile(staged)
                 or os.path.getsize(staged) != os.path.getsize(source)
                 or int(os.path.getmtime(staged))
                 != int(os.path.getmtime(source)))
        if stale:
            shutil.copy2(source, staged)
    return os.path.basename(staged), staged


def _ensure_project_folders(project_folder) -> None:
    """``:440-443`` — project root, context, prompts (and only those)."""
    layout = ProjectLayout(project_folder)
    for folder in (layout.root, layout.context_folder,
                   layout.prompts_folder):
        os.makedirs(folder, exist_ok=True)


def build_whisper_prompt(payload: dict, base=None) -> dict:
    """Patch the hidden Whisper/segmentation workflow template into a
    runnable API prompt (``_build_whisper_workflow_prompt``,
    ``:1815-1891``): stage the audio for the upload node, push the
    lyric/duration/segment-mode settings into their nodes (every patch
    is guarded on node presence exactly like the reference, so template
    edits degrade identically), and name the output SRT with a
    timestamp.  Returns the prompt JSON an external executor runs plus
    the SRT paths the UI polls."""
    import copy as _copy

    from .workflow_runner import load_api_template

    workflow_path, prompt = load_api_template(_WHISPER_TEMPLATE)
    prompt = _copy.deepcopy(prompt)

    project_folder = project_folder_from_payload(payload, base)
    _ensure_project_folders(project_folder)

    audio_path = str(payload.get("audio_path", "")
                     or payload.get("audio_file", "")).strip().strip('"')
    upload_name, staged_path = stage_audio_for_upload(audio_path, base)

    min_duration = float(payload.get("min_duration", 4) or 4)
    max_duration = float(payload.get("max_duration", 10) or 10)
    bias = float(payload.get("bias", 0.7) or 0.7)
    duration_preset = str(payload.get("duration_preset",
                                      "varied_no_repeat")
                          or "varied_no_repeat")
    use_srt_durations = payload_bool(payload.get("use_srt_durations",
                                                 True), True)
    fixed_scene_duration = float(payload.get("fixed_scene_duration", 4)
                                 or 4)
    empty_segment_text = str(payload.get("empty_segment_text",
                                         "Instrumental section.")
                             or "Instrumental section.").strip() \
        or "Instrumental section."
    whisper_language = str(payload.get("whisper_language", "english")
                           or "english").strip() or "english"
    full_lyrics = str(payload.get("full_lyrics", "") or "")
    output_filename = (f"builder_segments_"
                       f"{time.strftime('%Y%m%d_%H%M%S')}.srt")

    def _node(node_id):
        key = str(node_id)
        if key not in prompt:
            raise KeyError(
                f"Hidden Whisper workflow node {key} was not found.")
        return prompt[key].setdefault("inputs", {})

    # audio upload node: 954 with a 964 fallback (``:1842-1845``)
    for upload_id in ("954", "964"):
        if upload_id in prompt:
            _node(upload_id)["audio"] = upload_name
            break

    # stem splitter wants the absolute staged path (``:1847-1850``)
    if "28:114" in prompt:
        _node("28:114")["audio_file_path"] = staged_path
    elif "955" in prompt and "audio_file_path" in _node("955"):
        _node("955")["audio_file_path"] = staged_path

    if "955" in prompt \
            and prompt["955"].get("class_type") == "VRGDG_TextBox":
        _node("955")["text"] = full_lyrics

    if "960" in prompt:
        extractor = _node("960")
        extractor["scene_duration_seconds"] = fixed_scene_duration
        extractor["reference_lyrics"] = full_lyrics
        extractor["language"] = whisper_language
        extractor["strict_reference_text"] = True
        extractor["preserve_nonvocal_segments"] = True
        extractor["alignment_min_words"] = 1

    if "28:933" in prompt:
        _node("28:933")["switch"] = use_srt_durations
    if "28:887" in prompt:
        _node("28:887")["use_srt_durations"] = use_srt_durations
    if "28:920" in prompt:
        _node("28:920")["use_srt_file"] = use_srt_durations
    if "28:949" in prompt:
        _node("28:949")["empty_segment_text"] = empty_segment_text

    duration_id = "28:80" if "28:80" in prompt else "963"
    duration = _node(duration_id)
    duration["min_duration"] = min_duration
    duration["max_duration"] = max_duration
    duration["bias"] = bias
    duration["duration_preset"] = duration_preset
    duration["output_filename"] = output_filename

    return {
        "workflow_template_path": workflow_path,
        "prompt": prompt,
        "project_folder": project_folder,
        "expected_srt_path": ProjectLayout(project_folder).srt_path,
        "source_srt_filename": output_filename,
    }
