"""Prompt splitter family + small text builders (HumoAutomationExtra2).

A copy of :mod:`vrgdg_tpu.runtime.prompt_splitters` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

The reference ships seven near-duplicate splitter nodes
(``HumoAutomationExtra2.py``): ForManual ``:261-304``,
ForFMML ``:503-546``, PromptSplitter4 ``:552-607``, PromptSplitter2
``:852-925``, ForFL ``:933-982``, SplitPrompt_T2I_I2V ``:987-1035``,
SmartSplitTextTwo ``:1106-1144``; plus the template builder
``:1039-1102`` and the lyrics/emotion merger ``:786-846``.  Each
splitter differs only in hygiene, key ordering, value normalization,
slot count, and index windowing — so here the family is one engine
driven by a variant table instead of seven classes.  Behavior parity
per variant is locked by oracle fuzz (tests/test_prompt_splitters.py).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Callable

__all__ = ["SPLIT_VARIANTS", "split_prompts", "split_t2i_i2v",
           "split_text_two", "build_prompt_template",
           "merge_lyrics_emotions"]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _digits_of(key) -> str:
    return "".join(ch for ch in str(key) if ch.isdigit())


def _digit_order(key) -> int:
    """Numeric fragment anywhere in the key (``Prompt#3`` → 3); keys
    without digits sort first at 0 (reference :285, :525, :958)."""
    digits = _digits_of(key)
    return int(digits) if digits else 0


def _strip_fences(text: str) -> str:
    """Backtick hygiene shared by the 4/2-way splitters (reference
    :566-577): markdown fences and stray backticks removed outright."""
    text = re.sub(r"```json", "", text, flags=re.IGNORECASE)
    return text.replace("```", "").replace("`", "").strip()


def _wrap_braces(text: str) -> str:
    """PromptSplitter2's repair (reference :872-883): bare
    ``"Prompt1": "text"`` payloads gain enclosing braces."""
    if text.startswith("{") and text.endswith("}"):
        return text
    if ":" in text and not text.startswith("{"):
        return "{ " + text.rstrip(", ") + " }"
    return text


def _fence_block_only(text: str) -> str:
    """T2I/I2V hygiene (reference :1008-1017): drop fence lines only
    when the payload actually starts fenced."""
    text = text.strip()
    if not text.startswith("```"):
        return text
    lines = text.splitlines()
    if lines and lines[0].startswith("```"):
        lines = lines[1:]
    if lines and lines[-1].strip() == "```":
        lines = lines[:-1]
    return "\n".join(lines).strip()


def _join_lists(value) -> str:
    return "\n".join(value) if isinstance(value, list) else str(value)


@dataclass(frozen=True)
class _Variant:
    slots: int
    windowed: bool = False           # index * slots pages into the list
    hygiene: Callable | None = None
    dict_only: bool = False          # lists rejected as input roots
    numbered_only: bool = False      # drop keys without digits
    natural_fallback: bool = False   # unnumbered dicts keep insert order
    normalize: Callable | None = None  # per-value; None = pass through
    dict_values_only: bool = False   # keep only dict-typed entries


SPLIT_VARIANTS = {
    # reference :276-304 — raw values, 16-slot pages
    "manual": _Variant(slots=16, windowed=True),
    # reference :518-546 — list values joined by newlines, str() others
    "fmml": _Variant(slots=16, windowed=True, normalize=_join_lists),
    # reference :579-607 — fence hygiene, numbered keys only, 4 slots
    "quad": _Variant(slots=4, hygiene=_strip_fences, dict_only=True,
                     numbered_only=True),
    # reference :885-925 — fence hygiene + brace repair, numbered keys
    # when present else natural order, first two values
    "pair": _Variant(slots=2, dict_only=True, natural_fallback=True,
                     hygiene=lambda t: _wrap_braces(_strip_fences(t))),
    # reference :948-982 — dict-valued entries re-dumped as JSON text
    "first_last": _Variant(
        slots=16, windowed=True, dict_only=True, dict_values_only=True,
        normalize=lambda v: json.dumps(v, ensure_ascii=False)),
}


def split_prompts(variant: str, json_string: str,
                  index: int = 0) -> list:
    """Run one splitter variant; always returns exactly
    ``variant.slots`` outputs, empty strings on any parse failure
    (every reference splitter swallows errors into empties)."""
    spec = SPLIT_VARIANTS[variant]
    try:
        text = spec.hygiene(json_string) if spec.hygiene \
            else json_string
        data = json.loads(text)
        if isinstance(data, dict):
            keys = list(data)
            numbered = [key for key in keys if _digits_of(key)]
            if spec.numbered_only or (spec.natural_fallback
                                      and numbered):
                # numbered modes DROP unnumbered keys (ref :592-595,
                # :906-912); the pair splitter only when any key is
                # numbered at all
                keys = sorted(numbered, key=_digit_order)
            elif not spec.natural_fallback:
                # page splitters keep unnumbered keys, sorting them
                # first at 0 (ref :285)
                keys = sorted(keys, key=_digit_order)
            values = [data[key] for key in keys]
        elif isinstance(data, list) and not spec.dict_only:
            values = data
        else:
            values = []
        if spec.dict_values_only:
            values = [value for value in values
                      if isinstance(value, dict)]
        if spec.normalize:
            values = [spec.normalize(value) for value in values]
        start = index * spec.slots if spec.windowed else 0
        return [values[start + pos] if start + pos < len(values)
                else "" for pos in range(spec.slots)]
    except Exception:
        return [""] * spec.slots


def split_t2i_i2v(prompt_json: str) -> tuple[str, str]:
    """T2I/I2V prompt pair from one JSON payload (reference
    :1001-1035); the i2v value may be a list of motion lines."""
    if not prompt_json:
        return "", ""
    try:
        data = json.loads(_fence_block_only(prompt_json))
        if not isinstance(data, dict):
            return "", ""
        i2v = data.get("i2v", "")
        if isinstance(i2v, list):
            i2v = "\n".join(str(line).strip() for line in i2v if line)
        else:
            i2v = str(i2v).strip()
        return str(data.get("t2i", "")).strip(), i2v
    except Exception:
        return "", ""


def split_text_two(text: str) -> tuple[str, str]:
    """Halve a text block (reference :1120-1144): first real newline
    wins; otherwise split between sentences nearest the middle;
    otherwise mid-character.  Literal ``\\n`` escapes count as
    newlines (the reference normalizes ComfyUI STRING transport)."""
    if not text:
        return "", ""
    normalized = (text.replace("\\r\\n", "\n").replace("\\n", "\n")
                  .replace("\r\n", "\n").replace("\r", "\n"))
    if "\n" in normalized:
        first, rest = normalized.split("\n", 1)
        return first.strip(), rest.strip()
    sentences = re.split(r"(?<=[.!?])\s+", normalized)
    if len(sentences) <= 1:
        mid = len(normalized) // 2
        return normalized[:mid].strip(), normalized[mid:].strip()
    mid = len(sentences) // 2
    return (" ".join(sentences[:mid]).strip(),
            " ".join(sentences[mid:]).strip())


def build_prompt_template(sections) -> str:
    """Join (heading, text) sections into ``### heading`` blocks,
    skipping empties (reference :1078-1102)."""
    return "\n\n".join(f"### {heading}\n{body.strip()}"
                       for heading, body in sections
                       if body and body.strip())


_EMOTION_LINE = re.compile(r"emotionSegment(\d+)\s*=\s*(.+)")
_LYRIC_LINE = re.compile(r"lyricSegment(\d+)\s*=\s*(.+)")


def merge_lyrics_emotions(lyrics_text: str, emotion_text: str) -> str:
    """Merge ``lyricSegmentN = …`` and ``emotionSegmentN = …`` line
    sets into the combined per-segment format (reference :806-846);
    segments without a matching emotion read ``Unknown``."""
    emotions = {}
    for line in str(emotion_text).splitlines():
        line = line.strip()
        hit = _EMOTION_LINE.match(line) \
            if line.startswith("emotionSegment") else None
        if hit:
            emotions[int(hit.group(1))] = hit.group(2).strip()
    merged = []
    for line in str(lyrics_text).splitlines():
        line = line.strip()
        hit = _LYRIC_LINE.match(line) \
            if line.startswith("lyricSegment") else None
        if hit:
            index = int(hit.group(1))
            merged.append(
                f"lyricSegment{index}-emotion="
                f"{emotions.get(index, 'Unknown')} "
                f"\"{hit.group(2).strip()}\"")
    header = f"# Lyrics with emotions ({len(merged)} segments)"
    return "\n".join([header, ""] + merged)


def pick_cycled_prompt(json_string: str, index: int) -> str:
    """One prompt per run, cycling through the set
    (``GeneralVideoNodes.py:1898-1942``, PromptSplitter_General):
    numbered-key dicts order numerically, lists stay in order, and the
    index wraps modulo the count.  Errors and empties yield ""."""
    try:
        data = json.loads(json_string)
        if isinstance(data, dict):
            values = [data[key] for key
                      in sorted(data, key=_digit_order)]
        elif isinstance(data, list):
            values = data
        else:
            values = []
        if not values:
            return ""
        return values[int(index) % len(values)]
    except Exception:
        return ""


def split_pipe_or_paragraphs(text: str, slots: int = 16) -> list[str]:
    """Pipe-separated prompts when pipes exist, paragraph blocks
    otherwise (``HumoAutomation.py:1692-1709``, PromptSplitterV3);
    always exactly ``slots`` outputs."""
    body = str(text).strip()
    if "|" in body:
        parts = [part.strip() for part in body.split("|")
                 if part.strip()]
    else:
        parts = [part.strip()
                 for part in re.split(r"\n\s*\n", body)
                 if part.strip()]
    return (parts + [""] * slots)[:slots]


THEME_SECTIONS = ("character_description", "song_theme_style",
                  "environment", "lighting", "camera_motion",
                  "physical_interaction", "facial_expression",
                  "shots", "outfit_rules", "character_visibility")


def split_theme_context(context_block: str) -> dict:
    """Parse a themed context block into the builder's ten prompt
    sections (``HumoAutomation.py:1094-1171``, ThemeSplitter): a line
    whose letters-only normalization equals a section name opens that
    section; following lines append space-joined.  Text before any
    header is dropped, like the reference."""
    def _norm(line):
        return re.sub(r"[^a-z]", "", str(line).strip().lower())

    headers = {_norm(name): name for name in THEME_SECTIONS}
    sections = {name: "" for name in THEME_SECTIONS}
    current = None
    for raw in str(context_block).splitlines():
        line = raw.strip()
        if not line:
            continue
        name = headers.get(_norm(line))
        if name is not None:
            current = name
        elif current:
            sections[current] = f"{sections[current]} {line}".strip()
    return sections


def format_emotion_segments(emotions) -> str:
    """The emotion timeline sheet consumed by
    :func:`merge_lyrics_emotions` (reference
    ``HumoAutomationExtra2.py:786-792`` — the speech-emotion model
    itself is out of scope; an external classifier supplies one label
    per scene window)."""
    emotions = list(emotions)
    lines = [f"# Emotion timeline ({len(emotions)} segments)", ""]
    lines.extend(f"emotionSegment{index}={emotion}"
                 for index, emotion in enumerate(emotions, 1))
    return "\n".join(lines)
