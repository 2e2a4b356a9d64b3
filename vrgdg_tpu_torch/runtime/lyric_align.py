"""Timestamped-lyrics scene assembly (reference-lyrics alignment).

A copy of :mod:`vrgdg_tpu.runtime.lyric_align` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

Re-derivation of the deterministic math inside the reference's
``VRGDG_TimestampedLyricsExtractor``
(``HumoAutomationExtra2.py:2122-3145``): everything the
node does *after* stable-ts/Whisper has produced word-timestamped
segments.  The ASR model itself is out of scope (SURVEY §2.5 audio-ML);
an external run satisfying the contract in docs/MIGRATION.md ("External
audio-ML integration contract") supplies the word timeline, and this
module turns it plus the user's reference lyrics into the timestamped
scene JSON the Music Video Builder timeline consumes:

* :func:`reference_units` — reference lyric text → vocal/instrumental
  units per segment mode (``:2211-2254``);
* :func:`align_unit` — cursor-scan fuzzy alignment of one lyric line
  onto the word timeline (``:2455-2512``);
* :func:`acoustic_reference_alignment` — exact reference tokens on
  acoustic word timings via sequence matching + interpolation of
  unrecognized runs (``:2273-2453``);
* :class:`SceneAssembler` — gap insertion, min/max scene duration
  enforcement, vocal/instrumental splitting, overlap repair
  (``:2514-2964``);
* :func:`timestamped_lyrics` — the end-to-end payload builder
  (``:3005-3138`` minus the model invocation).

Output segments carry the reference's exact schema (type/start/end/
duration/text/words/index plus ``timing_warning``/``timing_source``
diagnostics) so payloads interchange with reference-produced ones.
"""

from __future__ import annotations

import difflib
import math
import re
from dataclasses import dataclass, field

__all__ = ["clean_lyric", "normalize_for_match",
           "split_reference_lyrics", "reference_units",
           "word_items_from_segments", "align_unit",
           "acoustic_reference_alignment", "SceneAssembler",
           "segments_from_words", "with_instrumental_gaps",
           "timestamped_lyrics", "SEGMENT_MODES",
           # SRT-window lyric extraction family
           "content_tokens", "clean_aligned_lyric_text",
           "strip_repeated_boundary_word",
           "cleanup_reference_segments", "is_alignment_meaningful",
           "is_meaningful_text", "merge_missing_segments",
           "collect_time_text_chunks", "text_for_window",
           "fixed_scene_windows", "humo_scene_windows", "srt_windows",
           "nonvocal_placeholder", "align_windows_to_reference",
           "format_lyric_segments", "extract_window_lyrics"]

SEGMENT_MODES = ("whisper_chunks", "reference_lines",
                 "exact_reference_lines", "reference_stanzas",
                 "reference_scene_words")

_REPEAT_RUN = re.compile(r"(.)\1{3,}")
_DASHES = re.compile(r"[-—–_,]+")
_SPACES = re.compile(r"\s+")
_NON_WORD = re.compile(r"[^\w\s]", re.UNICODE)
_MARKER_LINE = re.compile(r"\[[^\]]+\]")
_INSTRUMENTAL_MARKER = re.compile(
    r"\[\s*instrumental(?:\s+break)?\s*\]")
_BRACKETED = re.compile(r"\[[^\]]*\]")
_WORD_TOKEN = re.compile(r"[\w]+(?:['’][\w]+)*", re.UNICODE)

_HEADER_LINES = {"lyrics", "full lyrics", "song lyrics",
                 "reference lyrics"}


def clean_lyric(lyric: str) -> str:
    """Lyric text hygiene (reference :1487-1491): runs of 4+ repeated
    characters squash to 3, dash/underscore/comma clusters become
    spaces, whitespace collapses."""
    out = _REPEAT_RUN.sub(lambda hit: hit.group(1) * 3, str(lyric))
    return _SPACES.sub(" ", _DASHES.sub(" ", out)).strip()


def normalize_for_match(text: str) -> str:
    """Matching normalization (reference :1530-1537): casefolded-ish
    lowercase, punctuation → space (Unicode ``\\w`` keeps non-Latin
    letters), underscores out, whitespace collapsed."""
    out = _NON_WORD.sub(" ", str(text).lower()).replace("_", " ")
    return _SPACES.sub(" ", out).strip()


def split_reference_lyrics(reference_lyrics: str) -> list[str]:
    """Reference lyrics → cleaned lines, markers and header labels
    dropped (reference :1539-1553)."""
    lines = []
    for raw in str(reference_lyrics).replace("\r\n", "\n") \
            .replace("\r", "\n").split("\n"):
        cleaned = clean_lyric(_BRACKETED.sub(" ", raw))
        if cleaned and cleaned.lower() not in _HEADER_LINES:
            lines.append(cleaned)
    return lines


def _is_marker(line: str) -> bool:
    return bool(_MARKER_LINE.fullmatch(str(line or "").strip()))


def _is_instrumental_marker(line: str) -> bool:
    clean = str(line or "").strip().lower()
    return _is_marker(clean) and \
        bool(_INSTRUMENTAL_MARKER.fullmatch(clean))


def reference_units(reference_lyrics: str, segment_mode: str,
                    instrumental_text: str) -> list[dict]:
    """Reference lyric text → ordered vocal/instrumental units
    (reference :2211-2254).  Stanza mode merges consecutive lines
    between blank lines / markers into one unit; other modes emit one
    vocal unit per line.  ``[instrumental]`` markers become
    instrumental units; other ``[...]`` markers are dropped."""
    stanzas = str(segment_mode or "whisper_chunks") == \
        "reference_stanzas"
    units: list[dict] = []
    pending: list[str] = []

    def _close_stanza():
        if pending:
            text = clean_lyric(" ".join(pending))
            if text:
                units.append({"type": "vocal", "text": text})
            pending.clear()

    for raw in str(reference_lyrics or "").replace("\r\n", "\n") \
            .replace("\r", "\n").split("\n"):
        line = raw.strip()
        if not line:
            if stanzas:
                _close_stanza()
            continue
        if _is_instrumental_marker(line):
            if stanzas:
                _close_stanza()
            units.append({"type": "instrumental",
                          "text": clean_lyric(line)
                          or instrumental_text})
            continue
        if _is_marker(line):
            if stanzas:
                _close_stanza()
            continue
        cleaned = clean_lyric(line)
        if not cleaned:
            continue
        if stanzas:
            pending.append(cleaned)
        else:
            units.append({"type": "vocal", "text": cleaned})
    if stanzas:
        _close_stanza()
    return units


def segments_from_words(segments) -> list[dict]:
    """Normalize external ASR output (the MIGRATION.md contract: a
    list of segments with optional word timings) into the canonical
    vocal-segment shape (reference ``_segments_from_stable_result``
    :2171-2199, re-targeted at plain dicts instead of stable-ts
    objects)."""
    out = []
    for seg in segments or []:
        words = []
        for word in seg.get("words") or []:
            text = clean_lyric(word.get("word", word.get("text", ""))
                               or "")
            if not text:
                continue
            start = float(word.get("start", 0.0) or 0.0)
            end = float(word.get("end", start) or start)
            words.append({"start": round(start, 3),
                          "end": round(end, 3), "text": text})
        text = clean_lyric(seg.get("text", "") or "")
        if words:
            start = float(words[0]["start"])
            end = float(words[-1]["end"])
            if not text:
                text = clean_lyric(" ".join(w["text"] for w in words))
        else:
            start = float(seg.get("start", 0.0) or 0.0)
            end = float(seg.get("end", start) or start)
        if not text:
            continue
        end = max(end, start)
        out.append({"type": "vocal", "start": round(start, 3),
                    "end": round(end, 3),
                    "duration": round(max(0.0, end - start), 3),
                    "text": text, "words": words})
    out.sort(key=lambda item: (item["start"], item["end"]))
    return out


def word_items_from_segments(segments) -> list[dict]:
    """Flatten the word timeline for alignment (reference
    :2256-2271); each item's ``norm`` is the FIRST normalized token of
    the word (stable-ts occasionally glues words)."""
    items = []
    for segment in segments:
        for word in segment.get("words", []) or []:
            text = clean_lyric(word.get("text", ""))
            norm = normalize_for_match(text)
            if text and norm:
                items.append({
                    "start": float(word.get("start", 0.0)),
                    "end": float(word.get("end",
                                          word.get("start", 0.0))),
                    "text": text, "norm": norm.split()[0]})
    items.sort(key=lambda item: (item["start"], item["end"]))
    return items


def align_unit(unit_text: str, word_items: list[dict],
               cursor: int) -> tuple[dict | None, int]:
    """Cursor-scan one lyric line onto the word timeline (reference
    :2455-2512): exact-token matching with a 3-token lookahead skip
    for words ASR split or dropped; accept at ≥55% token coverage;
    then greedily recover contiguous trailing words."""
    tokens = normalize_for_match(unit_text).split()
    if not tokens or not word_items:
        return None, cursor

    matched: list[int] = []
    token_pos = 0
    scan = max(0, int(cursor))
    while scan < len(word_items) and token_pos < len(tokens):
        norm = word_items[scan]["norm"]
        if norm == tokens[token_pos]:
            matched.append(scan)
            token_pos += 1
        elif matched and norm in tokens[token_pos:token_pos + 3]:
            while token_pos < len(tokens) and \
                    norm != tokens[token_pos]:
                token_pos += 1
            if token_pos < len(tokens):
                matched.append(scan)
                token_pos += 1
        scan += 1

    need = max(1, min(len(tokens), math.ceil(len(tokens) * 0.55)))
    if not matched or len(matched) < need:
        return None, cursor

    while token_pos < len(tokens):
        follower = matched[-1] + 1
        if follower >= len(word_items) or \
                word_items[follower]["norm"] != tokens[token_pos]:
            break
        matched.append(follower)
        token_pos += 1

    words = [{"start": round(float(word_items[idx]["start"]), 3),
              "end": round(float(word_items[idx]["end"]), 3),
              "text": word_items[idx]["text"]} for idx in matched]
    start = float(word_items[matched[0]]["start"])
    end = float(word_items[matched[-1]]["end"])
    return ({"type": "vocal", "start": round(start, 3),
             "end": round(end, 3),
             "duration": round(max(0.0, end - start), 3),
             "text": clean_lyric(unit_text), "words": words},
            matched[-1] + 1)


# ---------------------------------------------------------------------------
# acoustic reference-word alignment (reference :2273-2453)
# ---------------------------------------------------------------------------

def _alnum_norm(text) -> str:
    return "".join(ch for ch in str(text or "").casefold()
                   if ch.isalnum())


def acoustic_reference_alignment(units, stable_segments,
                                 total_duration) -> dict:
    """Put exact reference tokens on acoustic word timings (reference
    :2273-2453).  A global sequence match pins recognized words to
    their acoustic timestamps; a bounded fuzzy pass (ratio ≥ 0.68)
    repairs ASR misspellings; unrecognized runs interpolate compactly
    beside their line's recognized neighbors so silence never
    stretches a word into another scene."""
    ref_tokens = []
    for unit_index, unit in enumerate(units):
        if unit.get("type") != "vocal":
            continue
        for text in _WORD_TOKEN.findall(str(unit.get("text", ""))):
            norm = _alnum_norm(text)
            if norm:
                ref_tokens.append({"unit_index": unit_index,
                                   "text": text, "norm": norm})
    if not ref_tokens:
        return {}

    acoustic = []
    for segment in stable_segments:
        for word in segment.get("words", []) or []:
            text = str(word.get("text", "") or "").strip()
            norm = _alnum_norm(text)
            start = float(word.get("start", 0.0) or 0.0)
            end = float(word.get("end", start) or start)
            if text and norm and math.isfinite(start) \
                    and math.isfinite(end):
                acoustic.append({"text": text, "norm": norm,
                                 "start": max(0.0, start),
                                 "end": max(start, end)})
    acoustic.sort(key=lambda item: (item["start"], item["end"]))

    pinned: dict[int, int] = {}
    if acoustic:
        matcher = difflib.SequenceMatcher(
            None, [item["norm"] for item in ref_tokens],
            [item["norm"] for item in acoustic], autojunk=False)
        for block in matcher.get_matching_blocks():
            for offset in range(block.size):
                pinned[block.a + offset] = block.b + offset

        # bounded fuzzy repair of ASR spellings, order-preserving
        used = set(pinned.values())
        for ref_index, token in enumerate(ref_tokens):
            if ref_index in pinned:
                continue
            lower = max((w for r, w in pinned.items()
                         if r < ref_index), default=-1) + 1
            upper = min((w for r, w in pinned.items()
                         if r > ref_index), default=len(acoustic))
            best, best_score = None, 0.0
            for word_index in range(lower, upper):
                if word_index in used:
                    continue
                score = difflib.SequenceMatcher(
                    None, token["norm"],
                    acoustic[word_index]["norm"]).ratio()
                if score > best_score:
                    best, best_score = word_index, score
            if best is not None and best_score >= 0.68:
                pinned[ref_index] = best
                used.add(best)

    timed: list[dict | None] = [None] * len(ref_tokens)
    for ref_index, word_index in pinned.items():
        hit = acoustic[word_index]
        timed[ref_index] = {"start": float(hit["start"]),
                            "end": float(hit["end"]),
                            "text": ref_tokens[ref_index]["text"]}

    # interpolate only tokens the ASR failed to recognize
    pos = 0
    while pos < len(timed):
        if timed[pos] is not None:
            pos += 1
            continue
        run_start = pos
        while pos < len(timed) and timed[pos] is None:
            pos += 1
        run_end = pos
        before = timed[run_start - 1] if run_start > 0 else None
        after = timed[run_end] if run_end < len(timed) else None
        count = run_end - run_start
        run_units = {ref_tokens[i]["unit_index"]
                     for i in range(run_start, run_end)}
        before_same = before is not None and \
            ref_tokens[run_start - 1]["unit_index"] in run_units
        after_same = after is not None and \
            ref_tokens[run_end]["unit_index"] in run_units
        span = max(0.3, count * 0.35)
        if before and after:
            left_bound = float(before["end"])
            right_bound = max(left_bound, float(after["start"]))
            if after_same and not before_same:
                # missing words open a line: keep beside the next
                # recognized word, not stretched over the pause
                right = right_bound
                left = max(left_bound, right - span)
            elif before_same and not after_same:
                left = left_bound
                right = min(right_bound, left + span)
            else:
                left, right = left_bound, right_bound
        elif before:
            left = float(before["end"])
            right = min(float(total_duration), left + span)
        elif after:
            right = float(after["start"])
            left = max(0.0, right - span)
        else:
            left = 0.0
            right = min(float(total_duration), span)
        step = max(0.02, (right - left) / max(1, count))
        for offset, ref_index in enumerate(range(run_start, run_end)):
            w_start = min(float(total_duration), left + offset * step)
            w_end = min(float(total_duration),
                        max(w_start + 0.02,
                            left + (offset + 1) * step))
            timed[ref_index] = {
                "start": w_start, "end": w_end,
                "text": ref_tokens[ref_index]["text"]}

    grouped: dict[int, list[dict]] = {}
    for ref_index, word in enumerate(timed):
        grouped.setdefault(ref_tokens[ref_index]["unit_index"],
                           []).append(
            {"start": round(float(word["start"]), 3),
             "end": round(float(word["end"]), 3),
             "text": word["text"]})

    aligned = {}
    for unit_index, words in grouped.items():
        words.sort(key=lambda item: (item["start"], item["end"]))
        start = float(words[0]["start"])
        end = max(start, float(words[-1]["end"]))
        aligned[unit_index] = {
            "type": "vocal", "start": round(start, 3),
            "end": round(end, 3),
            "duration": round(max(0.0, end - start), 3),
            "text": clean_lyric(units[unit_index].get("text", "")),
            "words": words,
            "timing_source": "acoustic_transcription"}
    return aligned


# ---------------------------------------------------------------------------
# scene assembly (reference :2514-2964)
# ---------------------------------------------------------------------------

@dataclass
class SceneAssembler:
    """Timeline assembler: splits long scenes, inserts instrumental
    gaps, repairs overlaps, and fills unaligned lyric lines
    (reference ``_segments_from_reference_units``, restructured from
    nested closures into a configured object)."""

    total_duration: float
    instrumental_text: str = "[instrumental]"
    min_gap_seconds: float = 1.0
    min_scene_seconds: float = 1.0
    max_scene_seconds: float = 8.0
    vocal_tail_padding_seconds: float = 0.6
    include_instrumental_gaps: bool = True
    exact_reference_lines: bool = False
    preserve_reference_units: bool = False
    timeline: list[dict] = field(default_factory=list)

    def __post_init__(self):
        self.min_gap = max(0.0, float(self.min_gap_seconds))
        self.min_scene = max(0.1, float(self.min_scene_seconds))
        self.max_scene = max(self.min_scene,
                             float(self.max_scene_seconds))
        self.tail = max(0.0, float(self.vocal_tail_padding_seconds))
        self.label = clean_lyric(self.instrumental_text) \
            or "[instrumental]"
        self.total = float(self.total_duration)

    # -- helpers ----------------------------------------------------

    def _instrumental(self, start, end, warning="") -> dict:
        piece = {"type": "instrumental", "start": round(start, 3),
                 "end": round(end, 3),
                 "duration": round(max(0.0, end - start), 3),
                 "text": self.label, "words": []}
        if warning:
            piece["timing_warning"] = warning
        return piece

    def split_instrumental(self, segment) -> list[dict]:
        """Page a long instrumental into max-scene slices; a final
        sliver shorter than min-scene merges into the previous slice
        (reference :2631-2657).  Exact mode never splits."""
        if self.exact_reference_lines:
            return [segment]
        start = float(segment.get("start", 0.0))
        end = float(segment.get("end", start))
        if end - start <= self.max_scene:
            return [segment]
        slices = []
        cursor = start
        while cursor < end - 0.001:
            slice_end = min(end, cursor + self.max_scene)
            leftover = end - slice_end
            if 0 < leftover < self.min_scene and slice_end > cursor:
                slice_end = end
            piece = dict(segment)
            piece["start"] = round(cursor, 3)
            piece["end"] = round(slice_end, 3)
            piece["duration"] = round(max(0.0, slice_end - cursor), 3)
            piece["words"] = []
            if slices:
                piece["timing_warning"] = ("Long instrumental section "
                                           "split by max scene "
                                           "duration.")
            slices.append(piece)
            cursor = slice_end
        return slices

    def _word_groups(self, words, start):
        """Cluster a scene's timed words at ≥min-gap silences
        (reference :2702-2715)."""
        ordered = sorted(words, key=lambda w: (
            float(w.get("start", 0.0)),
            float(w.get("end", w.get("start", 0.0)))))
        groups: list[list[dict]] = []
        current: list[dict] = []
        last_end = None
        for word in ordered:
            w_start = float(word.get("start", start))
            if current and last_end is not None and \
                    w_start - last_end >= self.min_gap:
                groups.append(current)
                current = []
            current.append(word)
            last_end = float(word.get("end", w_start))
        if current:
            groups.append(current)
        return groups

    def split_vocal(self, segment) -> list[dict]:
        """Split a vocal scene at word-timing silences and the max
        scene duration, inserting instrumentals in the carved gaps
        (reference :2659-2799)."""
        start = float(segment.get("start", 0.0))
        end = float(segment.get("end", start))
        duration = max(0.0, end - start)
        words = segment.get("words", []) or []

        if self.preserve_reference_units:
            piece = dict(segment)
            if words:
                ordered = sorted(words, key=lambda w: (
                    float(w.get("start", start)),
                    float(w.get("end", w.get("start", start)))))
                start = max(0.0, float(ordered[0].get("start", start)))
                raw_end = float(ordered[-1].get(
                    "end", ordered[-1].get("start", start)))
                end = min(self.total,
                          max(start + 0.001, raw_end + self.tail))
                piece["words"] = ordered
            piece["start"] = round(start, 3)
            piece["end"] = round(end, 3)
            piece["duration"] = round(max(0.0, end - start), 3)
            return [piece]

        if not words:
            if duration <= self.max_scene:
                return [segment]
            piece = dict(segment)
            piece["start"] = round(max(start, end - self.max_scene), 3)
            piece["end"] = round(end, 3)
            piece["duration"] = round(max(0.0, float(piece["end"])
                                          - float(piece["start"])), 3)
            piece["timing_warning"] = (
                "Long vocal section was limited by max scene duration "
                "because no word timing was available.")
            lead = float(piece["start"]) - start
            if self.include_instrumental_gaps and lead >= self.min_gap:
                return self.split_instrumental(self._instrumental(
                    start, float(piece["start"]),
                    "Inserted before a long approximate vocal "
                    "section.")) + [piece]
            return [piece]

        groups = self._word_groups(words, start)
        if not groups:
            return [segment]
        pieces: list[dict] = []

        first_word = max(start, min(float(group[0].get("start", start))
                                    for group in groups if group))
        if self.include_instrumental_gaps and \
                first_word - start >= self.min_gap:
            pieces.extend(self.split_instrumental(self._instrumental(
                start, first_word,
                "Inserted before timed vocal words inside a long "
                "scene.")))

        for group_index, group in enumerate(groups):
            g_start = max(start, float(group[0].get("start", start)))
            raw_g_end = float(group[-1].get(
                "end", group[-1].get("start", g_start)))
            next_start = None
            if group_index + 1 < len(groups):
                next_start = max(start, float(
                    groups[group_index + 1][0].get("start", raw_g_end)))
            limit = next_start if next_start is not None \
                else max(end, raw_g_end + self.tail)
            g_end = min(limit, raw_g_end + self.tail)

            if group_index > 0:
                prior = groups[group_index - 1]
                prior_raw = min(end, float(prior[-1].get(
                    "end", prior[-1].get("start", g_start))))
                prior_end = min(g_start, prior_raw + self.tail)
                if self.include_instrumental_gaps and \
                        g_start - prior_end >= self.min_gap:
                    pieces.extend(self.split_instrumental(
                        self._instrumental(
                            prior_end, g_start,
                            "Inserted between separated timed vocal "
                            "words.")))

            # page the group at the max scene duration
            chunks = []
            chunk: list[dict] = []
            chunk_start = g_start
            prev_word_end = g_start
            for word in group:
                w_start = float(word.get("start", chunk_start))
                w_end = float(word.get("end", w_start))
                if chunk and w_end - chunk_start > self.max_scene:
                    chunks.append((chunk_start,
                                   min(g_end,
                                       prev_word_end + self.tail),
                                   chunk))
                    chunk = []
                    chunk_start = w_start
                chunk.append(word)
                prev_word_end = w_end
            if chunk:
                chunks.append((chunk_start, g_end, chunk))

            rewrite = len(groups) > 1 or len(chunks) > 1 \
                or duration > self.max_scene
            for c_start, c_end, c_words in chunks:
                if c_end - c_start < self.min_scene:
                    c_end = min(end, c_start + self.min_scene)
                piece = dict(segment)
                piece["start"] = round(c_start, 3)
                piece["end"] = round(c_end, 3)
                piece["duration"] = round(max(0.0, c_end - c_start), 3)
                piece["words"] = c_words
                if rewrite:
                    piece["text"] = clean_lyric(" ".join(
                        str(word.get("text", "")).strip()
                        for word in c_words))
                    piece["timing_warning"] = (
                        "Vocal scene split by timed word gaps or max "
                        "scene duration.")
                pieces.append(piece)

        last_raw = max(float(group[-1].get(
            "end", group[-1].get("start", end)))
            for group in groups if group)
        tail_end = last_raw + self.tail
        if self.include_instrumental_gaps and \
                end - tail_end >= self.min_gap:
            pieces.extend(self.split_instrumental(self._instrumental(
                tail_end, end,
                "Inserted after timed vocal words inside a long "
                "scene.")))
        return pieces

    def _append_piece(self, piece):
        """Stitch one piece onto the timeline: fill or absorb gaps,
        repair overlaps (reference ``append_piece`` :2801-2852)."""
        p_start = float(piece.get("start", 0.0))
        if self.timeline:
            previous = self.timeline[-1]
            prev_end = float(previous.get("end", 0.0))
            if p_start - prev_end > 0.001:
                if self.include_instrumental_gaps and \
                        p_start - prev_end >= self.min_gap:
                    for gap in self.split_instrumental(
                            self._instrumental(
                                prev_end, p_start,
                                "Inserted to close a timeline gap.")):
                        self.timeline.append(gap)
                else:
                    previous["end"] = round(p_start, 3)
                    previous["duration"] = round(max(
                        0.0, p_start
                        - float(previous.get("start", 0.0))), 3)
            elif prev_end - p_start > 0.001:
                if self.preserve_reference_units:
                    # tail padding may reach into the next unit; trim
                    # the previous scene so units never overlap
                    previous["end"] = round(max(
                        float(previous.get("start", 0.0)), p_start), 3)
                    previous["duration"] = round(max(
                        0.0, float(previous["end"])
                        - float(previous.get("start", 0.0))), 3)
                else:
                    piece = dict(piece)
                    piece["start"] = round(prev_end, 3)
                    piece["duration"] = round(max(
                        0.0, float(piece.get("end", prev_end))
                        - prev_end), 3)
        elif p_start > 0.001 and self.include_instrumental_gaps:
            if p_start >= self.min_gap:
                for gap in self.split_instrumental(self._instrumental(
                        0.0, p_start,
                        "Inserted before the first timed segment.")):
                    self.timeline.append(gap)
            else:
                piece = dict(piece)
                piece["start"] = 0.0
                piece["duration"] = round(max(
                    0.0, float(piece.get("end", 0.0))), 3)
        if float(piece.get("end", piece.get("start", 0.0))) \
                - float(piece.get("start", 0.0)) > 0.001:
            self.timeline.append(piece)

    def add(self, segment):
        """Split a segment by type and stitch every piece (reference
        ``append_timed_segment`` :2854-2862)."""
        if segment.get("type") == "instrumental":
            pieces = self.split_instrumental(segment)
        elif segment.get("type") == "vocal":
            pieces = self.split_vocal(segment)
        else:
            pieces = [segment]
        for piece in pieces:
            self._append_piece(piece)

    # -- unit walk ---------------------------------------------------

    def _estimate_duration(self, unit_text, word_items) -> float:
        """Text-derived duration from the observed word cadence
        (reference :2549-2561): median onset spacing in [0.08, 1.5] s,
        0.4 s/word fallback."""
        token_count = max(1, len(normalize_for_match(unit_text)
                                 .split()))
        cadences = sorted(
            later["start"] - earlier["start"]
            for earlier, later in zip(word_items, word_items[1:])
            if 0.08 <= later["start"] - earlier["start"] <= 1.5)
        per_word = cadences[len(cadences) // 2] if cadences else 0.4
        return max(0.15, token_count * per_word + self.tail)

    def _fill_exact_missing(self, units, aligned, word_items):
        """Exact mode: unaligned lines get text-derived estimates
        anchored beside the closest trusted neighbors, scaled to fit
        (reference :2563-2629)."""
        runs: list[list[int]] = []
        run: list[int] = []
        for idx, unit in enumerate(units):
            if unit.get("type") == "vocal" and idx not in aligned:
                run.append(idx)
            elif run:
                runs.append(run)
                run = []
        if run:
            runs.append(run)

        for missing in runs:
            before = None
            for idx in range(missing[0] - 1, -1, -1):
                if units[idx].get("type") != "vocal":
                    break
                if idx in aligned:
                    before = aligned[idx]
                    break
            after = None
            for idx in range(missing[-1] + 1, len(units)):
                if units[idx].get("type") != "vocal":
                    break
                if idx in aligned:
                    after = aligned[idx]
                    break
            left = float(before["end"]) if before is not None else 0.0
            right = float(after["start"]) if after is not None \
                else self.total
            right = max(left, min(self.total, right))
            estimates = [self._estimate_duration(
                units[idx].get("text", ""), word_items)
                for idx in missing]
            available = max(0.0, right - left)
            desired = sum(estimates)
            if desired <= available and before is None \
                    and after is not None:
                cursor_time = right - desired
            else:
                cursor_time = left
            scale = min(1.0, available / desired) if desired > 0.0 \
                else 0.0
            for idx, estimate in zip(missing, estimates):
                seg_end = min(right, cursor_time + estimate * scale)
                if seg_end <= cursor_time + 0.001:
                    break
                aligned[idx] = {
                    "type": "vocal", "start": round(cursor_time, 3),
                    "end": round(seg_end, 3),
                    "duration": round(max(0.0,
                                          seg_end - cursor_time), 3),
                    "text": clean_lyric(units[idx].get("text", "")),
                    "words": [],
                    "timing_warning": (
                        "Could not align this exact reference lyric "
                        "line; text-derived timing was used near the "
                        "closest detected lyric.")}
                cursor_time = seg_end

    def assemble(self, units, stable_segments,
                 prealigned=None) -> list[dict]:
        """Walk the reference units in order, aligning vocals onto the
        word timeline and spanning instrumentals between them
        (reference :2514-2964)."""
        word_items = word_items_from_segments(stable_segments)
        aligned = dict(prealigned or {})
        cursor = 0
        for idx, unit in enumerate(units):
            if unit.get("type") != "vocal" or idx in aligned:
                continue
            segment, cursor = align_unit(unit.get("text", ""),
                                         word_items, cursor)
            if segment is not None:
                aligned[idx] = segment

        if self.exact_reference_lines:
            self._fill_exact_missing(units, aligned, word_items)

        def _next_aligned_start(after_idx):
            for next_idx in range(after_idx + 1, len(units)):
                hit = aligned.get(next_idx)
                if hit is not None:
                    return float(hit["start"])
            return None

        for idx, unit in enumerate(units):
            prev_end = float(self.timeline[-1]["end"]) \
                if self.timeline else 0.0
            if unit.get("type") == "vocal":
                segment = aligned.get(idx)
                if segment is None:
                    next_start = _next_aligned_start(idx)
                    if next_start is not None and \
                            next_start > prev_end:
                        end = next_start
                    else:
                        fallback = self._estimate_duration(
                            unit.get("text", ""), word_items) \
                            if self.exact_reference_lines \
                            else max(self.min_scene, self.min_gap, 1.0)
                        end = min(self.total, prev_end + fallback)
                    start = prev_end
                    if not self.exact_reference_lines and \
                            end - start > self.max_scene:
                        vocal_start = max(start, end - self.max_scene)
                        if self.include_instrumental_gaps and \
                                vocal_start - start >= self.min_gap:
                            self.add(self._instrumental(
                                start, vocal_start,
                                "Inserted because the lyric line "
                                "timing was approximate and exceeded "
                                "the max scene duration."))
                        start = vocal_start
                    segment = {
                        "type": "vocal", "start": round(start, 3),
                        "end": round(end, 3),
                        "duration": round(max(0.0, end - start), 3),
                        "text": clean_lyric(unit.get("text", "")),
                        "words": [],
                        "timing_warning": (
                            "Could not align this reference lyric "
                            "line; approximate timing was used.")}
                elif self.include_instrumental_gaps:
                    start = float(segment.get("start", prev_end))
                    if start - prev_end >= self.min_gap:
                        self.add(self._instrumental(prev_end, start))
                self.add(segment)
                continue

            # instrumental unit: span to the next aligned vocal
            next_start = _next_aligned_start(idx)
            if next_start is None:
                next_start = self.total
            start = prev_end
            end = max(start, min(self.total, next_start))
            warning = ""
            if end <= start:
                end = min(self.total,
                          start + max(self.min_gap, 1.0))
                warning = ("No clear instrumental gap was found; "
                           "approximate timing was used.")
            piece = {"type": "instrumental", "start": round(start, 3),
                     "end": round(end, 3),
                     "duration": round(max(0.0, end - start), 3),
                     "text": clean_lyric(unit.get("text", ""))
                     or self.instrumental_text,
                     "words": []}
            if warning:
                piece["timing_warning"] = warning
            self.add(piece)

        if self.include_instrumental_gaps:
            cursor_end = float(self.timeline[-1]["end"]) \
                if self.timeline else 0.0
            if self.total - cursor_end >= self.min_gap:
                self.add(self._instrumental(
                    cursor_end, self.total,
                    "Inserted after the final timed lyric to cover "
                    "the remaining audio."))
        return self.timeline


def with_instrumental_gaps(segments, total_duration, instrumental_text,
                           min_gap_seconds, min_scene_seconds=1.0,
                           max_scene_seconds=8.0) -> list[dict]:
    """Insert paged instrumental fillers into ≥min-gap silences
    around whisper-chunk segments (reference :2966-3003)."""
    min_gap = max(0.0, float(min_gap_seconds))
    min_scene = max(0.1, float(min_scene_seconds))
    max_scene = max(min_scene, float(max_scene_seconds))
    label = clean_lyric(instrumental_text) or "[instrumental]"
    output: list[dict] = []
    cursor = 0.0

    def _fill(start, end):
        current = float(start)
        end = float(end)
        while current < end - 0.001:
            nxt = min(end, current + max_scene)
            leftover = end - nxt
            if 0 < leftover < min_scene and nxt > current:
                nxt = end
            output.append({"type": "instrumental",
                           "start": round(current, 3),
                           "end": round(nxt, 3),
                           "duration": round(nxt - current, 3),
                           "text": label, "words": []})
            current = nxt

    for segment in segments:
        start = float(segment.get("start", 0.0))
        if start - cursor >= min_gap:
            _fill(cursor, start)
        output.append(segment)
        cursor = max(cursor, float(segment.get("end", start)))
    if float(total_duration) - cursor >= min_gap:
        _fill(cursor, float(total_duration))
    return output


# ---------------------------------------------------------------------------
# SRT-window lyric extraction (reference :1462-2119)
# ---------------------------------------------------------------------------
# The "Manual Lyrics Extractor" family: slice the track into scene
# windows (from an SRT or a fixed duration), read the ASR text falling
# in each window, and map the user's pasted reference lyrics onto the
# vocal windows.  Output is the editable ``lyricSegmentN=`` sheet.

_STOPWORDS = frozenset((
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for",
    "from", "in", "into", "is", "it", "me", "my", "no", "not", "of",
    "on", "or", "so", "the", "then", "to", "up", "when", "with",
    "you", "your"))

_HEADER_WORDS = re.compile(
    r"\b(?:full\s+lyrics|song\s+lyrics|reference\s+lyrics|lyrics)\b",
    re.IGNORECASE)

_ALNUM_TOKEN = re.compile(r"[a-z0-9]+")
_ASCII_TOKEN = re.compile(r"[A-Za-z0-9]+")
_APOSTROPHE_TOKEN = re.compile(r"[A-Za-z0-9']+")

_FILLER_TOKENS = frozenset((
    "oh", "ooh", "oooh", "ooooh", "ah", "aah", "aaah", "aww", "yeah",
    "yah", "ya", "uh", "um", "hmm", "mm", "la", "na", "woah", "whoa",
    "ok", "okay", "hey", "yo"))
_FILLER_SHAPE = re.compile(
    r"(?:a+h+|o+h+|u+h+|h*m+|la+|na+|ya+h*|wo+a+h+)")

# the BeatV9 legacy placeholder rotation (reference :2063)
_V9_FILLERS = ("ooohhh", "yeah, yeah", "oohh yeah", "ahh ahh",
               "la la")


def content_tokens(text) -> list[str]:
    """Lowercase alphanumeric tokens minus stopwords (reference
    :1560-1571)."""
    return [token for token in
            _ALNUM_TOKEN.findall(str(text or "").lower())
            if token not in _STOPWORDS]


def clean_aligned_lyric_text(text) -> str:
    """Strip ``[...]`` markers and lyric-sheet header words, then the
    standard hygiene (reference :1555-1558)."""
    out = _BRACKETED.sub(" ", str(text or ""))
    return clean_lyric(_HEADER_WORDS.sub(" ", out))


def strip_repeated_boundary_word(previous, current) -> str:
    """Drop a window-opening word that duplicates the previous
    window's final word — ASR chunk overlap artifact (reference
    :1573-1584)."""
    prev_tokens = _APOSTROPHE_TOKEN.findall(str(previous or ""))
    current_text = str(current or "").strip()
    cur_tokens = _APOSTROPHE_TOKEN.findall(current_text)
    if not prev_tokens or not cur_tokens:
        return current_text
    if prev_tokens[-1].lower().strip("'") != \
            cur_tokens[0].lower().strip("'"):
        return current_text
    return re.sub(r"^\s*" + re.escape(cur_tokens[0]) + r"\b\s*", "",
                  current_text, count=1, flags=re.IGNORECASE).strip()


def cleanup_reference_segments(segments, reference_lines) -> list[str]:
    """Post-alignment hygiene (reference :1586-1613): boundary-word
    dedup between consecutive windows, and blanking of windows whose
    content shares no token with the reference lyrics (hallucinated
    ASR)."""
    if not reference_lines:
        return list(segments)
    known = set(content_tokens(" ".join(reference_lines)))
    cleaned: list[str] = []
    for segment in segments:
        text = clean_aligned_lyric_text(segment)
        if cleaned:
            text = strip_repeated_boundary_word(cleaned[-1], text)
        tokens = content_tokens(text)
        if tokens and not any(token in known for token in tokens):
            text = ""
        cleaned.append(text)
    return cleaned


def is_alignment_meaningful(text, min_words: int = 2) -> bool:
    """A window counts as vocal when it has ≥min_words non-filler
    tokens; filler vocalizations match by shape so ASR spelling
    variants of \"ahhh\" still read as filler (reference
    :1615-1641)."""
    clean = clean_lyric(str(text or ""))
    if not clean:
        return False
    tokens = [token.lower() for token in _ASCII_TOKEN.findall(clean)]
    if not tokens:
        return False
    meaningful = [token for token in tokens
                  if token not in _FILLER_TOKENS
                  and not _FILLER_SHAPE.fullmatch(token)]
    return len(meaningful) >= max(1, int(min_words))


def is_meaningful_text(text, aggressiveness: int = 1) -> bool:
    """Fill-decision signal ladder (reference :1781-1794): level 1
    needs a ≥2-char token, level 2 any token, level 3 any content."""
    clean = clean_lyric(text)
    if not clean:
        return False
    tokens = _ASCII_TOKEN.findall(clean)
    if aggressiveness <= 1:
        return any(len(token) >= 2 for token in tokens)
    if aggressiveness == 2:
        return bool(tokens)
    return bool(clean)


def merge_missing_segments(primary, backup,
                           aggressiveness: int = 1):
    """Recover low-signal windows from the backup transcription;
    level 3 additionally borrows the nearest meaningful neighbor
    (reference :1796-1840).  Returns (merged, filled_backup,
    filled_neighbor)."""
    merged: list[str] = []
    filled_backup = 0
    shared = min(len(primary), len(backup))
    for pos in range(shared):
        first = clean_lyric(primary[pos])
        second = clean_lyric(backup[pos])
        if not is_meaningful_text(first, aggressiveness) and \
                is_meaningful_text(second, aggressiveness):
            merged.append(second)
            filled_backup += 1
        else:
            merged.append(first)
    if len(primary) > shared:
        merged.extend(primary[shared:])
    elif len(backup) > shared:
        merged.extend(backup[shared:])

    filled_neighbor = 0
    if aggressiveness >= 3:
        for pos in range(len(merged)):
            if is_meaningful_text(merged[pos], aggressiveness):
                continue
            neighbor = None
            for left in range(pos - 1, -1, -1):
                if is_meaningful_text(merged[left], aggressiveness):
                    neighbor = merged[left]
                    break
            if neighbor is None:
                for right in range(pos + 1, len(merged)):
                    if is_meaningful_text(merged[right],
                                          aggressiveness):
                        neighbor = merged[right]
                        break
            if neighbor is not None:
                merged[pos] = neighbor
                filled_neighbor += 1
    return merged, filled_backup, filled_neighbor


def collect_time_text_chunks(segments) -> list[tuple]:
    """Flatten ASR segments into (start, end, text) chunks — word
    granularity when word timings exist, whole segments otherwise
    (reference :1504-1524, re-targeted at contract dicts)."""
    chunks = []
    for seg in segments or []:
        words = seg.get("words")
        if words:
            for word in words:
                text = str(word.get("word", word.get("text", ""))
                           or "")
                if not text:
                    continue
                start = float(word.get("start", 0.0))
                chunks.append((start,
                               float(word.get("end", start)),
                               text.strip()))
        elif seg.get("text"):
            start = float(seg.get("start", 0.0))
            chunks.append((start, float(seg.get("end", start)),
                           str(seg["text"]).strip()))
    chunks.sort(key=lambda chunk: chunk[0])
    return chunks


def text_for_window(chunks, start, end) -> str:
    """Concatenate every chunk overlapping [start, end) (reference
    :1526-1528)."""
    return clean_lyric(" ".join(
        text for c_start, c_end, text in chunks
        if not (c_end <= start or c_start >= end)))


def fixed_scene_windows(total_samples: int, sample_rate: int,
                        fps: int, scene_duration_seconds: float
                        ) -> list[tuple[float, float]]:
    """Fixed scene windows via the frame-quantized sample math the
    reference uses when no SRT is given (reference :1879-1886)."""
    frames_per_scene = int(round(int(fps)
                                 * float(scene_duration_seconds)))
    samples_per_scene = int(frames_per_scene * sample_rate
                            / int(fps) + 0.5)
    count = math.ceil(total_samples / samples_per_scene)
    return [((index * samples_per_scene) / sample_rate,
             min((index + 1) * samples_per_scene, total_samples)
             / sample_rate)
            for index in range(count)]


def humo_scene_windows(total_samples: int, sample_rate: int,
                       scene_duration_seconds: float = 4.0
                       ) -> list[tuple[float, float]]:
    """Fixed scene windows with the HuMo ``4N+1`` frame quantization at
    25 fps — the plain Manual Lyrics Extractor's segmentation
    (``HumoAutomationExtra2.py:222-236``)."""
    from .audio_toolkit import adjust_frames_humo

    fps = 25
    frames = adjust_frames_humo(
        int(round(fps * float(scene_duration_seconds))))
    samples_per_scene = int(frames * sample_rate / fps + 0.5)
    count = math.ceil(total_samples / samples_per_scene)
    return [((index * samples_per_scene) / sample_rate,
             min((index + 1) * samples_per_scene, total_samples)
             / sample_rate)
            for index in range(count)]


def srt_windows(srt_text: str) -> list[tuple[float, float]]:
    """SRT cue (start, end) pairs in seconds (reference :1462-1485,
    taking text instead of a path).

    Unlike the reference's parser (which only ever sees its own
    numbered SRT files), this accepts arbitrary user text: the
    timestamp line is located by its ``-->`` marker, so index-less
    cues parse and malformed blocks are skipped instead of raising.
    """
    windows = []
    for block in str(srt_text).strip().split("\n\n"):
        stamp_line = next((line for line in block.splitlines()
                           if " --> " in line), None)
        if stamp_line is None:
            continue
        start_str, end_str = stamp_line.split(" --> ")[:2]

        def _seconds(stamp):
            hours, minutes, rest = stamp.strip().split(":")
            secs, millis = rest.split(",")
            return int(hours) * 3600 + int(minutes) * 60 \
                + float(secs) + float(millis) / 1000.0

        try:
            windows.append((_seconds(start_str), _seconds(end_str)))
        except ValueError:
            continue
    return windows


def nonvocal_placeholder(seg_index: int, asr_text: str = "",
                         legacy_beat: bool = False) -> str:
    """Text for a non-vocal window: the cleaned ASR residue (usually
    empty — inventing filler shifts strict timelines, reference
    :1643-1648); the legacy BeatV9 mode rotates canned fillers
    (reference :2059-2066)."""
    clean = clean_lyric(str(asr_text or ""))
    if clean or not legacy_beat:
        return clean
    return _V9_FILLERS[max(0, seg_index) % len(_V9_FILLERS)]


def _window_reference_score(window_text, reference_text) -> float:
    """Blended similarity for the DP alignment (reference
    :1674-1684): 65% character-sequence ratio + 35% content-token
    recall of the reference line."""
    seq = difflib.SequenceMatcher(
        None, normalize_for_match(window_text),
        normalize_for_match(reference_text)).ratio()
    window_set = set(content_tokens(window_text))
    ref_set = set(content_tokens(reference_text))
    recall = len(window_set & ref_set) / max(1, len(ref_set)) \
        if ref_set else 0.0
    return seq * 0.65 + recall * 0.35


def align_windows_to_reference(asr_segments, reference_lines,
                               strict_reference_text: bool = True,
                               preserve_nonvocal_segments: bool = True,
                               alignment_min_words: int = 2,
                               legacy_beat: bool = False) -> list[str]:
    """Map reference lyric lines onto scene windows (reference
    :1650-1779; BeatV9 variant :2068-2119).

    Strict mode runs an order-preserving DP over the *meaningful*
    windows only (skipping a suspicious ASR window costs 0.08, skipping
    a reference line 0.60) so one noisy window cannot shift every later
    lyric.  Loose mode walks a monotonic cursor with a local
    position-estimated search.  ``legacy_beat`` reproduces the V9
    behavior: strict assignment is purely chronological and non-vocal
    windows get rotating canned fillers.
    """
    if not reference_lines:
        return list(asr_segments)

    def _meaningful(text):
        return is_alignment_meaningful(text, alignment_min_words)

    if strict_reference_text and not legacy_beat:
        vocal_indices = [index for index, text
                         in enumerate(asr_segments)
                         if _meaningful(text)]
        windows = [asr_segments[index] for index in vocal_indices]
        w_count, r_count = len(windows), len(reference_lines)

        NEG = float("-inf")
        scores = [[NEG] * (r_count + 1) for _ in range(w_count + 1)]
        back = [[None] * (r_count + 1) for _ in range(w_count + 1)]
        scores[0][0] = 0.0
        for w_pos in range(w_count + 1):
            for r_pos in range(r_count + 1):
                here = scores[w_pos][r_pos]
                if not math.isfinite(here):
                    continue
                if w_pos < w_count and \
                        here - 0.08 > scores[w_pos + 1][r_pos]:
                    scores[w_pos + 1][r_pos] = here - 0.08
                    back[w_pos + 1][r_pos] = (w_pos, r_pos, False)
                if r_pos < r_count and \
                        here - 0.60 > scores[w_pos][r_pos + 1]:
                    scores[w_pos][r_pos + 1] = here - 0.60
                    back[w_pos][r_pos + 1] = (w_pos, r_pos, False)
                if w_pos < w_count and r_pos < r_count:
                    gain = here + _window_reference_score(
                        windows[w_pos], reference_lines[r_pos])
                    if gain > scores[w_pos + 1][r_pos + 1]:
                        scores[w_pos + 1][r_pos + 1] = gain
                        back[w_pos + 1][r_pos + 1] = (w_pos, r_pos,
                                                      True)

        matched: dict[int, int] = {}
        w_pos, r_pos = w_count, r_count
        while w_pos or r_pos:
            step = back[w_pos][r_pos]
            if step is None:
                break
            prev_w, prev_r, is_match = step
            if is_match:
                matched[vocal_indices[prev_w]] = prev_r
            w_pos, r_pos = prev_w, prev_r

        out = []
        for index, text in enumerate(asr_segments):
            if index in matched:
                out.append(reference_lines[matched[index]])
            elif preserve_nonvocal_segments and not _meaningful(text):
                out.append(nonvocal_placeholder(index, text,
                                                legacy_beat))
            else:
                out.append("")
        return out

    out = []
    cursor = 0
    r_count = len(reference_lines)
    seg_count = max(1, len(asr_segments))
    for index, text in enumerate(asr_segments):
        if preserve_nonvocal_segments and not _meaningful(text):
            out.append(nonvocal_placeholder(index, text, legacy_beat))
            continue
        if legacy_beat and strict_reference_text:
            # V9: purely chronological, clamped to the final line
            out.append(reference_lines[min(cursor, r_count - 1)])
            cursor += 1
            continue
        window_norm = normalize_for_match(text)
        anchor = int((index / seg_count) * r_count)
        lo = max(cursor, anchor - 3)
        hi = min(r_count - 1, anchor + 8)
        best, best_score = None, -1.0
        for candidate in range(lo, hi + 1):
            score = difflib.SequenceMatcher(
                None, window_norm,
                normalize_for_match(reference_lines[candidate])
            ).ratio()
            if score > best_score:
                best, best_score = candidate, score
        if best is None:
            if cursor < r_count:
                best = cursor
            else:
                out.append(clean_lyric(text))
                continue
        if best_score < 0.22 and cursor < r_count:
            best = cursor
        out.append(reference_lines[best])
        cursor = min(r_count, best + 1)
    return out


def format_lyric_segments(texts) -> str:
    """The editable output sheet (reference :2037-2039)."""
    lines = [f"# Lyrics to fix: ({len(texts)} segments)", ""]
    lines.extend(f"lyricSegment{index}={text}"
                 for index, text in enumerate(texts, 1))
    return "\n".join(lines)


def extract_window_lyrics(primary_segments, windows,
                          reference_lyrics="", backup_segments=None,
                          native_align: bool = False,
                          strict_reference_text: bool = True,
                          fill_aggressiveness: int = 1,
                          preserve_nonvocal_segments: bool = True,
                          alignment_min_words: int = 2,
                          legacy_beat: bool = False) -> dict:
    """The Manual Lyrics Extractor decision tree (reference
    :1903-2042) on externally-produced ASR output.

    ``primary_segments`` follows the MIGRATION.md contract (word
    timings preferred).  ``native_align=True`` marks it as the output
    of a forced reference alignment (stable-ts ``model.align``) —
    enabling the backup-fill / cleanup / strict-reassignment branch;
    ``backup_segments`` is the plain transcription those passes read
    (without it the fills degrade gracefully, like the reference when
    no window is low-signal).  Returns ``{texts, sheet, windows}``.
    """
    reference_lines = split_reference_lyrics(reference_lyrics) \
        if str(reference_lyrics or "").strip() else []
    chunks = collect_time_text_chunks(primary_segments)
    aggressiveness = int(fill_aggressiveness)

    if not reference_lines:
        texts = [text_for_window(chunks, start, end)
                 for start, end in windows]
        return {"texts": texts,
                "sheet": format_lyric_segments(texts),
                "windows": list(windows)}

    texts = [clean_aligned_lyric_text(
        text_for_window(chunks, start, end))
        for start, end in windows]

    if not native_align:
        texts = align_windows_to_reference(
            texts, reference_lines,
            strict_reference_text=bool(strict_reference_text),
            preserve_nonvocal_segments=bool(
                preserve_nonvocal_segments),
            alignment_min_words=int(alignment_min_words),
            legacy_beat=legacy_beat)
        return {"texts": texts,
                "sheet": format_lyric_segments(texts),
                "windows": list(windows)}

    backup_texts = None
    low_signal = sum(1 for text in texts
                     if not is_meaningful_text(text, aggressiveness))
    if low_signal and backup_segments is not None:
        backup_chunks = collect_time_text_chunks(backup_segments)
        backup_texts = [clean_aligned_lyric_text(
            text_for_window(backup_chunks, start, end))
            for start, end in windows]
        texts, _, _ = merge_missing_segments(texts, backup_texts,
                                             aggressiveness)

    texts = cleanup_reference_segments(texts, reference_lines)

    if strict_reference_text and not legacy_beat:
        if backup_texts is None and backup_segments is not None:
            backup_chunks = collect_time_text_chunks(backup_segments)
            backup_texts = [clean_aligned_lyric_text(
                text_for_window(backup_chunks, start, end))
                for start, end in windows]
        if backup_texts is not None:
            texts = align_windows_to_reference(
                backup_texts, reference_lines,
                strict_reference_text=True,
                preserve_nonvocal_segments=bool(
                    preserve_nonvocal_segments),
                alignment_min_words=int(alignment_min_words))
    return {"texts": texts, "sheet": format_lyric_segments(texts),
            "windows": list(windows)}


def timestamped_lyrics(stable_segments, total_duration,
                       reference_lyrics="",
                       segment_mode="whisper_chunks",
                       include_instrumental_gaps=True,
                       instrumental_text="[instrumental]",
                       min_gap_seconds=1.0, min_scene_seconds=1.0,
                       max_scene_seconds=8.0,
                       vocal_tail_padding_seconds=0.6,
                       mode="external", model_name="",
                       language="auto") -> dict:
    """Build the timestamped-lyrics payload from externally-produced
    word-timestamped segments (reference ``extract_timestamped_lyrics``
    :3005-3138 minus the stable-ts invocation — see the MIGRATION.md
    external audio-ML contract for the input schema).

    ``stable_segments`` accepts either the canonical vocal-segment
    shape or raw ASR dicts (run through :func:`segments_from_words`
    first when in doubt)."""
    segment_mode = str(segment_mode or "whisper_chunks")
    if segment_mode not in SEGMENT_MODES:
        segment_mode = "whisper_chunks"
    units = reference_units(reference_lyrics, segment_mode,
                            instrumental_text) \
        if segment_mode != "whisper_chunks" else []

    if units:
        use_acoustic = segment_mode == "reference_scene_words"
        assembler = SceneAssembler(
            total_duration=total_duration,
            instrumental_text=instrumental_text,
            min_gap_seconds=min_gap_seconds,
            min_scene_seconds=min_scene_seconds,
            max_scene_seconds=max_scene_seconds,
            vocal_tail_padding_seconds=vocal_tail_padding_seconds,
            include_instrumental_gaps=include_instrumental_gaps,
            exact_reference_lines=(
                segment_mode == "exact_reference_lines"),
            preserve_reference_units=segment_mode in {
                "reference_lines", "exact_reference_lines",
                "reference_stanzas", "reference_scene_words"})
        prealigned = acoustic_reference_alignment(
            units, stable_segments, total_duration) \
            if use_acoustic else None
        segments = assembler.assemble(units, stable_segments,
                                      prealigned)
    else:
        segments = list(stable_segments)
        if include_instrumental_gaps:
            segments = with_instrumental_gaps(
                segments, total_duration, instrumental_text,
                min_gap_seconds, min_scene_seconds, max_scene_seconds)

    for position, segment in enumerate(segments, 1):
        segment["index"] = position

    return {"version": 1, "mode": str(mode),
            "segment_mode": segment_mode,
            "model_name": str(model_name or ""),
            "language": str(language or "auto"),
            "duration": round(float(total_duration), 3),
            "segment_count": len(segments),
            "segments": segments}
