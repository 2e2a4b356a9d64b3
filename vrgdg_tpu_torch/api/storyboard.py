"""Storyboard builder state store (the non-LLM storyboard backend).

A copy of :mod:`vrgdg_tpu.api.storyboard` (which cannot be imported
without JAX): every function keeps its original's source.

Framework-native re-derivation of the reference storyboard's
persistence layer (``VRGDG_StoryboardBuilderNodes.py``):
the storyboard.json schema normalizers, load/save, reference-image
import, the prompt export files, and the deterministic video-prompt
facial-requirement pass the save path applies.

Parity targets:
- folders + text cleaning: ``:164-199``,
- schema normalizers (scene, story layer, script import, reference
  catalog, speaker assignments): ``:292-733``,
- default document + load/save: ``:735-826``,
- prompt export files: ``:826-900``,
- facial-requirement enforcement + predicates: ``:940-1030``,
- reference-image import: ``:462-514``.

Excluded (LLM): every ``gemma_*`` / ``story_*`` / ``*_dialogue_scenes``
generation route (``:2946-3009``) — the prompt *templates* they drive
are model instructions, not backend behavior.

Design departure: the reference normalizes each field with a
hand-unrolled block of ``_clean_scene_text(scene.get(a) or
scene.get(b) ...)`` calls; here the alias chains live in declarative
tables consumed by one generic normalizer, so the schema is data, not
code. Field names, alias priorities, length limits, and enum fallbacks
are the reference's exactly — a storyboard.json written by the ComfyUI
pack normalizes identically here.
"""

from __future__ import annotations

import os
import itertools
import re
from datetime import datetime

from .builder import _read_json, _write_json, data_url_bytes
from .paths import DEFAULT_OUTPUT_ROOT  # noqa: F401  (route default root)

STORYBOARD_FILENAME = "storyboard.json"


def clean_text(value, limit: int = 12000) -> str:
    text = str(value or "").replace("\r\n", "\n").replace("\r", "\n")
    return text.strip()[:limit]


def speed_value(value, fallback: int = 4) -> int:
    try:
        return max(0, min(10, int(float(value))))
    except (TypeError, ValueError):
        return fallback


def scene_number(scene, fallback) -> int:
    value = scene.get("scene_number", scene.get("number", fallback))
    try:
        return max(1, int(value))
    except (TypeError, ValueError):
        return max(1, int(fallback or 1))


def normalize_tags(value) -> list[str]:
    if isinstance(value, list):
        return [str(item or "").strip()[:120] for item in value
                if str(item or "").strip()][:12]
    text = str(value or "").strip()
    if not text:
        return []
    return [item.strip()[:120] for item in re.split(r"[,;\n]+", text)
            if item.strip()][:12]


def _pick(source, keys, default=""):
    """First non-empty value along an alias chain."""
    for key in keys:
        value = source.get(key)
        if value:
            return value
    return default


def _text(source, keys, limit, default=""):
    return clean_text(_pick(source, keys, default), limit)


def _position(source, keys) -> str:
    raw = str(_pick(source, keys, "start")).strip().lower()
    return "end" if raw == "end" else "start"


def normalize_performance_mode(value) -> str:
    text = re.sub(r"[\s-]+", "_", str(value or "").strip().lower())
    if text in {"speaking", "short_film", "dialogue", "dialog"}:
        return "speaking"
    if text in {"no_lip_sync", "nolipsync", "no_lipsync", "no_sync",
                "silent", "visual_only"}:
        return "no_lip_sync"
    return "singing"


def normalize_planning_mode(value) -> str:
    clean = str(value or "").strip().lower().replace("-", "_") \
        .replace(" ", "_")
    return "fully_custom" if clean in {"fully_custom", "custom"} \
        else "guided_film"


# ------------------------------------------------------------------
# references / story layer / script import
# ------------------------------------------------------------------

def _normalize_reference_image(value) -> dict:
    image = value if isinstance(value, dict) else {}
    return {"path": clean_text(image.get("path"), 2000),
            "data": clean_text(image.get("data"), 400000),
            "name": clean_text(image.get("name"), 240)}


def normalize_reference_item(value, fallback_name="Reference",
                             fallback_id="ref") -> dict:
    item = value if isinstance(value, dict) else {}
    raw_voice = item.get("minimax_voice") or item.get("miniMaxVoice")
    raw_voice = raw_voice if isinstance(raw_voice, dict) else {}
    return {
        "id": _text(item, ("id",), 160, fallback_id),
        "name": _text(item, ("name",), 240, fallback_name),
        "description": _text(item, ("description",), 4000),
        "minimax_voice": {
            "preset_id": _text(raw_voice, ("preset_id", "presetId",
                                           "preset"), 120, "none"),
            "gender": _text(raw_voice, ("gender",), 40),
            "preset_name": _text(raw_voice, ("preset_name",
                                             "presetName", "name"),
                                 240),
            "description": _text(raw_voice,
                                 ("description",
                                  "voice_description",
                                  "voiceDescription"), 2000),
        },
        "trigger_phrase": _text(item, ("trigger_phrase", "trigger",
                                       "Trigger"), 1200),
        "trigger_position": _position(item,
                                      ("trigger_position",
                                       "triggerPosition",
                                       "trigger_placement")),
        "image": _normalize_reference_image(
            item.get("image") if isinstance(item.get("image"), dict)
            else {}),
    }


def _normalize_reference_items(value, cap=12, name="Subject",
                               prefix="subject") -> list[dict]:
    if not isinstance(value, list):
        return []
    return [normalize_reference_item(item, f"{name} {index + 1}",
                                     f"{prefix}_{index + 1}")
            for index, item in enumerate(value[:cap])
            if isinstance(item, dict)]


def _normalize_speaker_assignments(value) -> list[dict]:
    if not isinstance(value, list):
        return []
    out = []
    for index, item in enumerate(value[:40]):
        if not isinstance(item, dict):
            continue
        out.append({
            "id": _text(item, ("id", "cue_id"), 160,
                        f"speaker_cue_{index + 1}"),
            "speaker_id": _text(item, ("speaker_id", "speakerId",
                                       "subject_id"), 160),
            "speaker_name": _text(item, ("speaker_name", "speakerName",
                                         "speaker", "character"), 240),
            "text": _text(item, ("text", "dialogue", "line", "lyric"),
                          2000),
        })
    return out


def normalize_reference_catalog(value) -> dict:
    source = value if isinstance(value, dict) else {}
    return {
        "subjects": _normalize_reference_items(
            source.get("subjects"), 180, "Subject", "subject"),
        "locations": _normalize_reference_items(
            source.get("locations"), 180, "Location", "location"),
        "trigger_position": _position(
            source, ("trigger_position", "triggerPosition",
                     "trigger_placement")),
        "subject_trigger_position": _position(
            source, ("subject_trigger_position",
                     "subjectTriggerPosition", "trigger_position")),
        "location_trigger_position": _position(
            source, ("location_trigger_position",
                     "locationTriggerPosition", "trigger_position")),
    }


def normalize_story_layer(value) -> dict:
    source = value if isinstance(value, dict) else {}
    try:
        strength = int(float(source.get(
            "lyric_story_strength",
            source.get("lyricStoryStrength", 7))))
    except (TypeError, ValueError):
        strength = 7
    return {
        "enabled": bool(source.get("enabled", True)),
        "overall_story_idea": _text(
            source, ("overall_story_idea", "overallStoryIdea",
                     "story_idea", "storyIdea"), 4000),
        "user_story_arc": _text(source, ("user_story_arc",
                                         "userStoryArc"), 8000),
        "song_story_brief": _text(source, ("song_story_brief",
                                           "songStoryBrief"), 4000),
        "lyric_story_strength": max(0, min(10, strength)),
    }


def _clean_str_list(values, limit) -> list[str]:
    return [clean_text(item, limit) for item in (values or [])
            if clean_text(item, limit)]


def normalize_script_import(value) -> dict:
    """Dialogue-script import state: cues, speaker matches, and the
    planned scene split (``:628-733``)."""
    source = value if isinstance(value, dict) else {}
    cues = []
    raw_cues = source.get("cues") \
        if isinstance(source.get("cues"), list) else []
    for index, item in enumerate(raw_cues[:1000], start=1):
        if not isinstance(item, dict):
            continue
        alias = _text(item, ("speaker_alias", "speaker",
                             "speaker_name"), 240)
        text = _text(item, ("text", "dialogue", "line"), 4000)
        if not alias or not text:
            continue
        cues.append({
            "index": int(item.get("index") or index),
            "line_number": int(item.get("line_number") or 0),
            "scene_index": int(item.get("scene_index") or 0),
            "scene_label": _text(item, ("scene_label",), 240),
            "speaker": alias,
            "speaker_alias": alias,
            "speaker_id": _text(item, ("speaker_id",
                                       "reference_subject_id"), 180),
            "speaker_name": _text(item, ("speaker_name",
                                         "reference_subject_name"),
                                  240, alias),
            "reference_subject_id": _text(
                item, ("reference_subject_id", "speaker_id"), 180),
            "reference_subject_name": _text(
                item, ("reference_subject_name", "speaker_name"), 240),
            "speaker_match_method": _text(item, ("speaker_match_method",),
                                          40, "manual"),
            "text": text,
            "word_count": int(item.get("word_count")
                              or len(text.split())),
        })

    matches = []
    raw_matches = source.get("speaker_matches") \
        if isinstance(source.get("speaker_matches"), list) else []
    for item in raw_matches[:180]:
        if not isinstance(item, dict):
            continue
        alias = _text(item, ("speaker_alias", "speaker"), 240)
        if not alias:
            continue
        matches.append({
            "speaker_alias": alias,
            "reference_subject_id": _text(
                item, ("reference_subject_id", "speaker_id"), 180),
            "reference_subject_name": _text(
                item, ("reference_subject_name", "speaker_name"), 240),
            "match_method": _text(item, ("match_method",), 40,
                                  "manual"),
        })

    try:
        max_seconds = float(source.get("maximum_scene_seconds")
                            or source.get("max_scene_seconds") or 8)
    except (TypeError, ValueError):
        max_seconds = 8.0
    max_seconds = max(3.0, min(15.0, max_seconds))

    plan_source = source.get("scene_plan") \
        if isinstance(source.get("scene_plan"), dict) else {}
    planned = []
    raw_scenes = plan_source.get("scenes") \
        if isinstance(plan_source.get("scenes"), list) else []
    for scene_index, scene in enumerate(raw_scenes[:240], start=1):
        if not isinstance(scene, dict):
            continue
        assignments = []
        raw_assignments = scene.get("speaker_assignments") \
            if isinstance(scene.get("speaker_assignments"), list) \
            else []
        for cue in raw_assignments[:80]:
            if not isinstance(cue, dict):
                continue
            dialogue = _text(cue, ("text", "dialogue"), 4000)
            if not dialogue:
                continue
            assignments.append({
                "speaker_id": _text(cue, ("speaker_id",
                                          "reference_subject_id"),
                                    180),
                "speaker_name": _text(cue, ("speaker_name",
                                            "speaker_alias"), 240,
                                      "Speaker"),
                "speaker_alias": _text(cue, ("speaker_alias",
                                             "speaker_name"), 240,
                                       "Speaker"),
                "text": dialogue,
                "source_cue_index": int(cue.get("source_cue_index")
                                        or 0),
                "part_index": int(cue.get("part_index") or 1),
                "part_count": int(cue.get("part_count") or 1),
                "planned_start_seconds": float(
                    cue.get("planned_start_seconds") or 0),
                "planned_end_seconds": float(
                    cue.get("planned_end_seconds") or 0),
                "estimated_spoken_seconds": float(
                    cue.get("estimated_spoken_seconds") or 0),
            })
        if not assignments:
            continue
        planned.append({
            "index": int(scene.get("index") or scene_index),
            "label": _text(scene, ("label",), 240,
                           f"Script Segment {scene_index}"),
            "source_scene_index": int(scene.get("source_scene_index")
                                      or 0),
            "source_scene_label": _text(scene, ("source_scene_label",),
                                        240),
            "continuation_of_previous": bool(
                scene.get("continuation_of_previous")),
            "duration_seconds": float(scene.get("duration_seconds")
                                      or 0),
            "timeline_start_seconds": float(
                scene.get("timeline_start_seconds") or 0),
            "timeline_end_seconds": float(
                scene.get("timeline_end_seconds") or 0),
            "participant_ids": _clean_str_list(
                scene.get("participant_ids"), 180),
            "participant_names": _clean_str_list(
                scene.get("participant_names"), 240),
            "speaker_assignments": assignments,
        })

    return {
        "enabled": bool(source.get("enabled", True)) and bool(cues),
        "authoritative": bool(source.get("authoritative", True)),
        "format": _text(source, ("format",), 40, "text"),
        "raw_text": _text(source, ("raw_text", "rawText"), 100000),
        "imported_at": _text(source, ("imported_at", "importedAt"), 80),
        "maximum_scene_seconds": max_seconds,
        "cues": cues,
        "speaker_matches": matches,
        "unmatched_speakers": _clean_str_list(
            source.get("unmatched_speakers"), 240),
        "scene_plan": {
            "maximum_scene_seconds": max_seconds,
            "scene_count": len(planned),
            "estimated_total_seconds": float(
                plan_source.get("estimated_total_seconds") or 0),
            "split_cue_count": int(plan_source.get("split_cue_count")
                                   or 0),
            "scenes": planned,
        },
    }


# ------------------------------------------------------------------
# facial-requirement pass (deterministic prompt post-processing)
# ------------------------------------------------------------------

_FACE_WORDS = re.compile(
    r"\b(?:woman|man|girl|boy|person|subject|singer|rapper|performer|"
    r"speaker|character|face|eyes?|brows?|gaze|mouth|jaw|cheeks?|"
    r"expression|smile|frown|sings?|singing|says|speaks?)\b",
    re.IGNORECASE)


def scene_has_visible_character(scene) -> bool:
    if not isinstance(scene, dict):
        return False
    vocal = scene.get("vocal_status") \
        if isinstance(scene.get("vocal_status"), dict) else {}
    if vocal.get("no_character_present") \
            or scene.get("no_character_present") \
            or scene.get("noCharacterPresent"):
        return False
    return bool(scene.get("subject_refs") or scene.get("subjects")
                or scene.get("visible_subjects")
                or scene.get("visibleSubjects"))


def prompt_mentions_visible_face(prompt) -> bool:
    text = clean_text(prompt, 12000).lower()
    return bool(text) and bool(_FACE_WORDS.search(text))


def scene_is_visible_singing(scene) -> bool:
    if not scene_has_visible_character(scene):
        return False
    vocal = scene.get("vocal_status") \
        if isinstance(scene.get("vocal_status"), dict) else {}
    mode = normalize_performance_mode(
        scene.get("performance_mode") or vocal.get("performance_mode")
        or scene.get("video_type") or scene.get("videoType"))
    if mode != "singing":
        return False
    if vocal.get("instrumental") or vocal.get("no_lip_sync") \
            or vocal.get("no_character_present"):
        return False
    if vocal.get("should_lip_sync") is False:
        return False
    return bool(clean_text(vocal.get("lyric_text")
                           or scene.get("lyrics")
                           or scene.get("lyric_line"), 1200))


_QUIET_REWRITES = (
    (r"\bwith\s+a\s+quiet,\s*internal\s+intensity\b",
     "with controlled internal intensity"),
    (r"\bwith\s+quiet\s+internal\s+intensity\b",
     "with controlled internal intensity"),
    (r"\bquiet,\s*internal\s+intensity\b",
     "controlled internal intensity"),
    (r"\bquiet\s+internal\s+intensity\b",
     "controlled internal intensity"),
    (r"\bquiet\s+intensity\b", "controlled intensity"),
    (r"\bquiet\s+performance\b", "controlled performance"),
    (r"\bquiet\s+emotion\b", "restrained emotion"),
    (r"\bquiet\s+singing\b", "focused singing"),
)


def enforce_video_facial_requirements(prompt, scene) -> str:
    """Deterministic lip-sync hygiene the reference applies to every
    saved LTX video prompt (``:981-1030``): de-"quiet" visible singing,
    and guarantee blink + eye-movement phrases on face shots."""
    text = clean_text(prompt, 12000)
    if not text:
        return text
    vocal = scene.get("vocal_status") \
        if isinstance(scene, dict) else {}
    no_character = bool(
        (isinstance(vocal, dict) and vocal.get("no_character_present"))
        or (isinstance(scene, dict)
            and (scene.get("no_character_present")
                 or scene.get("noCharacterPresent"))))
    if no_character:
        return text
    if not (scene_has_visible_character(scene)
            or prompt_mentions_visible_face(text)):
        return text
    says_singing = bool(re.search(r"\b(?:sings?|singing|raps?|rapping)\b",
                                  text, re.IGNORECASE))
    if scene_is_visible_singing(scene) or says_singing:
        for pattern, replacement in _QUIET_REWRITES:
            text = re.sub(pattern, replacement, text,
                          flags=re.IGNORECASE)
    additions = []
    if not re.search(r"\beye\s+movement\b|\beyes?\s+(?:shift|move|"
                     r"track|glance|flick|dart)\b", text,
                     re.IGNORECASE):
        additions.append("subtle natural eye movement")
    if not re.search(r"\bblink\w*\b", text, re.IGNORECASE):
        additions.append("occasional natural blinking")
    if additions:
        face_sentence = re.search(
            r"([^.]*(?:face|eyes?|brows?|gaze|expression)[^.]*)(\.)",
            text, re.IGNORECASE)
        if face_sentence:
            start, end = face_sentence.span(1)
            text = (text[:start] + text[start:end].rstrip() + ", "
                    + ", ".join(additions) + text[end:])
        else:
            text = (f"{text.rstrip().rstrip('.')} with "
                    f"{', '.join(additions)}.")
    return clean_text(re.sub(r"\s{2,}", " ", text).strip(), 12000)


# ------------------------------------------------------------------
# scene + document normalizers
# ------------------------------------------------------------------

# plain text fields of a scene: (key, alias chain, limit)  (:517-628)
_SCENE_TEXT_FIELDS = (
    ("lyrics", ("lyrics", "lyric_text", "lyricNote"), 4000),
    ("lyric_section", ("lyric_section", "section", "song_section"),
     160),
    ("story_beat", ("story_beat", "scene_story_beat",
                    "narrative_beat"), 1800),
    ("image_prompt", ("image_prompt", "t2i_prompt", "prompt"), 12000),
    ("video_prompt", ("video_prompt", "i2v_prompt", "t2v_prompt"),
     12000),
    ("image_path", ("image_path", "approved_image_path", "image"),
     2000),
    ("image_name", ("image_name", "image_reference_name"), 260),
    ("motion_summary", ("motion_summary", "video_notes", "i2v_notes"),
     3000),
    ("setting", ("setting", "location"), 500),
    ("shot_type", ("shot_type", "shot"), 200),
    ("camera_motion", ("camera_motion", "motion_preset"), 200),
    ("character_motion", ("character_motion",
                          "character_motion_preset",
                          "subject_motion"), 240),
    ("performance_style", ("performance_style", "song_style",
                           "music_style"), 120),
    ("performance_direction", ("performance_direction",), 1000),
    ("facial_performance", ("facial_performance", "facialPerformance",
                            "facial_expression", "facialExpression"),
     120),
    ("facial_performance_custom",
     ("facial_performance_custom", "facialPerformanceCustom",
      "facial_expression_custom", "facialExpressionCustom"), 1200),
    ("trigger_phrase", ("trigger_phrase", "trigger", "Trigger"), 1200),
    ("video_style", ("video_style", "videoStyle"), 160),
    ("video_style_custom", ("video_style_custom", "videoStyleCustom"),
     3000),
    ("temporal_world_effect_custom",
     ("temporal_world_effect_custom", "temporalWorldEffectCustom"),
     3000),
    ("notes", ("notes",), 4000),
    ("audio_direction", ("audio_direction", "audioDirection"), 4000),
    ("continuity", ("continuity", "continuity_direction",
                    "continuityDirection"), 4000),
    ("id_lora_character_id", ("id_lora_character_id", "character_id",
                              "subject_id"), 180),
    ("id_lora_location_id", ("id_lora_location_id", "location_id"),
     180),
)

_VIDEO_PROMPT_TYPES = {"i2v", "id_lora", "t2v", "rtv", "ingredients"}
_MINIMAX_MODES = {"text_to_video", "image_to_video",
                  "reference_to_video", "video_to_video"}


def _engine(source, keys=("project_video_engine",
                          "projectVideoEngine")) -> str:
    raw = str(_pick(source, keys, "")).strip().lower()
    return "minimax_h3" if raw == "minimax_h3" else "ltx"


def normalize_scene(scene, fallback_number: int = 1) -> dict:
    """One storyboard scene card, normalized exactly like the reference
    (``:517-628``) including the facial-requirement pass on LTX video
    prompts."""
    if not isinstance(scene, dict):
        scene = {}
    number = scene_number(scene, fallback_number)
    out = {key: clean_text(_pick(scene, aliases), limit)
           for key, aliases, limit in _SCENE_TEXT_FIELDS}
    out["id"] = _text(scene, ("id",), 160,
                      f"storyboard_scene_{number}")
    out["scene_number"] = number
    out["label"] = _text(scene, ("label",), 180, f"Scene {number}")
    out["performance_mode"] = normalize_performance_mode(
        _pick(scene, ("performance_mode", "performanceMode",
                      "video_performance_mode",
                      "videoPerformanceMode")))
    out["prompt_summary"] = clean_text(
        _pick(scene, ("prompt_summary", "summary"),
              out["image_prompt"][:260]), 1000)
    out["subjects"] = normalize_tags(
        _pick(scene, ("subjects", "singers", "mapped_subjects"), []))
    out["subject_refs"] = _normalize_reference_items(
        scene.get("subject_refs"))
    out["speaker_assignments"] = _normalize_speaker_assignments(
        _pick(scene, ("speaker_assignments",
                      "minimax_speaker_assignments",
                      "dialogue_cues"), []))
    out["location_ref"] = (
        normalize_reference_item(scene.get("location_ref"),
                                 out["setting"] or "Location",
                                 "location")
        if isinstance(scene.get("location_ref"), dict) else None)
    out["facial_performance_direction"] = clean_text(
        _pick(scene, ("facial_performance_direction",
                      "facialPerformanceDirection"),
              out["facial_performance_custom"]), 1600)
    out["include_microphone"] = bool(
        _pick(scene, ("include_microphone", "use_microphone",
                      "microphone"), False))
    out["trigger_position"] = _position(
        scene, ("trigger_position", "triggerPosition",
                "trigger_placement"))

    video_prompt_type = clean_text(
        _pick(scene, ("video_prompt_type", "video_type", "mode")), 40)
    out["video_prompt_type"] = (video_prompt_type
                                if video_prompt_type
                                in _VIDEO_PROMPT_TYPES else "i2v")
    out["project_video_engine"] = _engine(scene)
    minimax_mode = str(_pick(scene, ("minimax_h3_mode",
                                     "minimaxH3Mode"), "")) \
        .strip().lower().replace("-", "_").replace(" ", "_")
    out["minimax_h3_mode"] = (minimax_mode
                              if minimax_mode in _MINIMAX_MODES
                              else "text_to_video")
    audio_mode = str(_pick(scene, ("minimax_h3_audio_mode",
                                   "minimaxH3AudioMode"),
                           "input_audio")) \
        .strip().lower().replace("-", "_").replace(" ", "_")
    out["minimax_h3_audio_mode"] = (
        "built_in_audio" if audio_mode in {"built_in_audio",
                                           "native_audio",
                                           "generated_audio"}
        else "input_audio")
    out["temporal_world_effect_override"] = clean_text(
        _pick(scene, ("temporal_world_effect_override",
                      "temporalWorldEffectOverride"), "global"), 120)
    try:
        out["timeline_start"] = float(
            scene.get("timeline_start", scene.get("start", 0)) or 0)
        out["timeline_end"] = float(
            scene.get("timeline_end", scene.get("end", 0)) or 0)
        out["exact_duration"] = max(0.0, float(
            scene.get("exact_duration", scene.get("duration", 0))
            or 0))
    except (TypeError, ValueError):
        out["timeline_start"] = out["timeline_end"] = 0.0
        out["exact_duration"] = 0.0
    out["video_prompt_origin"] = (
        "gemma" if str(_pick(scene, ("video_prompt_origin",
                                     "i2v_prompt_origin"), ""))
        .strip().lower() == "gemma" else "manual")
    out["image_data"] = str(_pick(scene, ("image_data",
                                          "image_reference_data"),
                                  "")).strip()
    out["status"] = clean_text(
        _pick(scene, ("status",),
              "image_ready" if out["image_path"] or out["image_data"]
              else "draft"), 80)
    if out["video_prompt"] and out["project_video_engine"] \
            != "minimax_h3":
        out["video_prompt"] = enforce_video_facial_requirements(
            out["video_prompt"],
            {**scene, "subjects": out["subjects"],
             "subject_refs": out["subject_refs"],
             "lyrics": out["lyrics"],
             "performance_mode": out["performance_mode"]})
    return out


# document-level text fields shared by save and default (:806-826,:740-775)
_DOC_TEXT_FIELDS = (
    ("camera_flow", ("camera_flow",), 80, "balanced"),
    ("image_shot_flow", ("image_shot_flow",), 80, "intimate"),
    ("image_aesthetic", ("image_aesthetic",), 120, ""),
    ("video_style", ("video_style", "videoStyle"), 160, ""),
    ("video_style_custom", ("video_style_custom", "videoStyleCustom"),
     3000, ""),
    ("temporal_world_effect", ("temporal_world_effect",
                               "temporalWorldEffect"), 160, ""),
    ("temporal_world_effect_custom",
     ("temporal_world_effect_custom", "temporalWorldEffectCustom"),
     3000, ""),
    ("temporal_protected_characters",
     ("temporal_protected_characters", "temporalProtectedCharacters"),
     80, "all_referenced"),
    ("temporal_protected_custom",
     ("temporal_protected_custom", "temporalProtectedCustom"), 1000,
     ""),
    ("global_consistency_phrase", ("global_consistency_phrase",), 1200,
     ""),
    ("performance_style_default",
     ("performance_style_default", "performance_style",
      "performanceStyle"), 120, ""),
    ("facial_performance_default",
     ("facial_performance_default", "facial_performance"), 120, ""),
    ("facial_performance_custom_default",
     ("facial_performance_custom_default", "facial_performance_custom"),
     1200, ""),
)


def _bool_default_true(source, key, camel):
    value = source.get(key) if key in source \
        else source.get(camel, True)
    return value is not False


def _normalize_document_fields(source) -> dict:
    out = {key: clean_text(_pick(source, aliases, default), limit)
           for key, aliases, limit, default in _DOC_TEXT_FIELDS}
    out["project_video_engine"] = _engine(source)
    out["performance_mode"] = normalize_performance_mode(
        _pick(source, ("performance_mode", "performanceMode",
                       "video_type", "videoType")))
    out["short_film_planning_mode"] = normalize_planning_mode(
        _pick(source, ("short_film_planning_mode",
                       "shortFilmPlanningMode")))
    out["temporal_allow_background_extras"] = _bool_default_true(
        source, "temporal_allow_background_extras",
        "temporalAllowBackgroundExtras")
    out["temporal_background_intensity"] = speed_value(
        source.get("temporal_background_intensity")
        if "temporal_background_intensity" in source
        else source.get("temporalBackgroundIntensity", 8))
    out["temporal_environment_time_passage"] = _bool_default_true(
        source, "temporal_environment_time_passage",
        "temporalEnvironmentTimePassage")
    out["camera_motion_speed"] = speed_value(
        _pick(source, ("camera_motion_speed", "cameraMotionSpeed"),
              None))
    out["character_motion_speed"] = speed_value(
        _pick(source, ("character_motion_speed",
                       "characterMotionSpeed"), None))
    out["story_layer"] = normalize_story_layer(
        _pick(source, ("story_layer", "storyLayer"), {}))
    out["script_import"] = normalize_script_import(
        _pick(source, ("script_import", "scriptImport"), {}))
    out["reference_builder"] = normalize_reference_catalog(
        _pick(source, ("reference_builder", "referenceBuilder"), {}))
    return out


# ------------------------------------------------------------------
# persistence
# ------------------------------------------------------------------

def _project_folder(payload_or_path) -> str:
    if isinstance(payload_or_path, dict):
        raw = payload_or_path.get("project_folder", "")
    else:
        raw = payload_or_path
    folder = os.path.abspath(str(raw or "").strip().strip('"'))
    if not folder.strip():
        raise ValueError("Project folder is missing.")
    os.makedirs(folder, exist_ok=True)
    return folder


def storyboard_path(project_folder) -> str:
    folder = os.path.join(_project_folder(project_folder), "storyboard")
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, STORYBOARD_FILENAME)


def _now() -> str:
    return datetime.now().isoformat(timespec="seconds")


def load_storyboard(payload: dict) -> dict:
    """Saved storyboard (normalized), or a fresh default document
    (``:779-798``)."""
    folder = _project_folder(payload)
    path = storyboard_path(folder)
    data = _read_json(path)
    if isinstance(data, dict):
        scenes = data.get("scenes", [])
        scenes = scenes if isinstance(scenes, list) else []
        data["scenes"] = [normalize_scene(scene, index + 1)
                          for index, scene in enumerate(scenes)]
        data["story_layer"] = normalize_story_layer(
            _pick(data, ("story_layer", "storyLayer"), {}))
        data["script_import"] = normalize_script_import(
            _pick(data, ("script_import", "scriptImport"), {}))
        data["short_film_planning_mode"] = normalize_planning_mode(
            _pick(data, ("short_film_planning_mode",
                         "shortFilmPlanningMode")))
        data["reference_builder"] = normalize_reference_catalog(
            _pick(data, ("reference_builder", "referenceBuilder"), {}))
        data["path"] = path
        return data
    scenes = payload.get("scenes", [])
    scenes = scenes if isinstance(scenes, list) else []
    normalized = [normalize_scene(scene, index + 1)
                  for index, scene in enumerate(scenes)]
    data = {
        "version": 1,
        "created_at": _now(),
        "updated_at": _now(),
        "project_folder": folder,
        "mode": ("image_to_video_prep"
                 if any(scene.get("image_path")
                        or scene.get("image_data")
                        for scene in normalized)
                 else "storyboard_prompts"),
        **_normalize_document_fields(payload),
        "scenes": normalized,
        "path": path,
    }
    return data


def save_storyboard(payload: dict) -> dict:
    """Normalize + persist the full storyboard document (``:800-826``)."""
    folder = _project_folder(payload)
    storyboard = payload.get("storyboard", {})
    if not isinstance(storyboard, dict):
        raise ValueError("Storyboard payload is invalid.")
    scenes = storyboard.get("scenes", [])
    scenes = scenes if isinstance(scenes, list) else []
    data = {
        "version": 1,
        "created_at": storyboard.get("created_at") or _now(),
        "updated_at": _now(),
        "project_folder": folder,
        "mode": storyboard.get("mode") or "storyboard_prompts",
        **_normalize_document_fields(storyboard),
        "scenes": [normalize_scene(scene, index + 1)
                   for index, scene in enumerate(scenes)],
    }
    path = storyboard_path(folder)
    _write_json(path, data)
    data["path"] = path
    return data


def export_prompts(payload: dict) -> dict:
    """Save, then write the prompt export files the downstream render
    tooling reads (``:826-900``): Prompt<N>=/I2V<N>= key-value texts and
    the two JSON manifests."""
    saved = save_storyboard(payload)
    folder = _project_folder(payload)
    prompts_dir = os.path.join(folder, "prompts")
    os.makedirs(prompts_dir, exist_ok=True)
    scenes = saved.get("scenes", [])

    def entry(scene, index, field):
        return {
            "scene": index,
            "scene_id": clean_text(scene.get("id"), 120),
            "label": clean_text(scene.get("label")
                                or f"Scene {index}", 200),
            "lyric_section": clean_text(scene.get("lyric_section"),
                                        160),
            "lyric_line": clean_text(scene.get("lyrics"), 1200),
            "prompt": clean_text(scene.get(field)),
        }

    t2i_path = os.path.join(prompts_dir, "t2i_prompts.txt")
    i2v_path = os.path.join(prompts_dir, "i2v_prompts.txt")
    for path, prefix, field in ((t2i_path, "Prompt", "image_prompt"),
                                (i2v_path, "I2V", "video_prompt")):
        with open(path, "w", encoding="utf-8") as handle:
            for index, scene in enumerate(scenes, start=1):
                handle.write(
                    f"{prefix}{index}="
                    f"{clean_text(scene.get(field))}\n")

    t2i_json_path = os.path.join(prompts_dir, "t2i_prompts.json")
    video_json_path = os.path.join(prompts_dir, "video_prompts.json")
    _write_json(t2i_json_path, {
        "version": 1, "exported_at": _now(),
        "type": "storyboard_t2i_prompts", "scene_count": len(scenes),
        "scenes": [entry(scene, index, "image_prompt")
                   for index, scene in enumerate(scenes, start=1)]})
    _write_json(video_json_path, {
        "version": 1, "exported_at": _now(),
        "type": "storyboard_video_prompts",
        "project_video_engine": saved.get("project_video_engine")
        or "ltx",
        "performance_mode": saved.get("performance_mode") or "singing",
        "scene_count": len(scenes),
        "scenes": [{
            **entry(scene, index, "video_prompt"),
            "video_prompt_type": clean_text(
                scene.get("video_prompt_type"), 80),
            "minimax_h3_mode": clean_text(scene.get("minimax_h3_mode"),
                                          80),
            "video_style": clean_text(scene.get("video_style"), 160),
            "video_style_custom": clean_text(
                scene.get("video_style_custom"), 3000),
            "performance_mode": normalize_performance_mode(
                scene.get("performance_mode")
                or saved.get("performance_mode")),
        } for index, scene in enumerate(scenes, start=1)]})
    summary_path = os.path.join(os.path.dirname(storyboard_path(folder)),
                                "storyboard_export.json")
    _write_json(summary_path, {
        "version": 1, "exported_at": _now(),
        "t2i_prompts": t2i_path, "i2v_prompts": i2v_path,
        "t2i_prompts_json": t2i_json_path,
        "video_prompts_json": video_json_path, "scenes": scenes})
    return {"storyboard_path": saved.get("path", ""),
            "t2i_prompts_path": t2i_path,
            "i2v_prompts_path": i2v_path,
            "t2i_prompts_json_path": t2i_json_path,
            "video_prompts_json_path": video_json_path,
            "export_path": summary_path,
            "scene_count": len(scenes)}


def import_reference_image(payload: dict) -> dict:
    """Decode a subject/location reference image into
    ``storyboard/references/...`` and return its normalized card
    (``:462-514``)."""
    folder = _project_folder(payload)
    kind = str(payload.get("kind") or "subject").strip().lower()
    if kind not in {"subject", "location"}:
        kind = "subject"
    name = clean_text(payload.get("name")
                      or ("Location" if kind == "location"
                          else "Subject"), 240)
    description = clean_text(payload.get("description"), 4000)
    raw_text = str(payload.get("image_data")
                   or payload.get("data") or "").strip()
    match = re.match(r"^data:image/([A-Za-z0-9.+-]+);base64,(.*)$",
                     raw_text, flags=re.S)
    ext = (match.group(1).lower() if match else "png")
    ext = {"jpeg": "jpg"}.get(ext, ext)
    if ext not in {"png", "jpg", "webp"}:
        ext = "png"
    raw = data_url_bytes(raw_text)
    if not raw:
        raise ValueError("Reference image data is empty.")
    if len(raw) > 30 * 1024 * 1024:
        raise ValueError("Reference image is too large.")
    reference_dir = os.path.join(
        os.path.dirname(storyboard_path(folder)), "references",
        "locations" if kind == "location" else "subjects")
    os.makedirs(reference_dir, exist_ok=True)
    stem = re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("._")[:90] \
        or kind
    numbered = (os.path.join(reference_dir, f"{stem}_{n}.{ext}")
                for n in itertools.count(2))
    path = next(p for p in itertools.chain(
        (os.path.join(reference_dir, f"{stem}.{ext}"),), numbered)
        if not os.path.exists(p))
    with open(path, "wb") as handle:
        handle.write(raw)
    ref_id = clean_text(
        payload.get("id")
        or f"{kind}_{stem}_{datetime.now().strftime('%Y%m%d%H%M%S')}",
        160)
    reference = normalize_reference_item(
        {"id": ref_id, "name": name, "description": description,
         "image": {"path": path, "name": os.path.basename(path),
                   "data": ""}}, name, ref_id)
    return {"reference": reference, "path": path}
