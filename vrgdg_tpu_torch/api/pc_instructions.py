"""Prompt-Creator LLM-instruction store: defaults, overrides, presets.

A copy of :mod:`vrgdg_tpu.api.pc_instructions` (which cannot be imported
without JAX): every function keeps its original's source.

Re-derivation of the reference prompt-creator instruction subsystem
(``VRGDG_MusicVideoPromptCreatorNodes.py:346-398`` and
the six ``/vrgdg/music_prompt_creator/{get,save,reset}_instruction`` /
``{list,save,load}_instruction_preset*`` routes at ``:1718-1813``,
``:1966-2056``).  Unlike the builder store (`api/instructions.py`) this
family has no scene scopes and no shared preset groups: seven fixed
keys, one per-project override file each, one flat preset folder per
key.

The store is pure host-side state management — the Gemma/LM-Studio
drivers that consume the text stay out of scope per SURVEY §2.5.

* per-project overrides live at
  ``<project>/project_context/custom_llm_instructions/<key>.txt``
  (``_instruction_folder``, ``:381-386``);
* the preset library lives at
  ``<output_root>/VRGDG_LLM_Instruction_Presets/prompt_creator/<key>/``
  (``_instruction_preset_root``, ``:389-394``), mtime-sorted newest
  first (``:1760-1786``);
* resolution precedence is override > default (``:397-406``).

File layout, key set, payload fields, and result schemas match the
reference so projects and preset folders interchange.  The *default*
texts do NOT: the reference's defaults are pages of authored LLM prompt
copy (`_VRGDG_GEMMA4_*` in ``VRGDG_GeneralNodes2.py`` plus module
constants).  Shipping those verbatim would be transcription, so the
defaults here are first-party texts stating the same output contract
in brief; users who want the reference's exact prompts save them once
as presets or per-project overrides, which then take precedence.
"""

from __future__ import annotations

import os
import re

from .instructions import safe_preset_name
from .paths import DEFAULT_OUTPUT_ROOT
from .prompt_creator import project_folder_from_payload

# first-party default texts (see module docstring for why these are
# not the reference's authored prompts)
_DEFAULTS = {
    "full_lyrics": (
        "Split the supplied song lyrics into numbered lyric segments "
        "that each cover one sung phrase. Return plain JSON only: "
        "{\"lyricSegment1\": \"...\", \"lyricSegment2\": \"...\"} with "
        "every segment in order and no keys skipped. Keep the original "
        "wording; mark instrumental gaps as empty strings."),
    "style_theme": (
        "Reply with exactly three short labelled lines:\n"
        "STYLE / THEME: one sentence on tone and visual direction.\n"
        "COLOR PALETTE: main and accent colors; avoid fading to dark.\n"
        "LIGHTING / MOOD: brightness, contrast, and shadows.\n"
        "Use simple, everyday words and no extra text."),
    "story_idea": (
        "Write one short paragraph describing the music video's story "
        "arc from first scene to last: who the subject is, what "
        "changes, and how it resolves. Plain prose, no headings, no "
        "camera jargon."),
    "subject_locations": (
        "Reply with a SUBJECT line describing the main performer in "
        "one sentence, then a LOCATIONS list (one per line) naming "
        "each distinct place the video visits. No other text."),
    "concept_prompts": (
        "Write one vivid visual concept per lyric segment. Return "
        "plain JSON only: {\"prompt1\": \"...\", \"prompt2\": \"...\"} "
        "with exactly one key per segment, in order. Each value is one "
        "concrete filmable moment consistent with the STORY and "
        "THEME_STYLE supplied; keep the subject's identity and "
        "wardrobe consistent across prompts."),
    "subject_extract": (
        "Extract only the subject from the user input and return one "
        "clean sentence in the form: A/An [subject]. Ignore locations "
        "and every other field, preserve the subject details, and end "
        "with a period. No extra text."),
    "i2v_motion_notes": (
        "For each supplied image prompt, write one short motion note "
        "describing how the shot moves (subject action plus camera "
        "move). Return plain JSON only: {\"I2V1\": \"...\", "
        "\"I2V2\": \"...\"} with one key per prompt, in order."),
}

# display labels are API surface (the UI renders them) — reference
# values verbatim (``_PROMPT_CREATOR_INSTRUCTION_LABELS``, ``:355-363``)
LABELS = {
    "full_lyrics": "Full Lyrics",
    "style_theme": "Style / Theme",
    "story_idea": "Story Idea",
    "subject_locations": "Subject and Locations",
    "concept_prompts": "Concept Prompts",
    "subject_extract": "Subject Extraction",
    "i2v_motion_notes": "I2V Motion Notes",
}

KEYS = tuple(_DEFAULTS)


def safe_key(value) -> str:
    """Validated instruction key (ref ``_safe_instruction_key``,
    ``:366-369``)."""
    key = re.sub(r"[^a-z0-9_]+", "_",
                 str(value or "").strip().lower()).strip("_")
    if key not in _DEFAULTS:
        raise ValueError(f"Unknown Prompt Creator instruction key: "
                         f"{value}")
    return key


def override_dir(project_folder: str) -> str:
    """``:381-382`` — overrides live under the project context."""
    return os.path.join(project_folder, "project_context",
                        "custom_llm_instructions")


def override_path(project_folder: str, key: str) -> str:
    return os.path.join(override_dir(project_folder),
                        f"{safe_key(key)}.txt")


def preset_root(output_root=None) -> str:
    """``:389-390`` — shared preset library under the output root."""
    return os.path.join(output_root or DEFAULT_OUTPUT_ROOT,
                        "VRGDG_LLM_Instruction_Presets", "prompt_creator")


def preset_path(key: str, name: str, output_root=None) -> str:
    return os.path.join(preset_root(output_root), safe_key(key),
                        f"{safe_preset_name(name)}.txt")


def _read_text(path) -> str:
    if not os.path.isfile(path):
        return ""
    with open(path, "r", encoding="utf-8-sig", errors="replace") as fh:
        return fh.read().strip()


def effective_instruction(project_folder: str, key: str) -> str:
    """Override if present and non-empty, else the default
    (ref ``_prompt_creator_instruction``, ``:397-406``)."""
    key = safe_key(key)
    text = _read_text(override_path(project_folder, key))
    return text or _DEFAULTS[key]


def get_instruction(payload: dict, output_root=None) -> dict:
    """Result schema of ``_get_prompt_creator_instruction``
    (``:1718-1733``)."""
    project_folder = project_folder_from_payload(payload, output_root)
    key = safe_key(payload.get("key"))
    path = override_path(project_folder, key)
    custom_text = _read_text(path)
    state = dict(project_folder=project_folder, key=key, path=path,
                 label=LABELS[key], default_text=_DEFAULTS[key],
                 custom_text=custom_text, has_custom=bool(custom_text))
    state["text"] = custom_text if custom_text else _DEFAULTS[key]
    return state


def save_instruction(payload: dict, output_root=None) -> dict:
    """``:1736-1748`` — write the override, echo the fresh state."""
    project_folder = project_folder_from_payload(payload, output_root)
    key = safe_key(payload.get("key"))
    text = str(payload.get("text", "") or "").strip()
    if not text:
        raise ValueError("Instruction text is empty.")
    path = override_path(project_folder, key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text + "\n")
    return get_instruction({"project_folder": project_folder,
                            "key": key}, output_root)


def reset_instruction(payload: dict, output_root=None) -> dict:
    """``:1751-1757`` — drop the override, echo the default state."""
    project_folder = project_folder_from_payload(payload, output_root)
    key = safe_key(payload.get("key"))
    path = override_path(project_folder, key)
    if os.path.isfile(path):
        os.remove(path)
    return get_instruction({"project_folder": project_folder,
                            "key": key}, output_root)


def list_presets(payload: dict, output_root=None) -> dict:
    """``:1760-1786`` — presets for one key, newest first."""
    key = safe_key(payload.get("key"))
    folder = os.path.join(preset_root(output_root), key)
    presets = []
    if os.path.isdir(folder):
        with os.scandir(folder) as entries:
            for entry in entries:
                if not (entry.is_file()
                        and entry.name.lower().endswith(".txt")):
                    continue
                try:
                    updated = entry.stat().st_mtime
                except OSError:
                    updated = 0
                presets.append({"name": entry.name[:-4],
                                "path": os.path.abspath(entry.path),
                                "updated": updated})
    presets.sort(key=lambda item: item.get("updated", 0), reverse=True)
    return {"key": key, "label": LABELS[key], "presets": presets,
            "preset_folder": folder}


def save_preset(payload: dict, output_root=None) -> dict:
    """``:1789-1800``."""
    key = safe_key(payload.get("key"))
    name = safe_preset_name(payload.get("name"))
    text = str(payload.get("text", "") or "").strip()
    if not text:
        raise ValueError("Preset instruction text is empty.")
    path = preset_path(key, name, output_root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text + "\n")
    return {"key": key, "name": name, "path": path}


def load_preset(payload: dict, output_root=None) -> dict:
    """``:1803-1812``."""
    key = safe_key(payload.get("key"))
    name = safe_preset_name(payload.get("name"))
    path = preset_path(key, name, output_root)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Instruction preset was not found: "
                                f"{path}")
    text = _read_text(path)
    if not text:
        raise ValueError("Instruction preset is empty.")
    return {"key": key, "name": name, "path": path, "text": text}
