"""Builder LLM-instruction store: defaults, overrides, presets.

A copy of :mod:`vrgdg_tpu.api.instructions` (which cannot be imported
without JAX): every function keeps its original's source.

Re-derivation of the reference's builder instruction subsystem
(``VRGDG_MusicVideoBuilderNodes.py:889-1195`` and the
six ``/vrgdg/music_builder/{get,save,reset}_instruction`` /
``{list,save,load}_instruction_presets`` routes at ``:10254-10307``).
The store is pure host-side state management — the LLM *drivers* that
consume the text stay out of scope per SURVEY §2.5:

* per-project overrides under
  ``<project>/project_context/custom_builder_instructions/`` —
  ``<key>.txt`` applies to all scenes, ``scenes/<scene_id>/<key>.txt``
  to one scene; resolution precedence is scene > all-scenes > default;
* a shared preset library under
  ``<output_root>/VRGDG_LLM_Instruction_Presets/builder/<group>/``
  (mtime-sorted, case-insensitive dedup, with the reference's legacy
  per-key folder read as fallback);
* the key registry with display labels and preset groups (the three
  standard-image and three reference-image T2I keys share a preset
  folder each, ``:936-948``).

File layout, key set, payload fields, and result schemas match the
reference so projects and preset folders interchange.  The *default*
instruction texts do NOT: the reference's defaults are several hundred
lines of authored LLM prompt copy (``VRGDG_MiniMaxH3PromptInstructions
.py`` and builder-internal constants).  Shipping them verbatim would be
transcription, so the defaults here are first-party texts stating the
same output contract in brief; users who want the reference's exact
prompts save them once as presets or per-project overrides, which then
take precedence everywhere.
"""

from __future__ import annotations

import os
import re

_SHORT_FILM_MODES = ("text_to_video", "image_to_video",
                     "reference_to_video", "video_to_video")

_SHARED_PRESET_FOLDERS = {
    "standard_image_t2i": ("ernie_t2i", "krea2_t2i", "zimage_t2i"),
    "reference_image_t2i": ("flow_gpt_t2i", "flux_klein_t2i",
                            "nano_b_t2i"),
}
PRESET_GROUPS = {key: group
                 for group, keys in _SHARED_PRESET_FOLDERS.items()
                 for key in keys}

PRESET_GROUP_LABELS = {
    "standard_image_t2i": "Standard Image T2I",
    "reference_image_t2i": "Reference/Image Edit T2I",
}

# first-party default texts (see module docstring for why these are
# not the reference's authored prompts)
_T2I_DEFAULT = (
    "Write one vivid still-image prompt per requested scene. Return "
    "plain JSON only: {\"prompts\":[{\"prompt\":\"...\"}]}. Use the "
    "supplied subject, location, and scene notes; keep identity, "
    "outfit, and lighting consistent across scenes; no markdown, no "
    "commentary, nothing after the closing brace.")
_T2V_DEFAULT = (
    "Write one cinematic video shot description per requested scene. "
    "Return plain JSON only: {\"prompts\":[{\"prompt\":\"...\"}]}. "
    "Describe only visible action and camera movement; keep subject "
    "identity and spatial continuity across shots; no markdown, no "
    "commentary, nothing after the closing brace.")
_I2V_DEFAULT = (
    "Animate the supplied start image. Write one motion description "
    "per requested scene as plain JSON: "
    "{\"prompts\":[{\"prompt\":\"...\"}]}. Keep the start image's "
    "subject, framing, and lighting; describe motion only; no "
    "markdown, nothing after the closing brace.")
_MINIMAX_CORE = (
    "You write only the creative shot descriptions for a MiniMax H3 "
    "video prompt; the Builder adds every fixed section (references, "
    "audio, continuity, shot labels, cut times). Return plain JSON "
    "only: {\"shots\":[{\"description\":\"...\"}]} with exactly the "
    "requested number of shots. Stage supplied lyric/dialogue lines "
    "as natural lip-sync by the assigned subject only; obey any vocal "
    "cue map exactly and keep everyone else silent. Never invent "
    "singing in visual-only or instrumental scenes, never start a "
    "shot with 'The camera cuts to', and output nothing after the "
    "closing brace. ")
_MINIMAX_MODE_NOTES = {
    "text_to_video": "MODE TEXT TO VIDEO: use only the supplied text "
                     "context.",
    "image_to_video": "MODE IMAGE TO VIDEO: animate <Picture 1> as "
                      "the starting anchor when supplied.",
    "reference_to_video": "MODE REFERENCE TO VIDEO: use <Subject N> / "
                          "<Picture N> labels only when the scene "
                          "context lists them.",
    "video_to_video": "MODE VIDEO TO VIDEO: continue the supplied "
                      "source video's subjects and motion.",
}
_SHORT_FILM_NOTES = {
    "guided": "SHORT FILM (guided): follow the Builder's per-scene "
              "beat sheet; one shot per beat in order.",
    "custom": "SHORT FILM (fully custom): follow the user's manual "
              "scene source verbatim; do not reorder or merge scenes.",
}


def _registry() -> dict[str, dict]:
    table = {
        "flux_klein_t2i": ("Flux/Klein Text to Image", _T2I_DEFAULT),
        "flow_gpt_t2i": ("Flow/GPT Text to Image", _T2I_DEFAULT),
        "ernie_t2i": ("Ernie Text to Image", _T2I_DEFAULT),
        "id_lora": ("ID-LoRA I2V", _I2V_DEFAULT),
        "ingredients": ("Ingredients to Video", _T2V_DEFAULT),
        "i2v": ("Image to Video", _I2V_DEFAULT),
        "krea2_t2i": ("Krea 2 Text to Image", _T2I_DEFAULT),
        "nano_b_t2i": ("Nano B Text to Image", _T2I_DEFAULT),
        "rtv": ("Reference to Video", _T2V_DEFAULT),
        "t2v": ("Text to Video", _T2V_DEFAULT),
        "zimage_t2i": ("ZImage Text to Image", _T2I_DEFAULT),
    }
    for mode in _SHORT_FILM_MODES:
        # base keys keep lowercase joiners ("Image to Video"); the
        # short-film labels title-case every word, as the reference does
        base_label = " ".join(
            word if word in {"to"} else word.capitalize()
            for word in mode.split("_"))
        film_label = mode.replace("_", " ").title()
        base = _MINIMAX_CORE + _MINIMAX_MODE_NOTES[mode]
        table[f"minimax_h3_{mode}"] = (f"MiniMax H3 {base_label}", base)
        table[f"minimax_h3_short_film_guided_{mode}"] = (
            f"MiniMax H3 Guided Short Film - {film_label}",
            base + "\n" + _SHORT_FILM_NOTES["guided"])
        table[f"minimax_h3_short_film_custom_{mode}"] = (
            f"MiniMax H3 Fully Custom Short Film - {film_label}",
            base + "\n" + _SHORT_FILM_NOTES["custom"])
    return {key: {"label": label, "default": text}
            for key, (label, text) in table.items()}


REGISTRY = _registry()


# ------------------------------------------------------------------
# sanitizers (oracle-fuzzed vs the reference's)
# ------------------------------------------------------------------

def safe_key(value) -> str:
    """Normalized registry key; unknown keys are rejected
    (ref ``_safe_builder_instruction_key``, ``:950-954``)."""
    key = re.sub(r"[^a-z0-9_]+", "_",
                 str(value or "").strip().lower()).strip("_")
    if key not in REGISTRY:
        raise ValueError(f"Unknown Builder instruction key: {value}")
    return key


def safe_scene_id(value) -> str:
    """Filesystem-safe scene id, 120 chars
    (ref ``_safe_builder_scene_id``, ``:957-959``)."""
    scene = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(value or "").strip())
    return scene.strip("._-")[:120]


def safe_preset_name(value) -> str:
    """Filesystem-safe preset name, 80 chars, never empty
    (ref ``_safe_preset_name``, ``:962-967``)."""
    text = re.sub(r"[^A-Za-z0-9_. -]+", "_",
                  str(value or "").strip()).strip(" ._")
    if not text:
        raise ValueError("Preset name is empty.")
    return text[:80]


def preset_group(key: str) -> str:
    return PRESET_GROUPS.get(safe_key(key), safe_key(key))


def preset_group_label(key: str) -> str:
    group = preset_group(key)
    if group in PRESET_GROUP_LABELS:
        return PRESET_GROUP_LABELS[group]
    return REGISTRY.get(group, {}).get("label", group)


# ------------------------------------------------------------------
# storage layout
# ------------------------------------------------------------------

def _override_dir(project_folder: str) -> str:
    return os.path.join(project_folder, "project_context",
                        "custom_builder_instructions")


def _override_path(project_folder: str, key: str,
                   scene_id: str = "") -> str:
    folder = _override_dir(project_folder)
    if scene_id:
        scene = safe_scene_id(scene_id)
        if not scene:
            raise ValueError("Scene id is missing.")
        folder = os.path.join(folder, "scenes", scene)
    return os.path.join(folder, f"{safe_key(key)}.txt")


def preset_root(output_root: str) -> str:
    return os.path.join(os.path.abspath(output_root),
                        "VRGDG_LLM_Instruction_Presets", "builder")


def _preset_path(output_root: str, key: str, name: str,
                 legacy: bool = False) -> str:
    bucket = safe_key(key) if legacy else preset_group(key)
    return os.path.join(preset_root(output_root), bucket,
                        f"{safe_preset_name(name)}.txt")


def _read_text(path: str) -> str:
    if not path or not os.path.isfile(path):
        return ""
    with open(path, "r", encoding="utf-8-sig",
              errors="replace") as handle:
        return handle.read().strip()


def _project_folder(payload: dict) -> str:
    raw = str(payload.get("project_folder", "") or "").strip().strip('"')
    if not raw:
        raise ValueError(
            "Create or load a Builder project before editing "
            "instructions.")
    return os.path.abspath(raw)


def _scope_path(project_folder: str, key: str, payload: dict) -> str:
    """The override file a save/reset targets: all-scenes for scope
    all/all_scenes/global, else the payload's scene."""
    scope = str(payload.get("scope", "scene") or "scene").strip().lower()
    if scope in {"all", "all_scenes", "global"}:
        return _override_path(project_folder, key)
    return _override_path(project_folder, key,
                          payload.get("scene_id", ""))


# ------------------------------------------------------------------
# state + route handlers (payload-in / dict-out, like api.builder)
# ------------------------------------------------------------------

def instruction_state(project_folder: str, key: str,
                      scene_id: str = "") -> dict:
    """Full resolution state for one key: which layer supplies the
    effective text (ref ``_builder_instruction_state``, ``:1021-1058``)."""
    key = safe_key(key)
    scene_path = (_override_path(project_folder, key, scene_id)
                  if scene_id else "")
    all_path = _override_path(project_folder, key)
    scene_text = _read_text(scene_path)
    all_text = _read_text(all_path)
    default_text = REGISTRY[key]["default"]
    layers = (("scene", scene_text, scene_path),
              ("all_scenes", all_text, all_path),
              ("default", default_text, ""))
    source, text, path = next((layer for layer in layers if layer[1]),
                              layers[-1])
    return dict(key=key, label=REGISTRY[key]["label"],
                scene_id=str(scene_id or ""),
                default_text=default_text, scene_text=scene_text,
                all_scenes_text=all_text, text=text, source=source,
                path=path, scene_path=scene_path,
                all_scenes_path=all_path,
                has_scene_custom=bool(scene_text),
                has_all_scenes_custom=bool(all_text))


def effective_instruction(project_folder, key: str,
                          scene_id: str = "") -> str:
    """The text an LLM driver would receive; falls back to the default
    on any store error (ref ``_effective_builder_instruction``)."""
    default_text = REGISTRY.get(key, {}).get("default", "")
    folder = str(project_folder or "").strip().strip('"')
    if not folder:
        return default_text
    try:
        state = instruction_state(os.path.abspath(folder), key, scene_id)
        return state["text"] or default_text
    except (ValueError, OSError):
        return default_text


def get_instruction(payload: dict) -> dict:
    folder = _project_folder(payload)
    key = safe_key(payload.get("key"))
    return {"project_folder": folder,
            **instruction_state(folder, key,
                                payload.get("scene_id", ""))}


def save_instruction(payload: dict) -> dict:
    folder = _project_folder(payload)
    key = safe_key(payload.get("key"))
    text = str(payload.get("text", "") or "").strip()
    if not text:
        raise ValueError("Instruction text is empty.")
    path = _scope_path(folder, key, payload)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(text + "\n")
    return get_instruction({"project_folder": folder, "key": key,
                            "scene_id": payload.get("scene_id", "")})


def reset_instruction(payload: dict) -> dict:
    folder = _project_folder(payload)
    key = safe_key(payload.get("key"))
    path = _scope_path(folder, key, payload)
    if os.path.isfile(path):
        os.remove(path)
    return get_instruction({"project_folder": folder, "key": key,
                            "scene_id": payload.get("scene_id", "")})


def list_presets(payload: dict, output_root: str) -> dict:
    key = safe_key(payload.get("key"))
    group = preset_group(key)
    primary = os.path.join(preset_root(output_root), group)
    legacy = os.path.join(preset_root(output_root), key)
    presets: list[dict] = []
    seen: set[str] = set()
    scan = [(primary, False)]
    if os.path.normcase(os.path.abspath(legacy)) != \
            os.path.normcase(os.path.abspath(primary)):
        scan.append((legacy, True))
    for folder, is_legacy in scan:
        if not os.path.isdir(folder):
            continue
        for filename in sorted(os.listdir(folder)):
            stem, ext = os.path.splitext(filename)
            full = os.path.join(folder, filename)
            if ext.lower() != ".txt" or not os.path.isfile(full):
                continue
            if stem.lower() in seen:
                continue
            seen.add(stem.lower())
            presets.append({"name": stem,
                            "path": os.path.abspath(full),
                            "updated": os.path.getmtime(full),
                            "legacy": is_legacy})
    presets.sort(key=lambda item: item.get("updated", 0), reverse=True)
    return {"key": key, "label": REGISTRY[key]["label"],
            "preset_group": group,
            "preset_group_label": preset_group_label(key),
            "presets": presets, "preset_folder": primary}


def save_preset(payload: dict, output_root: str) -> dict:
    key = safe_key(payload.get("key"))
    name = safe_preset_name(payload.get("name"))
    text = str(payload.get("text", "") or "").strip()
    if not text:
        raise ValueError("Preset instruction text is empty.")
    path = _preset_path(output_root, key, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(text + "\n")
    return {"key": key, "name": name, "path": path,
            "preset_folder": os.path.dirname(path),
            "preset_group": preset_group(key),
            "preset_group_label": preset_group_label(key)}


def load_preset(payload: dict, output_root: str) -> dict:
    key = safe_key(payload.get("key"))
    name = safe_preset_name(payload.get("name"))
    path = _preset_path(output_root, key, name)
    text = _read_text(path)
    if not text:
        legacy = _preset_path(output_root, key, name, legacy=True)
        if os.path.normcase(os.path.abspath(legacy)) != \
                os.path.normcase(os.path.abspath(path)) and \
                _read_text(legacy):
            path, text = legacy, _read_text(legacy)
    if not text:
        raise FileNotFoundError(
            f"Instruction preset was not found or is empty: {path}")
    return {"key": key, "name": name, "path": path,
            "preset_folder": os.path.dirname(path),
            "preset_group": preset_group(key),
            "preset_group_label": preset_group_label(key),
            "text": text}
