"""Cycling text pickers: deterministic list selection for prompt variety.

A copy of :mod:`vrgdg_tpu.runtime.text_pickers` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

Re-derivation of the reference's cycling-picker family
(``VRGDG_GeneralNodes.py:2473-3151``):

- a tolerant list parser (JSON/Python structures, blank-line chunks,
  comma/pipe rows, plain lines, bullet/number cleanup),
- three selection modes — wrapping ``index``, seeded ``random`` (one
  string-seeded draw per step), and seeded ``random no repeat`` (a
  shuffled order per cycle, with the first element of a new cycle
  swapped away from the previous cycle's *raw* last element; like the
  reference (``:2706-2709``), the comparison ignores the previous
  cycle's own swap, so for 2-item lists a boundary repeat can still
  occur — kept for parity),
- multi-pick formatting (two-item sentence template, lines, commas),
- the multi-picker composition with ``# LABEL:`` / ``# SELECTION_MODE:``
  / ``# PICK_COUNT:`` / ``# TEMPLATE:`` header directives, preset item
  lists, and joiner modes.

Selection is stateless-deterministic: the same (seed, index, item count)
always picks the same item, so distributed/step-indexed pipelines get
repeatable variety without persisted cursor files. All behavior is
locked by the oracle fuzz in ``tests/test_reference_parity.py``.
"""

from __future__ import annotations

import ast
import json
import random
import re
from dataclasses import dataclass, field

DEFAULT_TWO_ITEM_TEMPLATE = "start with {item1} then follow with {item2}"

#: dict keys a structured items payload may carry its list under
_STRUCTURED_LIST_KEYS = ("items", "values", "motions", "camera_motions",
                         "camera motions")

SPLIT_MODES = ("auto", "json/python", "line", "blank line", "comma", "pipe")
SELECTION_MODES = ("index", "random", "random no repeat")
MULTI_FORMATS = ("auto", "lines", "comma", "sentence")


# --------------------------------------------------------------------------
# list parsing
# --------------------------------------------------------------------------

def _stringify(value) -> str:
    if isinstance(value, str):
        return value
    if not isinstance(value, (dict, list, tuple, set)):
        return str(value)
    try:
        return json.dumps(value, ensure_ascii=False)
    except (TypeError, ValueError):
        # unserializable members (sets of objects, circular refs)
        return str(value)


def _structured_list(parsed) -> list[str] | None:
    """The item list inside a decoded JSON/Python value, if it is one."""
    if isinstance(parsed, dict):
        for key in _STRUCTURED_LIST_KEYS:
            inner = parsed.get(key)
            if isinstance(inner, (list, tuple, set)):
                return [_stringify(item) for item in inner]
        return [_stringify(item) for item in parsed.values()]
    if isinstance(parsed, (list, tuple, set)):
        return [_stringify(item) for item in parsed]
    return None


def _decode_structured(text: str) -> list[str] | None:
    stripped = str(text or "").strip()
    if not stripped:
        return []
    for decode in (json.loads, ast.literal_eval):
        try:
            value = decode(stripped)
        except Exception:
            continue
        items = _structured_list(value)
        if items is not None:
            return items
    return None


def _strip_bullet(item) -> str:
    """Drop leading ``-``/``*``/``+``/``1.``/``1)`` markers and trailing
    commas from one split item (``:2655-2658``)."""
    cleaned = re.sub(r"^\s*(?:[-*+]|\d+[.)])\s+", "",
                     str(item or "").strip())
    return cleaned.strip().strip(",")


def split_items(text, split_mode: str = "auto") -> list[str]:
    """Raw item chunks for a split mode; ``auto`` sniffs structure first,
    then blank-line paragraphs, then single-line comma/pipe rows
    (``:2661-2678``)."""
    raw = str(text or "")
    mode = str(split_mode or "auto").strip().lower()
    if mode in ("auto", "json/python"):
        structured = _decode_structured(raw)
        if structured is not None:
            return structured
        if mode == "json/python":
            return []
    if mode == "blank line" or (mode == "auto"
                                and re.search(r"\n\s*\n", raw)):
        return re.split(r"\n\s*\n+", raw.strip())
    if mode == "comma" or (mode == "auto" and "\n" not in raw
                           and "," in raw):
        return raw.split(",")
    if mode == "pipe" or (mode == "auto" and "\n" not in raw
                          and "|" in raw):
        return raw.split("|")
    return raw.splitlines() if "\n" in raw else [raw]


def parse_items(text, split_mode: str = "auto",
                keep_empty: bool = False) -> list[str]:
    items = [_strip_bullet(item) for item in split_items(text, split_mode)]
    return items if keep_empty else [item for item in items if item]


# --------------------------------------------------------------------------
# selection
# --------------------------------------------------------------------------

def _cycle_order(seed, cycle: int, item_count: int) -> list[int]:
    """The seeded shuffle for one no-repeat cycle (``:2701-2703``). The
    RNG is string-seeded on (seed, cycle, count) so any step can be
    recomputed without persisted state."""
    rng = random.Random(f"{int(seed)}:{cycle}:{item_count}")
    order = list(range(item_count))
    rng.shuffle(order)
    return order


def select_index(index, item_count: int, selection_mode: str = "index",
                 seed=0) -> int:
    """Position picked for one step under a selection mode
    (``:2687-2721``)."""
    mode = str(selection_mode or "index").strip().lower()
    if mode == "random":
        rng = random.Random(f"{int(seed)}:{int(index)}:{item_count}")
        return rng.randrange(item_count)
    if mode == "random no repeat":
        if item_count <= 1:
            return 0
        cycle, offset = divmod(int(index), item_count)
        order = _cycle_order(seed, cycle, item_count)
        # Boundary de-dup against the previous cycle's RAW shuffle — the
        # reference's exact arithmetic (``:2706-2709``). NB for 2-item
        # lists the previous cycle's own swap changes its effective last
        # element, so a boundary repeat can still slip through there.
        if cycle > 0 and order[0] == _cycle_order(seed, cycle - 1,
                                                  item_count)[-1]:
            order[0], order[1] = order[1], order[0]
        return order[offset]
    return int(index) % item_count


def format_selected(selected: list[str], multi_format: str = "auto",
                    two_item_template: str = "") -> str:
    """Join multiple picks (``:2724-2747``): the sentence template for
    exactly two under auto/sentence, else lines or commas."""
    if not selected:
        return ""
    if len(selected) == 1:
        return selected[0]
    mode = str(multi_format or "auto").strip().lower()
    if len(selected) == 2 and mode in ("auto", "sentence"):
        template = (str(two_item_template or "").strip()
                    or DEFAULT_TWO_ITEM_TEMPLATE)
        try:
            return template.format(item1=selected[0], item2=selected[1],
                                   items=", ".join(selected))
        except Exception:
            return (f"start with {selected[0]} "
                    f"then follow with {selected[1]}")
    if mode == "lines":
        return "\n".join(selected)
    return ", ".join(selected)


def pick_text(index, items, label: str = "", max_items: int = 0,
              split_mode: str = "auto", selection_mode: str = "index",
              seed=0, multi_format: str = "auto",
              two_item_template: str = DEFAULT_TWO_ITEM_TEMPLATE,
              keep_empty: bool = False, pick_count: int = 1) -> dict:
    """One cycling-picker step (``VRGDG_CyclingTextPicker.run``,
    ``:2749-2786``). Returns the node's five outputs keyed by name."""
    parsed = parse_items(items, split_mode, keep_empty)
    if max_items and max_items > 0:
        parsed = parsed[:max_items]
    if not parsed:
        return {"formatted_text": "", "selected_item": "",
                "selected_items": "", "wrapped_index": 0, "item_count": 0}

    count = len(parsed)
    positions = [select_index(int(index) + step, count, selection_mode,
                              seed)
                 for step in range(max(1, int(pick_count)))]
    selected = [parsed[position] for position in positions]
    value = format_selected(selected, multi_format, two_item_template)
    label_text = str(label or "").strip()
    return {
        "formatted_text": (f"{label_text} = {value}" if label_text
                           else value),
        "selected_item": selected[0],
        "selected_items": "\n".join(selected),
        "wrapped_index": positions[0],
        "item_count": count,
    }


# --------------------------------------------------------------------------
# multi-picker composition
# --------------------------------------------------------------------------

MAX_PICKERS = 20

PRESET_LABELS = ("Camera Motion", "Character Movement/Motion", "Lighting",
                 "Time of Day", "Weather", "Dialogue", "Facial Expression",
                 "Emotion", "Custom")

# Bundled preset lists (user-visible content, reproduced verbatim from
# ``:2802-2910`` so preset-driven workflows keep their vocabulary).
PRESET_ITEMS = {
    "Camera Motion": "\n".join([
        "Slow push-in", "Track right", "Track left", "Dolly backward",
        "Handheld follow", "Over-the-shoulder push-in", "Slow pan right",
        "Slow pan left", "Tilt up", "Tilt down", "Arc around subject",
        "Orbit shot", "Low-angle tracking shot", "Crane rising move",
        "Slow zoom-in"]),
    "Character Movement/Motion": "\n".join([
        "Walks toward camera with confident swagger",
        "Strides across the frame", "Leans toward the camera",
        "Points into the lens", "Throws arms wide",
        "Raises both hands overhead", "Runs a hand through their hair",
        "Slowly backs away from the camera", "Drops to one knee",
        "Throws their head back", "Whips a jacket off one shoulder",
        "Stomps forward with attitude", "Tilts chin upward",
        "Reaches toward the camera", "Collapses dramatically to the floor"]),
    "Lighting": "\n".join([
        "Soft natural light", "Hard direct sunlight", "Warm tungsten light",
        "Cool fluorescent light", "Neon nightclub light",
        "Moody low-key lighting", "High-key studio lighting",
        "Backlit silhouette", "Rim lighting", "Side lighting",
        "Top-down lighting", "Underlighting", "Golden hour light",
        "Blue hour light", "Strobe lighting"]),
    "Time of Day": "\n".join([
        "Pre-dawn", "Dawn", "Early morning", "Mid-morning", "Late morning",
        "Noon", "Early afternoon", "Mid-afternoon", "Late afternoon",
        "Golden hour", "Sunset", "Dusk", "Blue hour", "Night",
        "After midnight"]),
    "Weather": "\n".join([
        "Clear sky", "Partly cloudy", "Overcast", "Light rain",
        "Heavy rain", "Thunderstorm", "Drizzle", "Fog", "Mist", "Snowfall",
        "Blizzard", "Hail", "Strong wind", "Dust storm", "Humid haze"]),
    "Dialogue": "",
    "Facial Expression": "\n".join([
        "Calm expression", "Serious expression", "Confident smirk",
        "Cold stare", "Worried expression", "Sad expression", "Angry glare",
        "Fearful expression", "Surprised expression", "Blank expression",
        "Dreamy expression", "Suspicious look", "Pained expression",
        "Defiant expression", "Soft smile"]),
    "Emotion": "\n".join([
        "Joyful", "Melancholic", "Anxious", "Furious", "Heartbroken",
        "Hopeful", "Jealous", "Lonely", "Nostalgic", "Conflicted",
        "Euphoric", "Ashamed", "Determined", "Vengeful", "Peaceful"]),
    "Custom": "",
}

#: ``# NAME: value`` headers an items text may open with (``:3042-3047``)
_DIRECTIVES = {"LABEL": "label", "SELECTION_MODE": "selection_mode",
               "PICK_COUNT": "pick_count", "TEMPLATE": "template"}

JOINERS = {"newline": "\n", "blank line": "\n\n", "comma": ", ",
           "pipe": " | "}


def extract_item_directives(raw_items) -> tuple[dict, str]:
    """Split ``# LABEL: ...``-style header directives off an items text
    (``:3036-3070``). Directives only count while the text's leading
    comment block lasts; the remainder is returned verbatim."""
    directives: dict[str, str] = {}
    body: list[str] = []
    in_header = True
    for line in str(raw_items or "").splitlines():
        stripped = line.strip()
        if in_header and stripped.startswith("#") and ":" in stripped[1:]:
            name, value = stripped[1:].strip().split(":", 1)
            name = name.strip().upper()
            name = name[6:] if name.startswith("VRGDG_") else name
            if name in _DIRECTIVES:
                directives[_DIRECTIVES[name]] = value.strip()
                continue
        in_header = False
        body.append(line)
    return directives, "\n".join(body)


@dataclass(frozen=True)
class PickerSpec:
    """One picker slot of the multi-picker (``_picker_input_types``)."""
    items: str = ""
    preset: str = "Custom"
    label: str = ""
    index: int = 0
    seed: int = 0
    selection_mode: str = "index"
    two_item_template: str = DEFAULT_TWO_ITEM_TEMPLATE
    pick_count: int = 1


def _label_for(explicit_label, preset: str, directives: dict,
               parsed: list[str]) -> str:
    """Directive > explicit label > non-Custom preset name > recognizing
    a preset's verbatim item list (``:3115-3123``)."""
    label = directives.get("label") or str(explicit_label or "").strip()
    if label:
        return label
    if preset != "Custom":
        return preset
    normalized = "\n".join(parsed).strip()
    for name, preset_items in PRESET_ITEMS.items():
        if normalized == str(preset_items or "").strip():
            return name
    return ""


def run_picker(spec: PickerSpec) -> dict:
    """One multi-picker slot (``_run_one_picker``, ``:3072-3132``)."""
    preset = str(spec.preset or "Custom")
    directives, raw_items = extract_item_directives(spec.items)
    if not str(raw_items or "").strip() and preset in PRESET_ITEMS:
        raw_items = PRESET_ITEMS[preset]
    parsed = parse_items(raw_items, "auto", False)
    if not parsed:
        return {"formatted_text": "", "selected_item": "",
                "selected_items": [], "wrapped_index": 0, "item_count": 0}

    count = len(parsed)
    pick_count = max(1, int(directives.get("pick_count",
                                           spec.pick_count) or 1))
    mode = directives.get("selection_mode") or spec.selection_mode
    template = directives.get("template") or spec.two_item_template
    positions = [select_index(int(spec.index) + step, count, mode,
                              spec.seed)
                 for step in range(pick_count)]
    selected = [parsed[position] for position in positions]
    value = format_selected(selected, "auto", template)
    label = _label_for(spec.label, preset, directives, parsed)
    return {
        "formatted_text": f"{label} = {value}" if label else value,
        "selected_item": selected[0],
        "selected_items": selected,
        "wrapped_index": positions[0],
        "item_count": count,
    }


def run_multi_picker(pickers, joiner: str = "newline") -> dict:
    """The multi-picker composition (``VRGDG_MultiCyclingTextPicker.run``,
    ``:3134-3144``): run each spec, join the non-empty formatted texts."""
    specs = [spec if isinstance(spec, PickerSpec) else PickerSpec(**spec)
             for spec in pickers[:MAX_PICKERS]]
    results = []
    for slot, spec in enumerate(specs, 1):
        result = run_picker(spec)
        results.append({"picker": slot, **result})
    sep = JOINERS.get(str(joiner or "newline").strip().lower(), "\n")
    combined = sep.join(r["formatted_text"] for r in results
                        if r["formatted_text"])
    return {"combined_formatted_text": combined,
            "results": results,
            "formatted_texts": [r["formatted_text"] for r in results]}
