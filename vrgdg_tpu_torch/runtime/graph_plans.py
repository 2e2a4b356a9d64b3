"""Deterministic plans for the reference's graph-glue node families.

A copy of :mod:`vrgdg_tpu.runtime.graph_plans` (which cannot be imported
without JAX): every function and class keeps its original's source,
and every constant its value.

The reference couples three decision tables to ComfyUI side effects:

* the optional multi-LoRA loaders decide *which LoRA files at which
  strengths* to patch into a model, then call ``comfy.sd``
  (``VRGDG_GeneralNodes2.py:1801-2096``);
* the mute/group state switchers decide *which websocket events* to
  emit for which node ids, then call ``PromptServer.send_sync``
  (``VRGDG_GeneralNodes2.py:2168-2357``).

In this framework the decision tables are ported as pure **plan**
functions — given the node payload they return the ordered application
or event list the reference would have produced, byte-comparable in the
oracle fuzz (tests/test_graph_plans.py captures the reference's
``send_sync``/``load_lora_for_models`` calls with fakes and asserts the
sequences match).  The side-effect half is host-specific by nature: a
standalone deployment applies a LoRA plan with
:func:`vrgdg_tpu_torch.ops.lora.apply_lora_plan` over a flat
``{name: tensor}`` mapping, and routes
an event plan to whatever UI bus it runs.
"""

from __future__ import annotations

import json
import os

MAX_LORA_SLOTS = 20          # VRGDG_GeneralNodes2.py:1802
NONE_LORA = "[none]"         # VRGDG_GeneralNodes2.py:1803
MAX_GROUP_SLOTS = 12         # VRGDG_GeneralNodes2.py:2216
GROUP_NONE_OPTION = "<none>"
LORA_FILE_EXTENSIONS = {".safetensors", ".pt", ".pth", ".ckpt"}

__all__ = [
    "MAX_LORA_SLOTS", "NONE_LORA", "MAX_GROUP_SLOTS", "GROUP_NONE_OPTION",
    "lora_stem", "collect_lora_specs", "collect_two_pass_lora_specs",
    "multi_lora_plan", "two_pass_lora_plan", "lora_path_plan",
    "parse_node_ids", "mute_state_plan", "group_state_plan",
    "lora_plan_from_payload", "state_plan_from_payload",
]


# ---------------------------------------------------------------------------
# multi-LoRA loader plans (VRGDG_GeneralNodes2.py:1801-2096)
# ---------------------------------------------------------------------------

def _truthy(value) -> bool:
    """The loaders' boolean coercion: the string ``"true"`` (any case,
    padded) is true, every other string false
    (``VRGDG_GeneralNodes2.py:1884-1887``)."""
    if isinstance(value, str):
        return value.strip().lower() == "true"
    return bool(value)


def _is_none_lora(name) -> bool:
    value = str(name or "").strip()
    return not value or value == NONE_LORA


def lora_stem(name) -> str:
    """Basename without extension, used for the ``lora_names`` summary
    output (``VRGDG_GeneralNodes2.py:1809-1813``)."""
    if not name:
        return ""
    return os.path.splitext(os.path.basename(str(name)))[0]


def _slot_count(lora_count) -> int:
    try:
        count = int(lora_count)
    except Exception:
        count = 0
    return max(0, min(MAX_LORA_SLOTS, count))


def collect_lora_specs(lora_count, slots) -> list[tuple[str, float]]:
    """Ordered ``(lora_name, strength)`` pairs from the slot table.

    Mirrors ``_collect_lora_specs`` (``VRGDG_GeneralNodes2.py:1893-1914``):
    slots above ``lora_count`` are ignored, ``[none]``/blank slots and
    zero-strength slots are skipped, unparsable strengths fall back to
    1.0.  ``slots`` is the ``lora_i``/``strength_i`` mapping.
    """
    specs = []
    for slot in range(1, _slot_count(lora_count) + 1):
        name = slots.get(f"lora_{slot}", NONE_LORA)
        if _is_none_lora(name):
            continue
        try:
            strength = float(slots.get(f"strength_{slot}", 1.0))
        except Exception:
            strength = 1.0
        if strength == 0:
            continue
        specs.append((str(name), strength))
    return specs


def collect_two_pass_lora_specs(lora_count, slots) -> list[
        tuple[str, float, float]]:
    """Two-strength variant (``VRGDG_GeneralNodes2.py:2000-2027``):
    defaults 0.5 / 1.0, a slot survives if EITHER pass strength is
    non-zero."""
    specs = []
    for slot in range(1, _slot_count(lora_count) + 1):
        name = slots.get(f"lora_{slot}", NONE_LORA)
        if _is_none_lora(name):
            continue
        try:
            first = float(slots.get(f"first_pass_strength_{slot}", 0.5))
        except Exception:
            first = 0.5
        try:
            second = float(slots.get(f"second_pass_strength_{slot}", 1.0))
        except Exception:
            second = 1.0
        if first == 0 and second == 0:
            continue
        specs.append((str(name), first, second))
    return specs


def _pass_applications(specs, multiplier) -> list[tuple[str, float]]:
    """One pass's ordered LoRA applications: strengths are scaled by the
    pass multiplier and zero-effective entries are skipped at apply time
    (``_apply_specs``, ``VRGDG_GeneralNodes2.py:1916-1924``)."""
    plan = []
    for name, strength in specs:
        effective = float(strength) * float(multiplier)
        if effective == 0:
            continue
        plan.append((name, effective))
    return plan


def multi_lora_plan(payload) -> dict:
    """Application plan of ``VRGDG_OptionalMultiLoraModelOnly.apply_loras``
    (``VRGDG_GeneralNodes2.py:1926-1940``).

    Returns ``first_pass``/``second_pass`` ordered ``(name, strength)``
    application lists (first pass at half strength in LTX two-pass mode)
    and the comma-joined ``lora_names`` stems.  ``passthrough`` is True
    when the model would flow through unpatched.
    """
    if not _truthy(payload.get("use_custom_loras", False)):
        return {"passthrough": True, "first_pass": [], "second_pass": [],
                "lora_names": ""}
    specs = collect_lora_specs(payload.get("lora_count", 0), payload)
    if not specs:
        return {"passthrough": True, "first_pass": [], "second_pass": [],
                "lora_names": ""}
    two_pass = _truthy(payload.get("ltx_two_pass_mode", True))
    return {
        "passthrough": False,
        "first_pass": _pass_applications(specs, 0.5 if two_pass else 1.0),
        "second_pass": _pass_applications(specs, 1.0),
        "lora_names": ", ".join(lora_stem(name) for name, _ in specs),
    }


def two_pass_lora_plan(payload) -> dict:
    """Application plan of ``VRGDG_OptionalMultiLoraTwoPassStrengths``
    (``VRGDG_GeneralNodes2.py:2029-2042``): independent per-pass
    strengths, both passes at multiplier 1."""
    if not _truthy(payload.get("use_custom_loras", False)):
        return {"passthrough": True, "first_pass": [], "second_pass": [],
                "lora_names": ""}
    specs = collect_two_pass_lora_specs(payload.get("lora_count", 0),
                                        payload)
    if not specs:
        return {"passthrough": True, "first_pass": [], "second_pass": [],
                "lora_names": ""}
    return {
        "passthrough": False,
        "first_pass": _pass_applications(
            [(name, first) for name, first, _ in specs], 1.0),
        "second_pass": _pass_applications(
            [(name, second) for name, _, second in specs], 1.0),
        "lora_names": ", ".join(lora_stem(name) for name, _, _ in specs),
    }


def lora_path_plan(lora_path, strength_model, *, isfile=os.path.isfile
                   ) -> dict:
    """Validation + single application of ``VRGDG_LoraFromPathModelOnly``
    (``VRGDG_GeneralNodes2.py:2045-2096``): empty path or zero strength
    passes through; a missing file or a non-torch extension raises
    ``ValueError`` with the reference's message."""
    path = os.path.normpath(str(lora_path or "").strip().strip('"'))
    strength = float(strength_model)
    # NB: an empty input normpaths to "." (truthy), so it falls through
    # to the existence check and raises — reference behavior, kept.
    if not path or strength == 0:
        return {"passthrough": True, "applications": []}
    if not isfile(path):
        raise ValueError(f"LoRA path does not exist: {path}")
    if os.path.splitext(path)[1].lower() not in LORA_FILE_EXTENSIONS:
        raise ValueError(
            f"LoRA path must be a torch/safetensors file: {path}")
    return {"passthrough": False, "applications": [(path, strength)]}


# ---------------------------------------------------------------------------
# mute / group state event plans (VRGDG_GeneralNodes2.py:2168-2357)
# ---------------------------------------------------------------------------

def parse_node_ids(text) -> list[int]:
    """Comma/semicolon-separated non-negative ints, de-duplicated in
    first-seen order; unparsable parts are dropped
    (``VRGDG_GeneralNodes2.py:2186-2197``)."""
    parsed = []
    parts = [part.strip()
             for part in str(text or "").replace(";", ",").split(",")
             if part.strip()]
    for part in parts:
        try:
            value = int(part)
        except ValueError:
            continue
        if value < 0 or value in parsed:
            continue
        parsed.append(value)
    return parsed


def _state_event(node_id: int, action) -> tuple[str, dict]:
    """One node's state event (``_apply_action``,
    ``VRGDG_GeneralNodes2.py:2262-2277``): active/mute ride the Impact
    mute-state bridge, bypass reuses the bridge-continue event with the
    node listed in ``bypasses``."""
    action = str(action or "mute").lower()
    if action == "active":
        return ("impact-node-mute-state",
                {"node_id": node_id, "is_active": True})
    if action == "bypass":
        return ("impact-bridge-continue",
                {"node_id": str(node_id), "bypasses": [str(node_id)],
                 "mutes": [], "actives": []})
    return ("impact-node-mute-state",
            {"node_id": node_id, "is_active": False})


def mute_state_plan(node_ids, set_state, off_mode) -> list[tuple[str, dict]]:
    """Ordered event list of ``VRGDG_SetMuteStateMulti.doit``
    (``VRGDG_GeneralNodes2.py:2200-2212``): activate is a mute-state
    event per id; deactivate picks mute or bypass per ``off_mode``."""
    events = []
    for node_id in parse_node_ids(node_ids):
        if set_state:
            events.append(("impact-node-mute-state",
                           {"node_id": node_id, "is_active": True}))
        else:
            events.append(_state_event(
                node_id, "bypass" if off_mode == "bypass" else "mute"))
    return events


def group_state_plan(group_targets_json="", node_ids_csv="",
                     group_action="mute", auto_queue_next=False,
                     queue_delay_seconds=0.0) -> dict:
    """Ordered event plan of ``VRGDG_SetGroupStateMulti.doit``
    (``VRGDG_GeneralNodes2.py:2270-2331``).

    Preferred path: the per-group ``{"action", "node_ids"}`` target list
    (malformed JSON degrades to ``[]``, non-dict targets and non-list id
    fields are skipped, ids coerced to non-negative ints).  Fallback:
    one ``group_action`` over the CSV ids, only when no target applied.
    A non-empty target *list* additionally emits the frontend
    apply-node-modes summary.  ``queue_after_seconds`` is ``0.0`` for an
    immediate requeue (the plan includes the event), a positive delay
    for the reference's deferred-thread requeue (the caller schedules
    it), or ``None`` when no requeue happens.
    """
    try:
        targets = json.loads(str(group_targets_json or "[]"))
    except Exception:
        targets = []
    target_list = targets if isinstance(targets, list) else []

    def _target_ids(target):
        ids = target.get("node_ids", []) if isinstance(target, dict) else None
        out = []
        for raw_id in (ids if isinstance(ids, list) else []):
            try:
                value = int(raw_id)
            except Exception:
                continue
            if value >= 0:
                out.append(value)
        return out

    events = [
        _state_event(node_id, target.get("action", "mute"))
        for target in target_list
        for node_id in _target_ids(target)
    ]
    applied = bool(events)

    if not applied:
        events = [_state_event(node_id, group_action)
                  for node_id in parse_node_ids(node_ids_csv)]
        applied = bool(events)

    if target_list:
        events.append(("vrgdg-apply-node-modes", {"targets": targets}))

    queue_after = None
    if applied and bool(auto_queue_next):
        queue_after = max(0.0, float(queue_delay_seconds or 0.0))
        if queue_after <= 0:
            events.append(("impact-add-queue", {}))
    return {"events": events, "applied": applied,
            "queue_after_seconds": queue_after}

def lora_plan_from_payload(payload) -> dict:
    """HTTP/CLI dispatch: route a loose payload to the right LoRA-plan
    variant (``variant``: ``model_only`` default, ``two_pass``,
    ``path``)."""
    variant = str((payload or {}).get("variant", "model_only"))
    if variant == "two_pass":
        return two_pass_lora_plan(payload)
    if variant == "path":
        return lora_path_plan(payload.get("lora_path", ""),
                              payload.get("strength_model", 1.0))
    return multi_lora_plan(payload)


def state_plan_from_payload(payload) -> dict:
    """HTTP/CLI dispatch: ``mode: "mute"`` for the multi-id toggler,
    anything else for the group-state planner."""
    p = payload or {}
    if str(p.get("mode", "group")) == "mute":
        # _truthy, not bool(): form-built clients send "false" strings
        return {"events": mute_state_plan(
            p.get("node_ids", ""), _truthy(p.get("set_state", True)),
            p.get("off_mode", "mute"))}
    return group_state_plan(
        p.get("group_targets_json", ""), p.get("node_ids_csv", ""),
        p.get("group_action", "mute"),
        _truthy(p.get("auto_queue_next", False)),
        p.get("queue_delay_seconds", 0.0))
