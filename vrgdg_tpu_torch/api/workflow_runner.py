"""Workflow-runner entry points: parameter-compatible prompt builders.

A copy of :mod:`vrgdg_tpu.api.workflow_runner` (which cannot be imported
without JAX): every function keeps its original's source; the
templates are read from the JAX package's ``vrgdg_tpu/workflows/``.

The reference's largest module (``VRGDG_WorkflowRunnerNodes.py``, 4,886
LoC) patches vendored ComfyUI *API-format* workflow templates by node id
and input name, returning prompt JSON for an external executor.  SURVEY
§1 scopes the executor itself out (L6) "except for parameter-compatible
entry points" — which are exactly these builders: pure JSON math over
``vrgdg_tpu/workflows/*.json`` (the reference's own template data,
vendored verbatim as data).

Re-derivation notes (not a transcription):

- Payload coercion is a small :class:`Payload` wrapper
  (reference: module functions ``:495-523``).
- The model catalog is standalone: filenames are discovered under an
  explicit models root (``VRGDG_TPU_MODELS`` env or the persisted
  ``model_root.json``), replacing ComfyUI's ``folder_paths`` registry
  (reference: ``:247-362``).  Matching semantics (exact-or-basename,
  ``[none]`` sentinel) are parity-locked by the oracle fuzz.
- Each builder assembles an assignment table ``[(node, input, value)]``
  and applies it in one pass; the recurring LoRA slot-filling patterns
  collapse into :func:`_lora_slot_rows`.

Every builder's output is byte-compared against the AST-extracted
reference function across fuzzed payloads in
``tests/test_workflow_runner.py``.

Deliberately out of standalone scope (documented, raises):
- graph-format workflow conversion (``_workflow_to_api_prompt``
  ``:2199-2421``) — it resolves input names through ComfyUI's live
  ``NODE_CLASS_MAPPINGS``; every shipped template has an API-format
  twin, so the converter only runs for user-supplied graph files.
"""

from __future__ import annotations

import base64
import copy
import hashlib
import json
import os
import random
import re
import shutil
import subprocess
import time
import wave

from ..runtime.minimax_h3 import calculate_minimax_h3_timing
from .paths import DEFAULT_OUTPUT_ROOT

# The templates are data files of the JAX package, read where they lie:
# reading them imports nothing.
_TEMPLATE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "vrgdg_tpu", "workflows")

MAX_LORA_SLOTS = 20              # VRGDG_WorkflowRunnerNodes.py:30
NONE_LORA = "[none]"
REQUIRED_LTX_MSR_LORA = "licon\\LTX-2.3-Licon-MSR-V1.safetensors"
REQUIRED_LTX_INGREDIENTS_LORA = \
    "ltx-2.3-22b-ic-lora-ingredients-0.9.safetensors"
REQUIRED_LTX_ID_LORA = "lora_weights.safetensors"
MIN_LTX_INGREDIENTS_FRAMES = 121
_DEFAULT_PASS1_SIGMAS = ("1., 0.99375, 0.9875, 0.98125, 0.975, 0.909375, "
                         "0.725, 0.421875, 0.0")
_DEFAULT_PASS2_SIGMAS = "0.909375, 0.725, 0.421875, 0.0"
_DEFAULT_INGREDIENTS_SAMPLER = "euler_ancestral_cfg_pp"
_SEED_MAX = 0xFFFFFFFFFFFFFFFF
_I2V_UNET_ALIASES = {
    "LTX-2.3-22B-distilled-11-Q6_K.gguf": "LTX-2.3-22B-distilled-1.1-Q6_K.gguf",
}
_PLACEHOLDER_IMAGE_NAME = "vrgdg_placeholder_i2i.png"
_PLACEHOLDER_IMAGE_B64 = (
    "iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAQAAAC1HAwCAAAAC0lEQVR42mP8/x8AAwMC"
    "AO+/p9sAAAAASUVORK5CYII=")

# template registry: builder key -> vendored template file
# (reference path helpers VRGDG_WorkflowRunnerNodes.py:60-244)
TEMPLATES = {
    "zimage": "text2image_zimage_API.json",
    "krea2": "Krea2_TextToImage_API.json",
    "krea2_2pass": "Krea2_API_2Pass.json",
    "flux_klein": "fluxKleinMultiImage_API.json",
    "ernie_image": "image_ernie_image_turbo_API.json",
    "nb_image": "NB_API.json",
    "z_upscale_enhance": "z_upscaleEnhance_API.json",
    "i2v": "Singlei2vForUI_API.json",
    "t2v": "Singlet2vForUI_API.json",
    "rtv": "SingleRef2VidForUI_API.json",
    "ingredients": "SingleIngredients2Video_ForUI_API.json",
    "id_lora": "LTX2.3_ID_lora_API.json",
    "flf": "LTX2.3_FLF_API.json",
    "minimax_h3": "minimax_audio_driven_builder_api.json",
    "minimax_h3_built_in_audio": "minimax_built_in_audio_builder_api.json",
    "clear_memory": "ClearMemory_API.json",
    "transcribe": "LTX2.3_Transcribe_API.json",
    "timestamped_transcribe": "LTX2.3_Transcribe_2_API.json",
    # hidden Whisper/segmentation workflow the Prompt Creator patches
    # (VRGDG_MusicVideoPromptCreatorNodes.py:409-416)
    "prompt_creator_whisper":
        "LTX2.3_Music_Video_Creator_Prompt_Creator_API.json",
    # Krea2 LoRA Studio's sample renderer (LTXLoraTrain.py:1604-1605)
    "krea2_lora_sample": "Krea2_API_2Pass_Lora_Train_Sample.json",
}


def template_path(key: str) -> str:
    try:
        return os.path.join(_TEMPLATE_DIR, TEMPLATES[key])
    except KeyError:
        raise KeyError(f"Unknown workflow template {key!r}.") from None


def load_api_template(key_or_path: str) -> tuple[str, dict]:
    """Load an API-format prompt template, validating its shape
    (reference ``_load_api_template``, ``:438-446``)."""
    path = (template_path(key_or_path) if key_or_path in TEMPLATES
            else os.path.abspath(key_or_path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Workflow API template was not found: {path}")
    with open(path, "r", encoding="utf-8") as handle:
        prompt = json.load(handle)
    if not isinstance(prompt, dict) or not prompt:
        raise ValueError(
            "Workflow API template is not a valid ComfyUI API prompt JSON.")
    return path, prompt


# --------------------------------------------------------------------------
# payload coercion (reference :495-523)
# --------------------------------------------------------------------------

class Payload:
    """Clamping view over a request payload dict."""

    def __init__(self, data):
        self.data = data if isinstance(data, dict) else {}

    def get(self, key, default=None):
        return self.data.get(key, default)

    def int_(self, key, default, lo=1, hi=16384):
        try:
            value = int(self.data.get(key, default))
        except Exception:
            value = default
        return max(lo, min(hi, value))

    def float_(self, key, default, lo=-100.0, hi=100.0):
        try:
            value = float(self.data.get(key, default))
        except Exception:
            value = default
        return max(lo, min(hi, value))

    def bool_(self, key, default=False):
        value = self.data.get(key, default)
        if isinstance(value, str):
            return value.strip().lower() in {"1", "true", "yes", "on"}
        return bool(value)

    def text(self, key, default=""):
        return str(self.data.get(key, default) or "").strip()

    def first(self, *keys, default=None):
        for key in keys:
            if key in self.data and self.data.get(key) is not None:
                return self.data.get(key)
        return default

    def path(self, key, label, *, kind="file", required=True):
        """Absolute filesystem path with existence check (the recurring
        strip-quotes + abspath + isfile pattern, e.g. ``:1624-1632``)."""
        text = str(self.data.get(key, "") or "").strip().strip('"')
        if not text:
            if required:
                raise ValueError(f"{label} is empty.")
            return ""
        path = os.path.abspath(text)
        checker = os.path.isdir if kind == "dir" else os.path.isfile
        if kind != "any" and not checker(path):
            raise FileNotFoundError(f"{label} was not found: {path}")
        return path

    def seed(self, key="seed", default=1):
        """Seed with the fixed/random mode switch (``:982-985``)."""
        mode = self.text("seed_mode", "fixed").lower() or "fixed"
        value = self.int_(key, default, 0, _SEED_MAX)
        if mode in {"random", "randomize"}:
            value = random.randint(0, _SEED_MAX)
        return value


# --------------------------------------------------------------------------
# standalone model catalog (replaces folder_paths; reference :247-362)
# --------------------------------------------------------------------------

_CATEGORY_EXTENSIONS = {
    "unet": {".safetensors", ".ckpt", ".pt", ".bin", ".gguf"},
    "diffusion_models": {".safetensors", ".ckpt", ".pt", ".bin", ".gguf"},
    "clip": {".safetensors", ".ckpt", ".pt", ".bin"},
    "text_encoders": {".safetensors", ".ckpt", ".pt", ".bin"},
    "vae": {".safetensors", ".ckpt", ".pt", ".bin"},
    "upscale_models": {".safetensors", ".ckpt", ".pt", ".bin"},
}
_DEFAULT_EXTENSIONS = {".safetensors", ".ckpt", ".pt", ".bin", ".gguf"}


def _settings_file(base=None):
    return os.path.join(base or DEFAULT_OUTPUT_ROOT, "vrgdg_settings",
                        "model_root.json")


def load_model_root(base=None) -> dict:
    """Persisted custom models root (the standalone analog of
    ``VRGDG_ModelPathSettings.load_custom_model_root``)."""
    env = str(os.environ.get("VRGDG_TPU_MODELS", "") or "").strip()
    if env:
        return {"models_root": env, "source": "env"}
    try:
        with open(_settings_file(base), "r", encoding="utf-8") as handle:
            data = json.load(handle)
        root = str(data.get("models_root", "") or "").strip()
    except (OSError, ValueError):
        root = ""
    return {"models_root": root, "source": "config" if root else "unset"}


def save_model_root(models_root, base=None) -> dict:
    root = str(models_root or "").strip()
    if root and not os.path.isdir(root):
        raise ValueError(f"Models root is not a directory: {root}")
    path = _settings_file(base)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as handle:
        json.dump({"models_root": root}, handle, indent=2)
    return {"models_root": root, "source": "config" if root else "unset"}


class ModelCatalog:
    """Model-file discovery over an explicit root directory tree.

    ``root/<category>/**`` files with category-appropriate extensions are
    listed with root-relative names (OS separators), matching what the
    reference's manual scan produces (``:328-362``).  ``overrides`` maps
    a category to a fixed name list — the test/fuzz hook and the way a
    caller can mirror a remote executor's catalog exactly.
    """

    def __init__(self, root=None, overrides=None, base=None):
        if root is None:
            root = load_model_root(base).get("models_root", "")
        self.root = str(root or "")
        self.overrides = dict(overrides or {})
        # short-TTL walk cache: a single prompt build resolves dozens of
        # names (clean_lora x 20 slots + the require calls) and the
        # reference leaned on ComfyUI's cached folder_paths. The TTL
        # (vs caching forever) keeps the long-lived default catalog
        # seeing newly installed models between requests.
        self._scan_cache: dict[str, tuple[float, list[str]]] = {}
        self._scan_ttl = 5.0

    def names(self, category) -> list[str]:
        if isinstance(category, (list, tuple)):
            seen, merged = set(), []
            for item in category:
                for name in self.names(item):
                    if name not in seen:
                        seen.add(name)
                        merged.append(name)
            return merged
        category = str(category or "").strip()
        if category in self.overrides:
            return [str(n) for n in self.overrides[category]]
        cached = self._scan_cache.get(category)
        if cached is not None and time.monotonic() - cached[0] < self._scan_ttl:
            return list(cached[1])
        folder = os.path.join(self.root, category) if self.root else ""
        if not category or not folder or not os.path.isdir(folder):
            return []
        extensions = _CATEGORY_EXTENSIONS.get(category, _DEFAULT_EXTENSIONS)
        found = []
        for dirpath, _dirs, files in os.walk(folder):
            for name in files:
                if os.path.splitext(name)[1].lower() not in extensions:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), folder)
                found.append(rel.replace("/", os.sep).replace("\\", os.sep))
        self._scan_cache[category] = (time.monotonic(), found)
        return list(found)

    def lora_choices(self) -> list[str]:
        return [NONE_LORA] + [name for name in self.names("loras")
                              if str(name or "").strip() != NONE_LORA]

    def exists(self, category, value) -> bool:
        """Exact or basename match (reference ``:302-315``)."""
        requested = str(value or "").strip()
        if not requested:
            return False
        requested_base = os.path.basename(requested.replace("\\", "/"))
        for choice in self.names(category):
            text = str(choice or "").strip()
            if not text:
                continue
            if text == requested or \
                    os.path.basename(text.replace("\\", "/")) == requested_base:
                return True
        return False

    def require(self, category, value, label) -> None:
        if self.exists(category, value):
            return
        hint = category[0] if isinstance(category, (list, tuple)) else category
        raise ValueError(
            f"{label} '{value}' was not found in ComfyUI/models/{hint}. "
            "Install the model there, refresh/restart ComfyUI, then try "
            "Krea2 again.")

    def clean_lora(self, value) -> str:
        """``[none]`` unless the name is a known LoRA (``:752-757``)."""
        text = str(value or NONE_LORA).strip()
        return text if text in set(self.lora_choices()) else NONE_LORA

    def clean_msr_lora(self, value) -> str:
        """Slash-tolerant lookup with the required-MSR fallbacks
        (``:760-774``)."""
        text = str(value or REQUIRED_LTX_MSR_LORA).strip()
        choices = set(self.lora_choices())
        for candidate in (text, text.replace("/", "\\"),
                          text.replace("\\", "/"), REQUIRED_LTX_MSR_LORA,
                          REQUIRED_LTX_MSR_LORA.replace("\\", "/"),
                          "LTX-2.3-Licon-MSR-V1.safetensors"):
            if candidate in choices:
                return candidate
        return self.clean_lora(text)

    def clean_required_id_lora(self, value) -> str:
        """ID-LoRA lookup that REFUSES when absent (``:777-796``)."""
        text = str(value or REQUIRED_LTX_ID_LORA).strip()
        choices = set(self.lora_choices())
        candidates = [text, text.replace("/", "\\"), text.replace("\\", "/"),
                      REQUIRED_LTX_ID_LORA,
                      REQUIRED_LTX_ID_LORA.replace("\\", "/")]
        base = os.path.basename(text.replace("\\", "/"))
        if base and base not in candidates:
            candidates.append(base)
        for candidate in candidates:
            if candidate in choices:
                return candidate
        raise ValueError(
            "Required ID-LoRA was not found in ComfyUI/models/loras. "
            "Download AviadDahan/LTX-2.3-ID-LoRA-CelebVHQ-3K and select "
            "the LoRA file.")

    def video_model_choices(self) -> tuple[list[str], list[str]]:
        """(gguf, diffusion) split of the unet catalog (``:287-299``)."""
        gguf, diffusion = [], []
        for choice in self.names(("unet", "diffusion_models")):
            text = str(choice or "").strip()
            if not text:
                continue
            (gguf if text.lower().endswith(".gguf") else diffusion).append(text)
        return gguf, diffusion


_DEFAULT_CATALOG = None


def default_catalog() -> ModelCatalog:
    global _DEFAULT_CATALOG
    if _DEFAULT_CATALOG is None:
        _DEFAULT_CATALOG = ModelCatalog()
    return _DEFAULT_CATALOG


def set_default_catalog(catalog: ModelCatalog | None) -> None:
    global _DEFAULT_CATALOG
    _DEFAULT_CATALOG = catalog


# --------------------------------------------------------------------------
# prompt surgery primitives (reference :370-421, :1527-1615)
# --------------------------------------------------------------------------

def set_input(prompt, node_id, name, value) -> None:
    node = prompt.get(str(node_id))
    if not isinstance(node, dict):
        raise KeyError(f"API prompt node {node_id} was not found.")
    node.setdefault("inputs", {})[name] = value


def set_optional_input(prompt, node_id, name, value) -> bool:
    node = prompt.get(str(node_id))
    if not isinstance(node, dict):
        return False
    node.setdefault("inputs", {})[name] = value
    return True


def apply_rows(prompt, rows) -> None:
    """Apply an assignment table of (node_id, input_name, value)."""
    for node_id, name, value in rows:
        set_input(prompt, node_id, name, value)


def node_id_by_class(prompt, class_type, fallback=None) -> str:
    for node_id, node in prompt.items():
        if isinstance(node, dict) and node.get("class_type") == class_type:
            return str(node_id)
    if fallback is not None and str(fallback) in prompt:
        return str(fallback)
    raise KeyError(f"API prompt node class {class_type} was not found.")


def optional_node_id_by_class(prompt, class_type, title="",
                              fallback_ids=()) -> str:
    wanted_class = str(class_type or "").strip()
    wanted_title = str(title or "").strip()
    for node_id, node in prompt.items():
        if not isinstance(node, dict):
            continue
        if str(node.get("class_type", "") or "").strip() != wanted_class:
            continue
        if wanted_title:
            meta = node.get("_meta") if isinstance(node, dict) else {}
            node_title = str(meta.get("title", "")
                             if isinstance(meta, dict) else "").strip()
            if node_title != wanted_title:
                continue
        return str(node_id)
    for node_id in fallback_ids:
        node = prompt.get(str(node_id))
        if isinstance(node, dict) and \
                str(node.get("class_type", "") or "").strip() == wanted_class:
            return str(node_id)
    return ""


def replace_input_refs(prompt, old_ref, new_ref) -> int:
    """Repoint every ``[node, output]`` edge matching ``old_ref``
    (``:370-384``)."""
    old_id, old_out = str(old_ref[0]), int(old_ref[1])
    replaced = 0
    for node in prompt.values():
        inputs = node.get("inputs") if isinstance(node, dict) else None
        if not isinstance(inputs, dict):
            continue
        for key in list(inputs):
            value = inputs[key]
            if not (isinstance(value, list) and len(value) == 2):
                continue
            if str(value[0]) == old_id and int(value[1] or 0) == old_out:
                inputs[key] = [str(new_ref[0]), int(new_ref[1])]
                replaced += 1
    return replaced


def collapse_switch(prompt, switch_id, selected_id, unused_id) -> bool:
    """Remove a model switch node, wiring consumers straight to the
    selected loader (``:387-399``)."""
    switch_key = str(switch_id or "").strip()
    selected_key = str(selected_id or "").strip()
    unused_key = str(unused_id or "").strip()
    if not switch_key or not selected_key:
        return False
    if switch_key not in prompt or selected_key not in prompt:
        return False
    replace_input_refs(prompt, (switch_key, 0), (selected_key, 0))
    prompt.pop(switch_key, None)
    if unused_key and unused_key != selected_key:
        prompt.pop(unused_key, None)
    return True


def clean_i2v_unet_name(value) -> str:
    text = str(value or "").strip()
    return _I2V_UNET_ALIASES.get(text, text)


def normalize_sigma_text(value, default) -> str:
    """Comma list of floats or the default (``:1553-1565``)."""
    parts = [part.strip() for part in str(value or "").split(",")
             if part.strip()]
    for part in parts:
        try:
            float(part)
        except ValueError:
            return default
    return ", ".join(parts) if parts else default


# --------------------------------------------------------------------------
# input-image ingestion (reference :855-968)
# --------------------------------------------------------------------------

def input_dir(base=None) -> str:
    """The executor-visible image ingest folder (ComfyUI "input" analog)."""
    path = os.environ.get("VRGDG_TPU_INPUT") or \
        os.path.join(base or DEFAULT_OUTPUT_ROOT, "input")
    os.makedirs(path, exist_ok=True)
    return path


def prepare_load_image(path="", data="", name="image.png", base=None) -> str:
    """Copy a path or decode a data URL into the ingest folder and return
    the LoadImage-visible name (``:855-885``)."""
    raw_path = str(path or "").strip().strip('"')
    if raw_path:
        source = os.path.abspath(raw_path)
        if not os.path.isfile(source):
            raise FileNotFoundError(
                f"Image-to-image source was not found: {source}")
        ext = os.path.splitext(source)[1].lower() or ".png"
        target = f"vrgdg_i2i_{int(time.time() * 1000)}{ext}"
        shutil.copy2(source, os.path.join(input_dir(base), target))
        return target
    raw_data = str(data or "").strip()
    if raw_data:
        if "," in raw_data and raw_data.lower().startswith("data:"):
            header, encoded = raw_data.split(",", 1)
            lowered = header.lower()
            ext = (".jpg" if "jpeg" in lowered or "jpg" in lowered
                   else ".webp" if "webp" in lowered else ".png")
        else:
            encoded = raw_data
            ext = os.path.splitext(str(name or ""))[1].lower() or ".png"
        target = f"vrgdg_i2i_{int(time.time() * 1000)}{ext}"
        with open(os.path.join(input_dir(base), target), "wb") as handle:
            handle.write(base64.b64decode(encoded))
        return target
    return ""


def prepare_optional_image(image_info, base=None) -> str:
    """Optional reference image -> LoadImage name or "(none)"
    (``:888-915``)."""
    if not isinstance(image_info, dict):
        return "(none)"
    raw_path = str(image_info.get("path") or image_info.get("filename")
                   or "").strip().strip('"')
    if raw_path:
        if os.path.isabs(raw_path):
            return prepare_load_image(
                raw_path, "", image_info.get("name") or "reference.png",
                base) or "(none)"
        clean = raw_path.replace("\\", "/")
        if "/" not in clean:
            return clean
        for folder in (input_dir(base), DEFAULT_OUTPUT_ROOT):
            candidate = os.path.abspath(os.path.join(folder, clean))
            try:
                if os.path.commonpath([os.path.abspath(folder), candidate]) \
                        != os.path.abspath(folder):
                    continue
            except ValueError:
                continue
            if os.path.isfile(candidate):
                return prepare_load_image(
                    candidate, "",
                    image_info.get("name") or os.path.basename(clean),
                    base) or "(none)"
    name = str(image_info.get("name") or "reference.png")
    prepared = prepare_load_image("", image_info.get("data") or "", name, base)
    return prepared or "(none)"


def ensure_placeholder_image(base=None) -> str:
    """Write the 1x1 transparent placeholder the i2i switches point at
    when disabled (``:951-968``)."""
    target = os.path.join(input_dir(base), _PLACEHOLDER_IMAGE_NAME)
    if not (os.path.isfile(target) and os.path.getsize(target) > 0):
        with open(target, "wb") as handle:
            handle.write(base64.b64decode(_PLACEHOLDER_IMAGE_B64))
    return _PLACEHOLDER_IMAGE_NAME


def resolve_existing_file(raw_path, label="file", base=None) -> str:
    """Find a file among cwd / ingest / output roots (``:918-948``)."""
    text = str(raw_path or "").strip().strip('"').strip("'")
    if not text:
        raise ValueError(f"{label} path is empty.")
    if os.path.isabs(text):
        candidates = [text]
    else:
        candidates = [text, os.path.abspath(text),
                      os.path.join(input_dir(base), text),
                      os.path.join(DEFAULT_OUTPUT_ROOT, text)]
    seen = set()
    for candidate in candidates:
        path = os.path.normpath(os.path.abspath(candidate))
        if path in seen:
            continue
        seen.add(path)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"{label} was not found: {text}")


def scene_output_folder(project_folder, folder_name, payload: Payload) -> str:
    """Per-scene clip folder (``:1535-1541``)."""
    scene_number = payload.int_("scene_number", 0, 0, 999999)
    root = os.path.join(project_folder, folder_name)
    if scene_number > 0:
        root = os.path.join(root, f"scene_{scene_number:04d}")
    os.makedirs(root, exist_ok=True)
    return root


# --------------------------------------------------------------------------
# SRT timing + ingredients preroll padding (reference :1777-1846)
# --------------------------------------------------------------------------

def srt_time_to_seconds(value) -> float:
    text = str(value or "").strip().replace(".", ",")
    hours, minutes, rest = text.split(":", 2)
    seconds, millis = (rest.split(",", 1) + ["0"])[:2]
    return (int(hours) * 3600 + int(minutes) * 60 + int(seconds)
            + int((millis + "000")[:3]) / 1000.0)


def srt_segment_frame_count(path, prompt_number, fps) -> int:
    try:
        with open(path, "r", encoding="utf-8-sig") as handle:
            blocks = (handle.read().replace("\r\n", "\n").replace("\r", "\n")
                      .strip().split("\n\n"))
        segments = []
        for block in blocks:
            for line in block.splitlines():
                if "-->" not in line:
                    continue
                start_text, end_text = line.split("-->", 1)
                segments.append((srt_time_to_seconds(start_text),
                                 srt_time_to_seconds(end_text)))
                break
        index = max(0, int(prompt_number) - 1)
        if index >= len(segments):
            return 0
        start_sec, end_sec = segments[index]
        return max(1, int(round(end_sec * fps)) - int(round(start_sec * fps)))
    except Exception:
        return 0


def pad_ingredients_preroll_tail(srt_path, prompt_number, fps, pre_frames,
                                 tail_loss_frames) -> tuple[int, int]:
    """Split the LTX-ingredients 121-frame minimum shortfall between the
    preroll and the tail (``:1807-1846``; the reference's diagnostic
    prints are telemetry, not contract)."""
    scene_frames = srt_segment_frame_count(srt_path, prompt_number, fps)
    if scene_frames <= 0:
        return pre_frames, tail_loss_frames
    shortfall = max(0, MIN_LTX_INGREDIENTS_FRAMES
                    - (scene_frames + pre_frames + tail_loss_frames))
    if shortfall <= 0:
        return pre_frames, tail_loss_frames
    add_pre = shortfall // 2
    return pre_frames + add_pre, tail_loss_frames + (shortfall - add_pre)


# --------------------------------------------------------------------------
# the recurring LoRA slot-fill patterns (one helper, several modes)
# --------------------------------------------------------------------------

def _lora_slot_rows(node_id, payload: Payload, catalog: ModelCatalog, *,
                    mode: str, reserved=None, user_count=None,
                    use_user=True) -> list:
    """Assignment rows for the 20-slot LoRA loader nodes.

    ``mode``:
      - "two_pass": lora_i + first/second_pass_strength_i straight from
        the payload (zimage two-pass node :1022-1029, i2v/t2v :1662-1668)
      - "single": lora_i + strength_i (ernie :1159-1161, zimage legacy
        node :1030-1034, flux/z-upscale)
      - "first_pass_only": user slots write second strength 0.0 and
        non-slots default (1.0, 0.0) (rtv :1892-1904)
      - "reserved_first": slot 1 is the required LoRA, user slots shift
        up one, non-slots default (1.0, 1.0) (ingredients :1996-2014,
        id_lora :2140-2158); ``reserved`` = (name, first, second)
    """
    rows = []

    def payload_slot(slot):
        legacy = payload.float_(f"strength_{slot}", 1.0)
        return (catalog.clean_lora(payload.get(f"lora_{slot}", NONE_LORA)),
                payload.float_(f"first_pass_strength_{slot}", legacy),
                payload.float_(f"second_pass_strength_{slot}", legacy))

    if mode == "two_pass":
        for slot in range(1, MAX_LORA_SLOTS + 1):
            name, first, second = payload_slot(slot)
            rows += [(node_id, f"lora_{slot}", name),
                     (node_id, f"first_pass_strength_{slot}", first),
                     (node_id, f"second_pass_strength_{slot}", second)]
    elif mode == "single":
        for slot in range(1, MAX_LORA_SLOTS + 1):
            rows += [(node_id, f"lora_{slot}",
                      catalog.clean_lora(payload.get(f"lora_{slot}",
                                                     NONE_LORA))),
                     (node_id, f"strength_{slot}",
                      payload.float_(f"strength_{slot}", 1.0))]
    elif mode == "first_pass_only":
        for slot in range(1, MAX_LORA_SLOTS + 1):
            if use_user and slot <= (user_count or 0):
                name, first, _second = payload_slot(slot)
            else:
                name, first = NONE_LORA, 1.0
            rows += [(node_id, f"lora_{slot}", name),
                     (node_id, f"first_pass_strength_{slot}", first),
                     (node_id, f"second_pass_strength_{slot}", 0.0)]
    elif mode == "reserved_first":
        name, first, second = reserved
        rows += [(node_id, "lora_1", name),
                 (node_id, "first_pass_strength_1", first),
                 (node_id, "second_pass_strength_1", second)]
        for slot in range(2, MAX_LORA_SLOTS + 1):
            user_slot = slot - 1
            if use_user and user_slot <= (user_count or 0):
                name, first, second = payload_slot(user_slot)
            else:
                name, first, second = NONE_LORA, 1.0, 1.0
            rows += [(node_id, f"lora_{slot}", name),
                     (node_id, f"first_pass_strength_{slot}", first),
                     (node_id, f"second_pass_strength_{slot}", second)]
    else:
        raise ValueError(f"Unknown lora slot mode {mode!r}")
    return rows


# --------------------------------------------------------------------------
# LTX video-model loader (GGUF/diffusion switch collapse, :402-421)
# --------------------------------------------------------------------------

def patch_ltx_video_model_loader(prompt, payload: Payload) -> None:
    use_gguf = payload.bool_("use_gguf_model", True)
    gguf_name = clean_i2v_unet_name(payload.get("unet_name", ""))
    diffusion_name = str(payload.get("diffusion_model_name")
                         or payload.get("model_name") or "").strip()
    if not diffusion_name:
        diffusion_name = gguf_name
    switch_id = optional_node_id_by_class(
        prompt, "ComfySwitchNode", "Switch-use GGUF",
        fallback_ids=("955", "939", "959"))
    gguf_id = optional_node_id_by_class(
        prompt, "UnetLoaderGGUF", fallback_ids=("271:215", "969"))
    diffusion_id = optional_node_id_by_class(
        prompt, "DiffusionModelLoaderKJ", fallback_ids=("956", "938", "958"))
    if switch_id:
        set_optional_input(prompt, switch_id, "switch", use_gguf)
    if gguf_id:
        set_optional_input(prompt, gguf_id, "unet_name", gguf_name)
    if diffusion_id:
        set_optional_input(prompt, diffusion_id, "model_name", diffusion_name)
    if switch_id and gguf_id and diffusion_id:
        if use_gguf:
            collapse_switch(prompt, switch_id, gguf_id, diffusion_id)
        else:
            collapse_switch(prompt, switch_id, diffusion_id, gguf_id)


def _sampler_override_rows(payload: Payload, *, passes=2,
                           default_sampler="euler_ancestral") -> list:
    """The LTX sampler/sigma override tables (``:1568-1584``)."""
    rows = [("218:186", "sampler_name",
             payload.text("pass1_sampler_name") or default_sampler),
            ("218:209", "sigmas",
             normalize_sigma_text(payload.get("pass1_sigmas"),
                                  _DEFAULT_PASS1_SIGMAS))]
    if passes == 2:
        rows += [("219:187", "sampler_name",
                  payload.text("pass2_sampler_name") or default_sampler),
                 ("219:208", "sigmas",
                  normalize_sigma_text(payload.get("pass2_sigmas"),
                                       _DEFAULT_PASS2_SIGMAS))]
    return rows


def _ltx_shared_model_rows(payload: Payload) -> list:
    """The shared LTX loader bundle (VAE/CLIP/upscaler/audio-VAE) set by
    every Single*ForUI patch (e.g. ``:1646-1650``)."""
    return [("271:256", "vae_name", payload.text("vae_name")),
            ("271:216", "clip_name1", payload.text("clip_name1")),
            ("271:216", "clip_name2", payload.text("clip_name2")),
            ("271:211", "model_name", payload.text("upscale_model_name")),
            ("271:254", "vae_name", payload.text("audio_vae_name"))]


def _ltx_frame_rows(payload: Payload, fps, seed, *, width=None,
                    height=None) -> list:
    rows = [("736:424", "value", fps)]
    if width is not None:
        rows += [("736:425", "value", width), ("736:426", "value", height)]
    rows += [("736:449", "value", seed), ("736:551", "value", 0)]
    return rows


def _ltx_scene_rows(audio_path, prompt_number, text, srt_path, tail_loss,
                    pre_frames, output_folder, *, image_rows=()) -> list:
    """The shared scene wiring every Single*ForUI template repeats
    (audio loader, prompt picker, SRT, overwrite/preroll, output folder —
    e.g. ``:1670-1686``)."""
    return ([("927", "audio_file", audio_path),
             ("927", "seek_seconds", 0),
             ("927", "duration", 0)]
            + list(image_rows)
            + [("930", "value", prompt_number),
               ("933", "text", text),
               ("933", "output_mode", "string"),
               ("935", "value", srt_path),
               ("218:287", "overwrite_mode", "overwrite"),
               ("218:287", "tail_loss_frames", tail_loss),
               ("218:287", "pre_frames", pre_frames),
               ("437", "value", output_folder)])


# --------------------------------------------------------------------------
# image builders (zimage / krea2 / ernie / krea2 2-pass / flux / NB / zue)
# --------------------------------------------------------------------------

def build_zimage_prompt(payload, catalog=None, base=None) -> dict:
    """Z-Image text-to-image (reference ``_build_zimage_api_prompt`` +
    ``_patch_zimage_api_prompt``, ``:971-1035, 2423-2430``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("zimage")
    prompt = copy.deepcopy(prompt)
    prompt_text = p.text("prompt")
    if not prompt_text:
        raise ValueError("Prompt text is empty.")
    seed = p.seed()
    use_i2i = p.bool_("use_image_to_image", False)

    rows = [("971", "text", prompt_text),
            ("960", "clip_name", p.text("clip_name")),
            ("961", "vae_name", p.text("vae_name")),
            ("972", "unet_name", p.text("unet_name")),
            ("965", "width", p.int_("first_pass_width", 1280, 64, 4096)),
            ("965", "height", p.int_("first_pass_height", 720, 64, 4096)),
            ("965", "batch_size", p.int_("batch_size", 1, 1, 16)),
            ("967", "width", p.int_("second_pass_width", 1920, 64, 4096)),
            ("967", "height", p.int_("second_pass_height", 1080, 64, 4096)),
            ("964", "noise_seed", seed),
            ("966", "noise_seed", seed),
            ("978", "switch", use_i2i),
            ("981", "switch", use_i2i),
            ("983", "value",
             p.int_("image_to_image_start_at_step", 5, 1, 8)),
            ("979", "image", ensure_placeholder_image(base))]
    apply_rows(prompt, rows)
    if use_i2i:
        image_name = prepare_load_image(
            p.get("image_to_image_path", ""), p.get("image_to_image_data", ""),
            p.get("image_to_image_name", "image.png"), base)
        if not image_name:
            raise ValueError(
                "Image-to-image is enabled, but no source image was provided.")
        set_input(prompt, "979", "image", image_name)

    lora_node = node_id_by_class(
        prompt, "VRGDG_OptionalMultiLoraTwoPassStrengths", fallback=974)
    two_pass = prompt.get(str(lora_node), {}).get("class_type") == \
        "VRGDG_OptionalMultiLoraTwoPassStrengths"
    apply_rows(prompt, [
        (lora_node, "use_custom_loras", p.bool_("use_custom_loras", False)),
        (lora_node, "lora_count", p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)),
    ])
    if two_pass:
        apply_rows(prompt, _lora_slot_rows(lora_node, p, catalog,
                                           mode="two_pass"))
    else:
        set_input(prompt, lora_node, "ltx_two_pass_mode",
                  p.bool_("ltx_two_pass_mode", False))
        apply_rows(prompt, _lora_slot_rows(lora_node, p, catalog,
                                           mode="single"))
    return {"workflow_path": workflow_path, "prompt": prompt,
            "used_seed": seed}


def build_krea2_prompt(payload, catalog=None, base=None) -> dict:
    """Krea2 + optional Z-Image enhance pass (``:1038-1111, 2433-2440``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("krea2")
    prompt = copy.deepcopy(prompt)
    prompt_text = p.text("prompt")
    if not prompt_text:
        raise ValueError("Prompt text is empty.")
    width = p.int_("width", 1920, 64, 4096)
    height = p.int_("height", 1080, 64, 4096)
    first_width = p.int_("first_pass_width", 1024, 64, 4096)
    first_height = p.int_("first_pass_height", 576, 64, 4096)
    seed = p.seed()
    use_enhance = p.bool_("use_zimage_enhance", True)
    enhance_strength = max(0.1, min(1.0, p.float_("zimage_enhance_strength",
                                                  0.5)))

    krea_unet = str(p.get("krea_unet_name") or p.get("unet_name")
                    or "krea2_turbo_fp8_scaled.safetensors").strip()
    krea_clip = str(p.get("krea_clip_name") or p.get("clip_name")
                    or "qwen3vl_4b_fp8_scaled.safetensors").strip()
    krea_vae = str(p.get("krea_vae_name") or p.get("vae_name")
                   or "qwen_image_vae.safetensors").strip()
    z_unet = str(p.get("z_unet_name") or p.get("enhance_unet_name")
                 or "z_image_turbo_bf16.safetensors").strip()
    z_clip = str(p.get("z_clip_name") or p.get("enhance_clip_name")
                 or "qwen_3_4b.safetensors").strip()
    z_vae = str(p.get("z_vae_name") or p.get("enhance_vae_name")
                or "ae.safetensors").strip()
    catalog.require(("diffusion_models", "unet"), krea_unet,
                    "Krea2 diffusion model")
    catalog.require(("text_encoders", "clip"), krea_clip, "Krea2 text encoder")
    catalog.require("vae", krea_vae, "Krea2 VAE")
    if use_enhance:
        catalog.require(("unet", "diffusion_models"), z_unet,
                        "ZImage enhancer diffusion model")
        catalog.require(("clip", "text_encoders"), z_clip,
                        "ZImage enhancer text encoder")
        catalog.require("vae", z_vae, "ZImage enhancer VAE")

    # a 10-step partial denoise: higher strength starts earlier, letting
    # the enhancer change more (reference comment :1087-1090)
    enhance_steps = 10
    enhance_start = max(0, min(enhance_steps - 1,
                               round(enhance_steps * (1.0 - enhance_strength))))
    apply_rows(prompt, [
        ("200", "text", prompt_text),
        ("30:10", "unet_name", krea_unet),
        ("30:11", "clip_name", krea_clip),
        ("30:12", "vae_name", krea_vae),
        ("30:3", "seed", seed),
        ("30:5", "batch_size", p.int_("batch_size", 1, 1, 16)),
        ("201", "width", first_width),
        ("201", "height", first_height),
        ("193:16", "unet_name", z_unet),
        ("193:18", "clip_name", z_clip),
        ("193:17", "vae_name", z_vae),
        ("193:86", "noise_seed", seed),
        ("193:98", "width", width),
        ("193:98", "height", height),
        ("193:82", "steps", enhance_steps),
        ("193:82", "start_at_step", enhance_start),
        ("193:82", "end_at_step", enhance_steps),
    ])
    if not use_enhance:
        # repoint the PreviewImage output at the Krea decode so ComfyUI
        # never executes the unreferenced enhancer branch (:1095-1098)
        set_input(prompt, "199", "images", ["30:8", 0])

    aspect_node = prompt.get("49")
    if isinstance(aspect_node, dict):
        inputs = aspect_node.setdefault("inputs", {})
        ratio = width / max(1, height)
        label = ("16:9 (Widescreen)" if abs(ratio - 16 / 9) < 0.04
                 else "1:1 (Square)" if abs(ratio - 1) < 0.04
                 else "9:16 (Portrait)" if ratio < 1 else None)
        if label is not None:
            inputs["aspect_ratio"] = label
        inputs["megapixels"] = max(
            0.25, round((first_width * first_height) / 1000000, 2))
    return {"workflow_path": workflow_path, "prompt": prompt,
            "used_seed": seed}


def build_ernie_image_prompt(payload, catalog=None, base=None) -> dict:
    """ERNIE image turbo (``:1114-1162, 2453-2460``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("ernie_image")
    prompt = copy.deepcopy(prompt)
    prompt_text = p.text("prompt")
    if not prompt_text:
        raise ValueError("Prompt text is empty.")
    width = p.int_("width", 1280, 64, 4096)
    height = p.int_("height", 720, 64, 4096)
    batch_size = p.int_("batch_size", 1, 1, 16)
    seed = p.seed()
    use_i2i = p.bool_("use_image_to_image", False)

    rows = [("111", "text", prompt_text),
            ("105", "unet_name", p.text("unet_name")),
            ("108", "clip_name", p.text("clip_name")),
            ("109", "vae_name", p.text("vae_name"))]
    for node_id in ("104", "120"):
        rows += [(node_id, "width", width), (node_id, "height", height),
                 (node_id, "batch_size", batch_size)]
    rows += [("121", "noise_seed", seed),
             ("114", "switch", use_i2i),
             ("117", "switch", use_i2i),
             ("115", "value", p.int_("image_to_image_start_at_step", 5, 1, 8)),
             ("118", "image", ensure_placeholder_image(base))]
    apply_rows(prompt, rows)
    if use_i2i:
        image_name = prepare_load_image(
            p.get("image_to_image_path", ""), p.get("image_to_image_data", ""),
            p.get("image_to_image_name", "image.png"), base)
        if not image_name:
            raise ValueError(
                "Image-to-image is enabled, but no source image was provided.")
        set_input(prompt, "118", "image", image_name)
    apply_rows(prompt, [
        ("113", "use_custom_loras", p.bool_("use_custom_loras", False)),
        ("113", "lora_count", p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)),
        ("113", "ltx_two_pass_mode", False),
    ])
    apply_rows(prompt, _lora_slot_rows("113", p, catalog, mode="single"))
    return {"workflow_path": workflow_path, "prompt": prompt,
            "used_seed": seed}


def build_krea2_2pass_prompt(payload, catalog=None, base=None) -> dict:
    """Krea2 native two-pass (``:1165-1232, 2443-2450``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("krea2_2pass")
    prompt = copy.deepcopy(prompt)
    prompt_text = p.text("prompt")
    if not prompt_text:
        raise ValueError("Krea 2 prompt text is empty.")
    aspect_ratio = p.text("aspect_ratio") or "16:9 (Widescreen)"
    seed = p.seed()
    cfg = max(1.0, min(1.2, p.float_("cfg", 1.2)))
    use_i2i = p.bool_("use_image_to_image", False)

    unet_name = (p.text("unet_name")
                 or "krea2_turbo_fp8_scaled.safetensors")
    clip_name = (p.text("clip_name")
                 or "qwen3vl_4b_fp8_scaled.safetensors")
    vae_name = p.text("vae_name") or "qwen_image_vae.safetensors"
    use_loras = p.bool_("use_custom_loras", p.bool_("use_loras", False))
    lora_count = p.int_("lora_count", 0, 0, 20) if use_loras else 0
    catalog.require(("diffusion_models", "unet"), unet_name,
                    "Krea 2 diffusion model")
    catalog.require(("text_encoders", "clip"), clip_name,
                    "Krea 2 text encoder")
    catalog.require("vae", vae_name, "Krea 2 VAE")
    for slot in range(1, lora_count + 1):
        name = catalog.clean_lora(p.get(f"lora_{slot}", NONE_LORA))
        if name != NONE_LORA:
            catalog.require("loras", name, f"Krea 2 LoRA {slot}")

    rows = [("228", "text", prompt_text),
            ("236", "unet_name", unet_name),
            ("233", "clip_name", clip_name),
            ("234", "vae_name", vae_name),
            ("248", "use_custom_loras", bool(use_loras and lora_count > 0)),
            ("248", "lora_count", lora_count if use_loras else 0)]
    for slot in range(1, 21):
        name = catalog.clean_lora(p.get(f"lora_{slot}", NONE_LORA))
        legacy = p.float_(f"strength_{slot}", 1.0)
        if not use_loras or slot > lora_count:
            name = NONE_LORA
        rows += [("248", f"lora_{slot}", name),
                 ("248", f"first_pass_strength_{slot}",
                  p.float_(f"first_pass_strength_{slot}", legacy)),
                 ("248", f"second_pass_strength_{slot}",
                  p.float_(f"second_pass_strength_{slot}", legacy))]
    rows += [("238", "aspect_ratio", aspect_ratio),
             ("49", "aspect_ratio", aspect_ratio),
             ("240", "batch_size", p.int_("batch_size", 1, 1, 16)),
             ("245", "value",
              p.int_("image_to_image_creativity", 5, 0, 10)),
             ("242", "switch", use_i2i),
             ("243", "switch", use_i2i),
             ("235", "sampler_name",
              p.text("sampler_name") or "euler_ancestral_cfg_pp")]
    for node_id in ("230", "231"):
        rows += [(node_id, "noise_seed", seed), (node_id, "cfg", cfg)]
    apply_rows(prompt, rows)

    if use_i2i:
        image_name = prepare_load_image(
            p.get("image_to_image_path", ""), p.get("image_to_image_data", ""),
            p.get("image_to_image_name", "image.png"), base)
        if not image_name:
            raise ValueError(
                "Krea 2 image-to-image is enabled, but no source image was "
                "provided.")
        set_input(prompt, "249", "image", image_name)
    return {"workflow_path": workflow_path, "prompt": prompt,
            "used_seed": seed}


def _ingredient_image_paths(payload: Payload, label, base=None) -> list[str]:
    """Resolve a list of {path|data|name} image ingredients to absolute
    paths (``:1306-1331``)."""
    ingredients = payload.get("image_ingredients") or payload.get("images") \
        or []
    if isinstance(ingredients, str):
        try:
            ingredients = json.loads(ingredients)
        except Exception:
            ingredients = [{"path": line.strip()}
                           for line in ingredients.splitlines()
                           if line.strip()]
    if not isinstance(ingredients, list):
        raise ValueError(f"{label.title()}s must be a list.")
    paths = []
    ingest = input_dir(base)
    for index, item in enumerate(ingredients, start=1):
        if isinstance(item, str):
            item = {"path": item}
        if not isinstance(item, dict):
            continue
        raw_path = str(item.get("path", "") or "").strip()
        raw_data = str(item.get("data", "") or "").strip()
        raw_name = (str(item.get("name", "") or f"{label}_{index}.png").strip()
                    or f"{label}_{index}.png")
        if raw_data:
            name = prepare_load_image("", raw_data, raw_name, base)
            paths.append(os.path.abspath(os.path.join(ingest, name)))
        elif raw_path:
            paths.append(os.path.abspath(resolve_existing_file(
                raw_path, f"{label.title()} {index}", base)))
    return paths


def build_flux_klein_prompt(payload, catalog=None, base=None) -> dict:
    """Flux Klein multi-image (``:1235-1303, 3040-3046``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("flux_klein")
    prompt = copy.deepcopy(prompt)
    prompt_text = p.text("prompt")
    if not prompt_text:
        raise ValueError("Flux/Klein prompt text is empty.")
    image_paths = _ingredient_image_paths(p, "Flux/Klein ingredient image",
                                          base)
    width = p.int_("width", 1024, 64, 4096)
    height = p.int_("height", 576, 64, 4096)
    seed = p.int_("seed", 100, 0, _SEED_MAX)

    set_input(prompt, "1067", "text", prompt_text)
    for node_id in ("1065", "1052"):
        if node_id in prompt:
            set_input(prompt, node_id, "width", width)
            set_input(prompt, node_id, "height", height)
    if "1057" in prompt:
        apply_rows(prompt, [("1057", "width", width),
                            ("1057", "height", height),
                            ("1057", "batch_size", 1)])
    apply_rows(prompt, [("1056", "noise_seed", seed),
                        ("1068", "unet_name", p.text("unet_name")),
                        ("1066", "clip_name", p.text("clip_name")),
                        ("1064", "vae_name", p.text("vae_name"))])
    lora_node = node_id_by_class(prompt, "VRGDG_OptionalMultiLoraModelOnly",
                                 fallback=1075)
    apply_rows(prompt, [
        (lora_node, "use_custom_loras", p.bool_("use_custom_loras", False)),
        (lora_node, "lora_count", p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)),
    ])
    if "ltx_two_pass_mode" in prompt[lora_node].get("inputs", {}):
        set_input(prompt, lora_node, "ltx_two_pass_mode", False)
    apply_rows(prompt, _lora_slot_rows(lora_node, p, catalog, mode="single"))
    if image_paths:
        set_input(prompt, "1072", "image_paths",
                  json.dumps(image_paths, ensure_ascii=False))
    else:
        if "1053" in prompt:
            set_input(prompt, "1053", "positive", ["1067", 0])
            set_input(prompt, "1053", "negative", ["1058", 0])
        prompt.pop("1072", None)
        prompt.pop("1059", None)
    return {"workflow_path": workflow_path, "prompt": prompt}


def _looks_like_prompt_text(value) -> bool:
    text = str(value or "").strip()
    return len(text) > 20 and any(ch.isspace() for ch in text)


def _looks_like_api_key(value) -> bool:
    text = str(value or "").strip()
    return len(text) >= 20 and not any(ch.isspace() for ch in text)


def build_nb_image_prompt(payload, catalog=None, base=None) -> dict:
    """NanoBanana Pro image (``:1344-1369, 3049-3055``); swaps the prompt
    and API key when the user pasted them into the wrong fields."""
    p = Payload(payload)
    workflow_path, prompt = load_api_template("nb_image")
    prompt = copy.deepcopy(prompt)
    prompt_text = p.text("prompt")
    api_key = p.text("api_key")
    if _looks_like_prompt_text(api_key) and _looks_like_api_key(prompt_text):
        api_key, prompt_text = prompt_text, api_key
    if not prompt_text:
        raise ValueError("NanoBanana prompt text is empty.")
    if not api_key:
        raise ValueError("NanoBanana needs an API key.")
    if any(ch.isspace() for ch in api_key):
        raise ValueError(
            "NanoBanana API key looks invalid. It appears to contain prompt "
            "text; paste the Google API key into the NanoBanana API key "
            "field.")
    image_paths = _ingredient_image_paths(p, "NanoBanana reference image",
                                          base)
    nb_node = node_id_by_class(prompt, "VRGDG_NanoBananaPro", fallback=1)
    loader = node_id_by_class(prompt, "VRGDG_ImageBatchMultiFromPaths",
                              fallback=3)
    apply_rows(prompt, [
        (nb_node, "api_key", api_key),
        (nb_node, "prompt", prompt_text),
        (nb_node, "model",
         str(p.get("model", "") or "gemini-3-pro-image-preview")),
    ])
    if image_paths:
        set_input(prompt, loader, "image_paths",
                  json.dumps(image_paths, ensure_ascii=False))
    else:
        prompt.get(str(nb_node), {}).get("inputs", {}).pop("image1", None)
        prompt.pop(str(loader), None)
    return {"workflow_path": workflow_path, "prompt": prompt}


def build_z_upscale_enhance_prompt(payload, catalog=None, base=None) -> dict:
    """Z-Image upscale/enhance of a source image (``:1418-1456,
    3058-3075``; the graph-format fallback never triggers — the API
    template is vendored)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("z_upscale_enhance")
    prompt = copy.deepcopy(prompt)
    seed = p.seed()
    image_name = prepare_load_image(
        p.get("source_image_path", ""), p.get("source_image_data", ""),
        p.get("source_image_name", "source.png"), base)
    if not image_name:
        raise ValueError("Upscale/enhance needs a source image.")
    apply_rows(prompt, [
        ("960", "clip_name", p.text("clip_name")),
        ("961", "vae_name", p.text("vae_name")),
        ("972", "unet_name", p.text("unet_name")),
        ("971", "text", p.text("prompt")),
        ("967", "width", p.int_("width", 1920, 64, 4096)),
        ("967", "height", p.int_("height", 1080, 64, 4096)),
        ("979", "image", image_name),
        ("983", "value", p.int_("enhance_amount", 8, 1, 20)),
        ("964", "noise_seed", seed),
        ("974", "use_custom_loras", p.bool_("use_custom_loras", False)),
        ("974", "lora_count", p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)),
        ("974", "ltx_two_pass_mode", False),
    ])
    apply_rows(prompt, _lora_slot_rows("974", p, catalog, mode="single"))
    return {"workflow_path": workflow_path, "prompt": prompt,
            "used_seed": seed}


# --------------------------------------------------------------------------
# LTX scene-video builders (i2v / t2v / rtv / ingredients / id_lora / flf)
# --------------------------------------------------------------------------

def build_i2v_prompt(payload, catalog=None, base=None) -> dict:
    """Image-to-video scene render (``:1618-1687, 2877-2893``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    if p.get("workflow_path"):
        # the reference falls back to its graph-format converter here,
        # which needs ComfyUI's live node registry; standalone callers
        # must supply API-format templates
        raise ValueError(
            "Custom workflow_path overrides need a ComfyUI graph "
            "converter; export the workflow in API format instead.")
    workflow_path, prompt = load_api_template("i2v")
    prompt = copy.deepcopy(prompt)
    i2v_prompt = p.text("i2v_prompt")
    if not i2v_prompt:
        raise ValueError("I2V prompt is empty.")
    audio_path = p.path("audio_path", "Audio file")
    image_folder = p.path("image_folder", "Image folder", kind="dir")
    srt_path = p.path("srt_path", "SRT file")
    project_folder = p.path("project_folder", "Project folder", kind="any")
    output_folder = scene_output_folder(project_folder,
                                        "image_to_video_clips", p)
    seed = p.int_("seed", 1, 0, _SEED_MAX)

    patch_ltx_video_model_loader(prompt, p)
    apply_rows(prompt, _ltx_shared_model_rows(p))
    apply_rows(prompt, _ltx_frame_rows(
        p, p.int_("fps", 24, 1, 120), seed,
        width=p.int_("width", 1920, 64, 4096),
        height=p.int_("height", 1080, 64, 4096)))
    apply_rows(prompt, [
        ("937", "use_custom_loras", p.bool_("use_custom_loras", False)),
        ("937", "lora_count", p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)),
    ])
    apply_rows(prompt, _lora_slot_rows("937", p, catalog, mode="two_pass"))
    apply_rows(prompt, _ltx_scene_rows(
        audio_path, p.int_("prompt_number_one_based", 1, 1, 999999),
        i2v_prompt, srt_path,
        p.int_("tail_loss_frames", 25, 0, 10000),
        p.int_("pre_frames", 50, 0, 10000), output_folder,
        image_rows=[("925", "folder_path", image_folder),
                    ("929", "value",
                     p.int_("image_index_zero_based", 0, 0, 999999))]))
    apply_rows(prompt, _sampler_override_rows(p))
    apply_rows(prompt, [
        ("218:222", "strength",
         p.float_("pass1_inplace_strength", 1.0, 0.0, 1.0)),
        ("218:222", "bypass", p.bool_("pass1_inplace_bypass", False)),
        ("219:221", "strength",
         p.float_("pass2_inplace_strength", 1.0, 0.0, 1.0)),
        ("219:221", "bypass", p.bool_("pass2_inplace_bypass", False)),
    ])
    return {"workflow_path": workflow_path, "output_folder": output_folder,
            "prompt": prompt}


def build_t2v_prompt(payload, catalog=None, base=None) -> dict:
    """Text-to-video scene render (``:1690-1752, 2896-2903``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("t2v")
    prompt = copy.deepcopy(prompt)
    t2v_prompt = str(p.get("t2v_prompt", p.get("i2v_prompt", ""))
                     or "").strip()
    if not t2v_prompt:
        raise ValueError("T2V prompt is empty.")
    audio_path = p.path("audio_path", "Audio file")
    srt_path = p.path("srt_path", "SRT file")
    project_folder = p.path("project_folder", "Project folder", kind="any")
    output_folder = scene_output_folder(project_folder,
                                        "text_to_video_clips", p)
    seed = p.int_("seed", 1, 0, _SEED_MAX)

    patch_ltx_video_model_loader(prompt, p)
    apply_rows(prompt, _ltx_shared_model_rows(p))
    apply_rows(prompt, _ltx_frame_rows(
        p, p.int_("fps", 24, 1, 120), seed,
        width=p.int_("width", 1920, 64, 4096),
        height=p.int_("height", 1080, 64, 4096)))
    apply_rows(prompt, [
        ("937", "use_custom_loras", p.bool_("use_custom_loras", False)),
        ("937", "lora_count", p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)),
    ])
    apply_rows(prompt, _lora_slot_rows("937", p, catalog, mode="two_pass"))
    apply_rows(prompt, _ltx_scene_rows(
        audio_path, p.int_("prompt_number_one_based", 1, 1, 999999),
        t2v_prompt, srt_path,
        p.int_("tail_loss_frames", 25, 0, 10000),
        p.int_("pre_frames", 50, 0, 10000), output_folder))
    apply_rows(prompt, _sampler_override_rows(p))
    return {"workflow_path": workflow_path, "output_folder": output_folder,
            "prompt": prompt}


def rtv_reference_strength(value) -> str:
    text = str(value or "").strip().lower()
    for prefix, label in (("17", "17 - light"), ("25", "25 - balanced"),
                          ("33", "33 - strong"), ("41", "41 - strongest")):
        if text.startswith(prefix):
            return label
    return "auto - based on subject count"


def rtv_background_mode(value, has_background) -> str:
    text = str(value or "").strip().lower()
    if "neutral" in text or "placeholder" in text:
        return "neutral_placeholder_wip"
    return ("use_uploaded_background" if has_background
            else "neutral_placeholder_wip")


def build_rtv_prompt(payload, catalog=None, base=None) -> dict:
    """Reference-to-video (MSR) scene render (``:1849-1936,
    2906-2913``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("rtv")
    prompt = copy.deepcopy(prompt)
    rtv_prompt = str(p.get("t2v_prompt", p.get("i2v_prompt", ""))
                     or "").strip()
    if not rtv_prompt:
        raise ValueError("Reference-to-video prompt is empty.")
    audio_path = p.path("audio_path", "Audio file")
    srt_path = p.path("srt_path", "SRT file")
    project_folder = p.path("project_folder", "Project folder", kind="any")
    output_folder = scene_output_folder(project_folder,
                                        "reference_to_video_clips", p)
    seed = p.int_("seed", 1, 0, _SEED_MAX)

    patch_ltx_video_model_loader(prompt, p)
    rows = _ltx_shared_model_rows(p)
    # the RTV template has no upscaler row on some revisions — optional
    upscale_row = rows.pop(3)
    apply_rows(prompt, rows)
    set_optional_input(prompt, *upscale_row)
    apply_rows(prompt, _ltx_frame_rows(
        p, p.int_("fps", 24, 1, 120), seed,
        width=p.int_("width", 1920, 64, 4096),
        height=p.int_("height", 1080, 64, 4096)))

    use_user = p.bool_("use_custom_loras", False)
    user_count = p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)
    apply_rows(prompt, [
        ("937", "use_custom_loras", use_user),
        ("937", "lora_count", user_count if use_user else 0),
    ])
    apply_rows(prompt, _lora_slot_rows("937", p, catalog,
                                       mode="first_pass_only",
                                       user_count=user_count,
                                       use_user=use_user))
    apply_rows(prompt, [
        ("953", "lora_name",
         catalog.clean_msr_lora(p.get("msr_lora_name",
                                      REQUIRED_LTX_MSR_LORA))),
        ("953", "strength_model", p.float_("msr_first_pass_strength", 1.0)),
    ])

    references = (p.get("rtv_references")
                  if isinstance(p.get("rtv_references"), dict) else {})
    subjects = (references.get("subjects")
                if isinstance(references.get("subjects"), list) else [])
    subject_images = [prepare_optional_image(item, base)
                      for item in subjects[:4]]
    if references.get("use_subject_placeholder") and \
            not any(image != "(none)" for image in subject_images):
        subject_images = [ensure_placeholder_image(base)]
    while len(subject_images) < 4:
        subject_images.append("(none)")
    background_image = prepare_optional_image(references.get("background"),
                                              base)
    has_background = background_image != "(none)"
    for index, image_name in enumerate(subject_images, start=1):
        set_input(prompt, "951", f"subject_{index}", image_name)
    apply_rows(prompt, [
        ("951", "background_image", background_image),
        ("951", "background_mode",
         rtv_background_mode(p.get("msr_background_mode"), has_background)),
        ("951", "reference_strength",
         rtv_reference_strength(p.get("msr_reference_strength"))),
    ])
    apply_rows(prompt, _ltx_scene_rows(
        audio_path, p.int_("prompt_number_one_based", 1, 1, 999999),
        rtv_prompt, srt_path,
        p.int_("tail_loss_frames", 25, 0, 10000),
        p.int_("pre_frames", 50, 0, 10000), output_folder))
    apply_rows(prompt, _sampler_override_rows(p, passes=1))
    return {"workflow_path": workflow_path, "output_folder": output_folder,
            "prompt": prompt}


def build_ingredients_prompt(payload, catalog=None, base=None) -> dict:
    """Ingredients-to-video scene render (``:1939-2031, 2916-2923``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("ingredients")
    prompt = copy.deepcopy(prompt)
    ingredients_prompt = str(p.get("t2v_prompt", p.get("i2v_prompt", ""))
                             or "").strip()
    if not ingredients_prompt:
        raise ValueError("Ingredients-to-video prompt is empty.")
    audio_path = p.path("audio_path", "Audio file")
    srt_path = p.path("srt_path", "SRT file")
    project_folder = p.path("project_folder", "Project folder", kind="any")
    output_folder = scene_output_folder(project_folder,
                                        "ingredients_to_video_clips", p)
    image_path = os.path.abspath(
        str(p.get("ingredients_image_path", "") or "").strip().strip('"'))
    if not os.path.isfile(image_path):
        raise FileNotFoundError(
            f"Ingredients reference image was not found: {image_path}")

    prompt_number = p.int_("prompt_number_one_based", 1, 1, 999999)
    fps = p.int_("fps", 24, 1, 120)
    width = p.int_("width", 768, 64, 4096)
    height = p.int_("height", 448, 64, 4096)
    seed = p.int_("seed", 1, 0, _SEED_MAX)
    pre_frames, tail_loss = pad_ingredients_preroll_tail(
        srt_path, prompt_number, fps,
        p.int_("pre_frames", 50, 0, 10000),
        p.int_("tail_loss_frames", 25, 0, 10000))

    patch_ltx_video_model_loader(prompt, p)
    apply_rows(prompt, _ltx_shared_model_rows(p))
    apply_rows(prompt, _ltx_frame_rows(p, fps, seed))
    set_optional_input(prompt, "940", "width", width)
    set_optional_input(prompt, "940", "height", height)
    set_optional_input(prompt, "943", "resize_type.shorter_size",
                       min(width, height))

    use_user = p.bool_("use_custom_loras", False)
    user_count = p.int_("lora_count", 0, 0, MAX_LORA_SLOTS - 1)
    apply_rows(prompt, [
        ("937", "use_custom_loras", True),
        ("937", "lora_count", 1 + (user_count if use_user else 0)),
    ])
    apply_rows(prompt, _lora_slot_rows(
        "937", p, catalog, mode="reserved_first",
        reserved=(catalog.clean_lora(p.get("ingredients_lora_name",
                                           REQUIRED_LTX_INGREDIENTS_LORA)),
                  p.float_("ingredients_first_pass_strength", 1.0), 0.0),
        user_count=user_count, use_user=use_user))
    apply_rows(prompt, [("957", "image", image_path),
                        ("957", "custom_width", 0),
                        ("957", "custom_height", 0)])
    apply_rows(prompt, _ltx_scene_rows(
        audio_path, prompt_number, ingredients_prompt, srt_path, tail_loss,
        pre_frames, output_folder))
    apply_rows(prompt, _sampler_override_rows(
        p, default_sampler=_DEFAULT_INGREDIENTS_SAMPLER))
    return {"workflow_path": workflow_path, "output_folder": output_folder,
            "prompt": prompt}


def build_id_lora_prompt(payload, catalog=None, base=None) -> dict:
    """ID-LoRA image+voice to video (``:2034-2163, 3030-3037``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("id_lora")
    prompt = copy.deepcopy(prompt)
    id_prompt = str(p.get("id_lora_prompt",
                          p.get("i2v_prompt", p.get("prompt", "")))
                    or "").strip()
    if not id_prompt:
        raise ValueError("ID-LoRA prompt is empty.")

    raw_image = str(p.first("source_image_path", "image_path",
                            "first_frame_path", "approved_image_path",
                            default="") or "").strip().strip('"')
    if raw_image:
        image_path = os.path.abspath(raw_image)
        if not os.path.isfile(image_path):
            raise FileNotFoundError(
                f"ID-LoRA image input was not found: {image_path}")
    else:
        name = prepare_load_image(
            "", p.get("source_image_data", "") or p.get("image_data", ""),
            p.get("source_image_name", "") or p.get("image_name",
                                                    "id_lora_image.png"),
            base)
        if not name:
            raise ValueError("ID-LoRA needs an image input.")
        image_path = os.path.join(input_dir(base), name)

    raw_audio = str(p.first("id_reference_audio_path", "reference_audio_path",
                            "voice_reference_audio_path", "voice_sample_path",
                            "audio_path", default="") or "").strip().strip('"')
    if not raw_audio:
        raise ValueError("ID-LoRA needs a reference voice audio sample.")
    reference_audio_path = os.path.abspath(raw_audio)
    if not os.path.isfile(reference_audio_path):
        raise FileNotFoundError(
            f"ID-LoRA reference voice audio was not found: "
            f"{reference_audio_path}")

    project_folder = p.path("project_folder", "Project folder", kind="any")
    output_folder = scene_output_folder(project_folder, "id_lora_i2v_clips",
                                        p)
    fps = p.int_("fps", 24, 1, 120)
    width = p.int_("width", 1920, 64, 4096)
    seed_mode = p.text("seed_mode", "fixed").lower() or "fixed"
    pass1_seed = p.int_("pass1_seed", p.int_("seed", 1, 0, _SEED_MAX),
                        0, _SEED_MAX)
    pass2_seed = p.int_("pass2_seed", p.int_("seed_2", 42, 0, _SEED_MAX),
                        0, _SEED_MAX)
    if seed_mode in {"random", "randomize"}:
        pass1_seed = random.randint(0, _SEED_MAX)
        pass2_seed = random.randint(0, _SEED_MAX)

    patch_ltx_video_model_loader(prompt, p)
    set_optional_input(prompt, "969", "unet_name",
                       clean_i2v_unet_name(p.get("unet_name", "")))
    set_optional_input(prompt, "971", "model_name",
                       str(p.get("diffusion_model_name")
                           or p.get("model_name") or ""))
    apply_rows(prompt, [
        ("966", "vae_name", p.text("audio_vae_name")),
        ("967", "vae_name", p.text("vae_name")),
        ("968", "clip_name1", p.text("clip_name1")),
        ("968", "clip_name2", p.text("clip_name2")),
        ("951", "model_name", p.text("upscale_model_name")),
        ("957", "value", id_prompt),
        ("963", "image", image_path),
        ("963", "custom_width", 0),
        ("963", "custom_height", 0),
        ("964", "audio_file", reference_audio_path),
        ("964", "seek_seconds",
         p.float_("reference_audio_seek_seconds", 0.0, 0.0, 36000.0)),
        ("964", "duration",
         p.float_("reference_audio_duration", 0.0, 0.0, 36000.0)),
        ("937", "value", width),
        ("949", "value", p.int_("height", 1080, 64, 4096)),
        ("945", "value", p.float_("duration", 5.0, 0.25, 120.0)),
        ("946", "value", fps),
        ("939", "longer_edge", width),
        ("954", "identity_guidance_scale",
         p.float_("identity_guidance_scale", 3.0, 0.0, 20.0)),
        ("954", "start_percent", 0.0),
        ("954", "end_percent", 1.0),
        ("924", "sampler_name",
         p.text("pass1_sampler_name") or "euler_ancestral"),
        ("929", "sigmas", normalize_sigma_text(p.get("pass1_sigmas"),
                                               _DEFAULT_PASS1_SIGMAS)),
        ("915", "noise_seed", pass1_seed),
        ("936", "strength", p.float_("pass1_inplace_strength", 0.7, 0.0, 1.0)),
        ("936", "bypass", p.bool_("pass1_inplace_bypass", False)),
        ("917", "sampler_name",
         p.text("pass2_sampler_name") or "euler_ancestral"),
        ("918", "sigmas", normalize_sigma_text(p.get("pass2_sigmas"),
                                               _DEFAULT_PASS2_SIGMAS)),
        ("914", "noise_seed", pass2_seed),
        ("923", "strength", p.float_("pass2_inplace_strength", 1.0, 0.0, 1.0)),
        ("923", "bypass", p.bool_("pass2_inplace_bypass", False)),
    ])

    use_user = p.bool_("use_custom_loras", False)
    user_count = p.int_("lora_count", 0, 0, MAX_LORA_SLOTS - 1)
    apply_rows(prompt, [
        ("972", "use_custom_loras", True),
        ("972", "lora_count", 1 + (user_count if use_user else 0)),
    ])
    apply_rows(prompt, _lora_slot_rows(
        "972", p, catalog, mode="reserved_first",
        reserved=(catalog.clean_required_id_lora(
            p.get("id_lora_name") or p.get("required_id_lora_name")),
            p.float_("id_lora_first_pass_strength", 1.0),
            p.float_("id_lora_second_pass_strength", 1.0)),
        user_count=user_count, use_user=use_user))
    apply_rows(prompt, [
        ("958", "filename_prefix", os.path.join(output_folder, "id_lora_i2v")),
        ("958", "frame_rate", fps),
        ("958", "crf", p.int_("crf", 19, 0, 51)),
    ])
    return {"workflow_path": workflow_path, "output_folder": output_folder,
            "prompt": prompt}


_FLF_GUIDE_DEFAULTS = (("958", "first", (0, 0.7, 29, 1, 0.9)),
                       ("959", "last", (-1, 0.7, 29, 1, 1.0)))
_FLF_INTERPOLATIONS = {"lanczos", "bislerp", "nearest", "bilinear", "bicubic",
                       "area", "nearest-exact"}


def build_flf_prompt(payload, catalog=None, base=None) -> dict:
    """First/last-frame guided video (``:2926-3027``).  The returned
    ``flf_inputs`` echo is the reference's verification payload."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    workflow_path, prompt = load_api_template("flf")
    prompt = copy.deepcopy(prompt)
    video_prompt = p.text("i2v_prompt")
    if not video_prompt:
        raise ValueError("First Last Frame prompt is empty.")
    audio_path = p.path("audio_path", "Audio file")
    srt_path = p.path("srt_path", "SRT file")
    project_folder = p.path("project_folder", "Project folder", kind="any")
    first = (p.get("first_frame")
             if isinstance(p.get("first_frame"), dict) else {})
    last = p.get("last_frame") if isinstance(p.get("last_frame"), dict) else {}
    first_name = prepare_optional_image(first, base)
    last_name = prepare_optional_image(last, base)
    if first_name == "(none)":
        raise ValueError("First Last Frame needs a first-frame image.")
    if last_name == "(none)":
        raise ValueError("First Last Frame needs a last-frame image.")
    if os.path.normcase(first_name) == os.path.normcase(last_name):
        raise ValueError(
            f"First Last Frame resolved both inputs to the same image: "
            f"{first_name}")
    output_folder = scene_output_folder(project_folder,
                                        "first_last_frame_clips", p)
    fps = p.int_("fps", 24, 1, 120)

    patch_ltx_video_model_loader(prompt, p)
    apply_rows(prompt, _ltx_shared_model_rows(p))
    apply_rows(prompt, _ltx_frame_rows(
        p, fps, p.int_("seed", 69, 0, _SEED_MAX),
        width=p.int_("width", 1920, 64, 4096),
        height=p.int_("height", 1080, 64, 4096)))

    # FLF is single-pass but reuses the shared two-pass loader's
    # first-pass output — patch it too, or UI-enabled LoRAs silently
    # apply none (reference comment :2956-2959)
    use_loras = p.bool_("use_custom_loras", False)
    lora_count = (p.int_("lora_count", 0, 0, MAX_LORA_SLOTS)
                  if use_loras else 0)
    apply_rows(prompt, [("937", "use_custom_loras", use_loras),
                        ("937", "lora_count", lora_count)])
    for slot in range(1, MAX_LORA_SLOTS + 1):
        name = (catalog.clean_lora(p.get(f"lora_{slot}", NONE_LORA))
                if slot <= lora_count else NONE_LORA)
        apply_rows(prompt, [
            ("937", f"lora_{slot}", name),
            ("937", f"first_pass_strength_{slot}",
             p.float_(f"first_pass_strength_{slot}",
                      p.float_(f"strength_{slot}", 1.0))),
            ("937", f"second_pass_strength_{slot}", 0.0),
        ])

    apply_rows(prompt, [("950", "image", first_name),
                        ("945", "image", last_name)])
    for node_id, prefix, defaults in _FLF_GUIDE_DEFAULTS:
        frame_idx, strength, crf, blur_radius, attention = defaults
        interpolation = str(p.get(f"{prefix}_guide_interpolation")
                            or "lanczos")
        if interpolation not in _FLF_INTERPOLATIONS:
            interpolation = "lanczos"
        crop = str(p.get(f"{prefix}_guide_crop") or "center")
        if crop not in {"center", "disabled"}:
            crop = "center"
        apply_rows(prompt, [
            (node_id, "frame_idx",
             p.int_(f"{prefix}_guide_frame_idx", frame_idx, -9999, 9999)),
            (node_id, "strength",
             p.float_(f"{prefix}_guide_strength", strength, 0.0, 1.0)),
            (node_id, "crf", p.int_(f"{prefix}_guide_crf", crf, 0, 51)),
            (node_id, "blur_radius",
             p.int_(f"{prefix}_guide_blur_radius", blur_radius, 0, 7)),
            (node_id, "interpolation", interpolation),
            (node_id, "crop", crop),
            (node_id, "attention_strength",
             p.float_(f"{prefix}_attention_strength", attention, 0.0, 1.0)),
        ])
    apply_rows(prompt, [
        ("927", "audio_file", audio_path),
        ("927", "seek_seconds", 0),
        ("927", "duration", 0),
        ("930", "value", p.int_("prompt_number_one_based", 1, 1, 999999)),
        ("933", "text", video_prompt),
        ("935", "value", srt_path),
        ("218:287", "overwrite_mode", "overwrite"),
        ("218:287", "tail_loss_frames",
         p.int_("tail_loss_frames", 25, 0, 10000)),
        ("218:287", "pre_frames", p.int_("pre_frames", 0, 0, 10000)),
        ("437", "value", output_folder),
    ])
    apply_rows(prompt, _sampler_override_rows(p, passes=1))

    inputs_937 = prompt.get("937", {}).get("inputs", {})
    count = int(inputs_937.get("lora_count", 0) or 0)
    flf_inputs = {
        "first_node": "950",
        "last_node": "945",
        "first_load_image": first_name,
        "last_load_image": last_name,
        "first_source": str(first.get("path") or first.get("name")
                            or "embedded image data"),
        "last_source": str(last.get("path") or last.get("name")
                           or "embedded image data"),
        "inputs_are_different":
            os.path.normcase(first_name) != os.path.normcase(last_name),
        "lora_node": "937",
        "loras_enabled": bool(inputs_937.get("use_custom_loras", False)),
        "lora_count": count,
        "loras": [{"name": str(inputs_937.get(f"lora_{slot}", NONE_LORA)),
                   "strength": float(inputs_937.get(
                       f"first_pass_strength_{slot}", 1.0) or 0.0)}
                  for slot in range(1, count + 1)],
    }
    return {"workflow_path": workflow_path, "output_folder": output_folder,
            "prompt": prompt, "flf_inputs": flf_inputs}


def build_clear_memory_prompt() -> dict:
    """The unpatched ClearMemory template (``:3078-3083``)."""
    workflow_path, prompt = load_api_template("clear_memory")
    return {"workflow_path": workflow_path, "prompt": prompt}


def build_transcribe_prompt(payload, catalog=None, base=None) -> dict:
    """Whisper SRT-guided transcription prompt (``:3086-3121``)."""
    p = Payload(payload)
    workflow_path, prompt = load_api_template("transcribe")
    prompt = copy.deepcopy(prompt)
    audio_path = p.path("audio_path", "Audio file")
    srt_path = p.path("srt_path", "SRT file")
    extractor = node_id_by_class(
        prompt, "VRGDG_ManualLyricsExtractor_SRT_Advanced", "960")
    stems = node_id_by_class(prompt, "VRGDG_GetStems", "28:114")
    apply_rows(prompt, [
        (stems, "audio_file_path", audio_path),
        (extractor, "srt_path", srt_path),
        (extractor, "reference_lyrics",
         str(p.get("reference_lyrics", "") or "")),
        (extractor, "language", str(p.get("language", "") or "english")),
        (extractor, "strict_reference_text",
         bool(p.get("strict_reference_text", True))),
        (extractor, "fill_aggressiveness",
         p.int_("fill_aggressiveness", 1, 0, 3)),
        (extractor, "preserve_nonvocal_segments",
         bool(p.get("preserve_nonvocal_segments", True))),
        (extractor, "alignment_min_words",
         p.int_("alignment_min_words", 1, 1, 10)),
    ])
    model_name = str(p.get("model_name", "") or "large-v3").strip()
    if model_name:
        set_input(prompt, extractor, "model_name", model_name)
    return {"workflow_path": workflow_path, "prompt": prompt}


_TT_SEGMENT_MODES = {"whisper_chunks", "reference_lines",
                     "exact_reference_lines", "reference_stanzas",
                     "reference_scene_words"}


def build_timestamped_transcribe_prompt(payload, catalog=None,
                                        base=None) -> dict:
    """Timestamped-lyrics transcription prompt (``:3124-3159``)."""
    p = Payload(payload)
    workflow_path, prompt = load_api_template("timestamped_transcribe")
    prompt = copy.deepcopy(prompt)
    audio_path = p.path("audio_path", "Audio file")
    extractor = node_id_by_class(prompt, "VRGDG_TimestampedLyricsExtractor",
                                 "962")
    stems = node_id_by_class(prompt, "VRGDG_GetStems", "28:114")
    segment_mode = str(p.get("segment_mode", "") or "reference_lines").strip()
    if segment_mode not in _TT_SEGMENT_MODES:
        segment_mode = "reference_lines"
    apply_rows(prompt, [
        (stems, "audio_file_path", audio_path),
        (extractor, "reference_lyrics",
         str(p.get("reference_lyrics", "") or "")),
        (extractor, "language", str(p.get("language", "") or "english")),
        (extractor, "segment_mode", segment_mode),
        (extractor, "include_instrumental_gaps",
         p.bool_("include_instrumental_gaps", True)),
        (extractor, "instrumental_text",
         str(p.get("instrumental_text", "") or "[instrumental]")),
        (extractor, "min_gap_seconds",
         p.float_("min_gap_seconds", 1.0, 0.0, 30.0)),
        (extractor, "min_scene_seconds",
         p.float_("min_scene_seconds", 1.0, 1.0, 30.0)),
        (extractor, "max_scene_seconds",
         p.float_("max_scene_seconds", 8.0, 1.0, 60.0)),
        (extractor, "vocal_tail_padding_seconds",
         p.float_("vocal_tail_padding_seconds", 0.6, 0.0, 3.0)),
    ])
    model_name = str(p.get("model_name", "") or "large-v3").strip()
    if model_name:
        set_input(prompt, extractor, "model_name", model_name)
    return {"workflow_path": workflow_path, "prompt": prompt}


# --------------------------------------------------------------------------
# MiniMax H3 (audio-driven video) — collections, timing, sub-patches
# (reference :525-611, :638-749, :2463-2874)
# --------------------------------------------------------------------------

MINIMAX_H3_ASPECT_RATIOS = {
    "1:1 (Square)", "2:3 (Portrait Photo)", "3:2 (Photo)",
    "3:4 (Portrait Standard)", "4:3 (Standard)",
    "9:16 (Portrait Widescreen)", "16:9 (Widescreen)", "21:9 (Ultrawide)",
}
_MINIMAX_MAX_IMAGES = 9
_MINIMAX_MAX_VIDEOS = 3
_MINIMAX_SAGE_MODES = {
    "disabled", "auto", "sageattn_qk_int8_pv_fp16_cuda",
    "sageattn_qk_int8_pv_fp16_triton", "sageattn_qk_int8_pv_fp8_cuda",
    "sageattn_qk_int8_pv_fp8_cuda++", "sageattn3",
    "sageattn3_per_block_mean",
}


def _h3_collection(value, collection_keys=()) -> list:
    """Loose list coercion: list / keyed dict / JSON text / line list
    (``:525-544``)."""
    if isinstance(value, list):
        return value
    if isinstance(value, dict):
        nested = next((value[key] for key in collection_keys
                       if isinstance(value.get(key), list)), None)
        return list(value.values()) if nested is None else nested
    text = str(value or "").strip()
    if text:
        try:
            parsed = json.loads(text)
        except ValueError:
            parsed = None
        # recurse into container/string parses only: strings strictly
        # shrink (quote peel) so they terminate, but a numeric parse
        # round-trips json.loads as a NEW equal object, so the
        # reference's identity check recurses forever on floats/ints
        # (live-reproduced; its flaw at :536-540)
        if isinstance(parsed, (list, dict, str)) and parsed != value:
            return _h3_collection(parsed, collection_keys)
        return [line.strip() for line in text.splitlines() if line.strip()]
    return []


def _h3_media_path(value) -> str:
    if isinstance(value, dict):
        value = (value.get("path") or value.get("file") or value.get("image")
                 or value.get("video"))
    return str(value or "").strip().strip('"').strip("'")


def h3_image_paths(payload: Payload) -> list[str]:
    raw = payload.first("image_paths", "reference_images", "images",
                        default=[])
    paths = [path for path in (_h3_media_path(item) for item in
                               _h3_collection(raw, ("image_paths", "images")))
             if path]
    if len(paths) > _MINIMAX_MAX_IMAGES:
        raise ValueError(
            f"MiniMax H3 supports at most {_MINIMAX_MAX_IMAGES} reference "
            f"images; received {len(paths)}.")
    return paths


def h3_video_references(payload: Payload) -> list[dict]:
    raw = payload.first("video_references", "reference_videos", "videos",
                        default=[])
    references = []
    for item in _h3_collection(raw, ("video_references", "videos")):
        if isinstance(item, dict):
            path = _h3_media_path(item)
            entry = Payload(item)
            try:
                start_seconds = max(0.0, float(entry.first(
                    "start_seconds", "start", "seek_seconds", default=0)
                    or 0))
                duration = max(0.0, float(entry.first(
                    "duration", "duration_seconds", default=0) or 0))
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    "MiniMax H3 video reference timing must be numeric."
                ) from exc
            audio_value = entry.first("use_audio", "include_audio",
                                      "reference_audio", default=False)
            use_audio = (str(audio_value).strip().lower()
                         in {"1", "true", "yes", "on"}
                         if isinstance(audio_value, str)
                         else bool(audio_value))
        else:
            path, start_seconds, duration, use_audio = \
                _h3_media_path(item), 0.0, 0.0, False
        if path:
            references.append({"path": path, "start_seconds": start_seconds,
                               "duration": duration, "use_audio": use_audio})
    if len(references) > _MINIMAX_MAX_VIDEOS:
        raise ValueError(
            f"MiniMax H3 supports at most {_MINIMAX_MAX_VIDEOS} reference "
            f"videos; received {len(references)}.")
    return references


def probe_media_duration_seconds(path) -> float:
    """ffprobe format duration (``:614-635``)."""
    from ..runtime import video_io

    ffmpeg = video_io.find_ffmpeg()
    ffprobe = (os.path.join(os.path.dirname(ffmpeg), "ffprobe")
               if ffmpeg else "ffprobe")
    from . import scene_render

    result = scene_render._RUNNER(
        [ffprobe, "-v", "error", "-show_entries", "format=duration",
         "-of", "default=noprint_wrappers=1:nokey=1", path], check=False)
    if result.returncode != 0:
        raise RuntimeError((result.stderr or result.stdout
                            or "FFprobe could not read the audio duration."
                            ).strip())
    try:
        duration = float((result.stdout or "").strip().splitlines()[0])
    except (IndexError, TypeError, ValueError) as exc:
        raise RuntimeError(
            f"FFprobe did not return a valid duration for: {path}") from exc
    if duration <= 0:
        raise ValueError(f"Source audio has no usable duration: {path}")
    return duration


def trim_h3_audio_context(source_path, project_folder, scene_number,
                          timing) -> dict:
    """Trim the scene's audio context window to 44.1k stereo PCM and
    verify the duration landed (``:638-680``)."""
    from ..runtime import video_io

    target_dir = os.path.join(project_folder, "minimax_h3_scene_audio")
    os.makedirs(target_dir, exist_ok=True)
    target = os.path.join(target_dir, f"scene_audio_{scene_number:04d}.wav")
    ffmpeg = video_io.find_ffmpeg() or "ffmpeg"
    from . import scene_render

    result = scene_render._RUNNER(
        [ffmpeg, "-y", "-ss", f"{timing["audio_trim_start_seconds"]:.9f}",
         "-i", source_path, "-t", f"{timing["audio_trim_duration_seconds"]:.9f}",
         "-vn", "-ac", "2", "-ar", "44100", "-c:a", "pcm_s16le", target],
        check=False)
    if result.returncode != 0 or not os.path.isfile(target):
        raise RuntimeError(
            (result.stderr or result.stdout
             or "FFmpeg failed to trim MiniMax H3 scene audio.").strip())
    try:
        with wave.open(target, "rb") as handle:
            actual = handle.getnframes() / float(handle.getframerate())
    except Exception as exc:
        raise RuntimeError(
            f"Could not verify the trimmed MiniMax H3 audio: {target}"
        ) from exc
    if actual + 0.02 < timing["audio_trim_duration_seconds"]:
        raise ValueError(
            "The trimmed MiniMax H3 audio ended before the required scene "
            f"context. Needed {timing["audio_trim_duration_seconds"]:.3f}s; "
            f"received {actual:.3f}s.")
    return {"audio_path": target, "start": timing["audio_trim_start_seconds"],
            "duration": actual,
            "requested_duration": timing["audio_trim_duration_seconds"],
            "format": "pcm_s16le_wav"}


def prepare_scene_audio_clip(payload, base=None) -> dict:
    """Standalone scene-audio trim route body (``:683-728``)."""
    from ..runtime import video_io

    p = Payload(payload)
    source = p.path("audio_path", "Audio file")
    project_text = str(p.get("project_folder", "") or "").strip().strip('"')
    if not project_text:
        raise ValueError("Create or load a project before preparing scene "
                         "audio.")
    project_folder = os.path.abspath(project_text)
    os.makedirs(project_folder, exist_ok=True)
    scene_number = int(p.float_("scene_number", 1, 1, 9999))
    start = p.float_("start_seconds", 0.0, 0.0, 24 * 60 * 60)
    duration = p.float_("duration_seconds", 8.0, 0.05, 120.0)
    target_dir = os.path.join(project_folder, "minimax_h3_scene_audio")
    os.makedirs(target_dir, exist_ok=True)
    target = os.path.join(target_dir, f"scene_audio_{scene_number:04d}.wav")
    ffmpeg = video_io.find_ffmpeg() or "ffmpeg"
    # through scene_render's injectable runner seam so the fake-runner
    # command-plan fuzz can exercise this route too (no ffmpeg in CI)
    from . import scene_render

    result = scene_render._RUNNER(
        [ffmpeg, "-y", "-ss", f"{start:.9f}", "-i", source,
         "-t", f"{duration:.9f}", "-vn", "-ac", "2", "-ar", "44100",
         "-c:a", "pcm_s16le", target], check=False)
    if result.returncode != 0 or not os.path.isfile(target):
        raise RuntimeError((result.stderr or result.stdout
                            or "FFmpeg failed to prepare scene audio.")
                           .strip())
    return {"audio_path": target, "start": start,
            "duration": probe_media_duration_seconds(target),
            "requested_duration": duration, "format": "pcm_s16le_wav"}


def h3_output_location(project_folder, scene_number) -> tuple[str, str]:
    """Scene output folder + filename prefix under the output root
    (``:731-749``; ``folder_paths.get_output_directory`` becomes the
    framework's output root)."""
    project_name = re.sub(
        r"[^A-Za-z0-9_-]+", "_",
        os.path.basename(os.path.normpath(project_folder))).strip("_") \
        or "project"
    project_key = hashlib.sha1(
        os.path.normcase(project_folder).encode("utf-8")).hexdigest()[:8]
    relative = os.path.join("VRGDG_MiniMaxH3",
                            f"{project_name}_{project_key}",
                            f"scene_{scene_number:04d}")
    output_folder = os.path.join(DEFAULT_OUTPUT_ROOT, relative)
    os.makedirs(output_folder, exist_ok=True)
    prefix = os.path.join(
        relative, f"MiniMaxH3_scene_{scene_number:04d}").replace("\\", "/")
    return output_folder, prefix


def _patch_h3_advanced(prompt, p: Payload) -> dict:
    """Sampler/scheduler/EasyCache/attention settings (``:2475-2523``)."""
    sampler_id = node_id_by_class(prompt, "KSamplerSelect", fallback="123")
    scheduler_id = node_id_by_class(prompt, "BasicScheduler", fallback="124")
    loader_id = node_id_by_class(prompt, "DiffusionModelLoaderKJ",
                                 fallback="141")
    cache_id = optional_node_id_by_class(prompt, "EasyCache",
                                         fallback_ids=("174",))
    settings = {
        "sampler_name": p.text("sampler_name") or "res_multistep",
        "scheduler": p.text("scheduler") or "simple",
        "steps": p.int_("steps", 20, 1, 1000),
        "denoise": p.float_("denoise", 1.0, 0.0, 1.0),
        "easy_cache_bypass": p.bool_("easy_cache_bypass", False),
        "easy_cache_reuse_threshold":
            p.float_("easy_cache_reuse_threshold", 0.3, 0.0, 1.0),
        "easy_cache_start_percent":
            p.float_("easy_cache_start_percent", 0.2, 0.0, 1.0),
        "easy_cache_end_percent":
            p.float_("easy_cache_end_percent", 0.9, 0.0, 1.0),
        "easy_cache_verbose": p.bool_("easy_cache_verbose", False),
        "sage_attention": p.text("sage_attention") or "auto",
        "enable_fp16_accumulation": p.bool_("enable_fp16_accumulation", True),
    }
    if settings["sage_attention"] not in _MINIMAX_SAGE_MODES:
        settings["sage_attention"] = "auto"
    apply_rows(prompt, [
        (sampler_id, "sampler_name", settings["sampler_name"]),
        (scheduler_id, "scheduler", settings["scheduler"]),
        (scheduler_id, "steps", settings["steps"]),
        (scheduler_id, "denoise", settings["denoise"]),
        (loader_id, "sage_attention", settings["sage_attention"]),
        (loader_id, "enable_fp16_accumulation",
         settings["enable_fp16_accumulation"]),
    ])
    if cache_id:
        apply_rows(prompt, [
            (cache_id, "reuse_threshold",
             settings["easy_cache_reuse_threshold"]),
            (cache_id, "start_percent", settings["easy_cache_start_percent"]),
            (cache_id, "end_percent", settings["easy_cache_end_percent"]),
            (cache_id, "verbose", settings["easy_cache_verbose"]),
        ])
        if settings["easy_cache_bypass"]:
            replace_input_refs(prompt, (cache_id, 0), (loader_id, 0))
            prompt.pop(cache_id, None)
    return settings


def _patch_h3_turbo(prompt, p: Payload, catalog: ModelCatalog) -> dict:
    """Turbo-LoRA rewiring (``:2526-2610``).  Standalone note: the
    reference refuses unless the Turbo custom nodes are registered in
    the live ComfyUI process; the standalone builder targets an external
    executor, so that liveness check is the executor's job."""
    if not p.bool_("use_turbo_lora", False):
        return {"enabled": False, "lora_name": "", "strength": 0.0,
                "scheduler": "", "steps": 0}
    lora_name = (p.text("turbo_lora_name")
                 or "minimax_h3_turbo_4step_ema_ckpt850.safetensors")
    if not catalog.exists("loras", lora_name):
        raise ValueError(
            f"MiniMax-H3 Turbo LoRA '{lora_name}' was not found in "
            "ComfyUI/models/loras. Download the LoRA, refresh/restart "
            "ComfyUI, and select it in MiniMax Video Settings.")
    strength = p.float_("turbo_lora_strength", 1.0, -10.0, 10.0)
    turbo_steps = p.int_("steps", 4, 1, 1000)

    scheduler_id = node_id_by_class(prompt, "BasicScheduler", fallback="124")
    guider_id = node_id_by_class(prompt, "BasicGuider", fallback="126")
    sampler_adv_id = node_id_by_class(prompt, "SamplerCustomAdvanced",
                                      fallback="125")
    stock_sampler_id = optional_node_id_by_class(prompt, "KSamplerSelect",
                                                 fallback_ids=("123",))
    model_ref = prompt.get(scheduler_id, {}).get("inputs", {}).get("model")
    if not isinstance(model_ref, list) or len(model_ref) != 2:
        raise ValueError(
            "MiniMax-H3 Turbo could not find the current model connection "
            "feeding BasicScheduler.")

    lora_id = "9001"
    while lora_id in prompt:
        lora_id = str(int(lora_id) + 1)
    sampler_id = str(int(lora_id) + 1)
    while sampler_id in prompt:
        sampler_id = str(int(sampler_id) + 1)
    prompt[lora_id] = {"class_type": "VRGDG_MiniMaxH3TurboLoRACompat",
                       "inputs": {"model": list(model_ref),
                                  "lora_name": lora_name,
                                  "strength": strength}}
    prompt[sampler_id] = {"class_type": "MiniMaxH3TurboSampler", "inputs": {}}
    apply_rows(prompt, [
        (scheduler_id, "model", [lora_id, 0]),
        (scheduler_id, "scheduler", "simple"),
        (scheduler_id, "steps", turbo_steps),
        (guider_id, "model", [lora_id, 0]),
        (sampler_adv_id, "sampler", [sampler_id, 0]),
    ])
    if stock_sampler_id:
        prompt.pop(stock_sampler_id, None)
    return {"enabled": True, "lora_name": lora_name, "strength": strength,
            "scheduler": "simple", "steps": turbo_steps,
            "lora_node": "VRGDG_MiniMaxH3TurboLoRACompat",
            "sampler_node": "MiniMaxH3TurboSampler"}


def _patch_h3_loras(prompt, p: Payload, catalog: ModelCatalog) -> dict:
    """Chained LoraLoaderModelOnly insertion (``:2613-2697``)."""
    enabled = p.bool_("use_loras", False) or p.bool_("use_custom_loras",
                                                     False)
    if not enabled:
        return {"enabled": False, "count": 0, "loras": []}
    if p.bool_("use_turbo_lora", False):
        raise ValueError(
            "MiniMax normal LoRAs and MiniMax-H3 Turbo LoRA cannot be "
            "enabled at the same time.")
    raw = p.get("loras")
    configured = []
    if isinstance(raw, list):
        for item in raw:
            if not isinstance(item, dict):
                continue
            configured.append({
                "name": catalog.clean_lora(item.get("name")
                                           or item.get("lora_name")
                                           or item.get("loraName")
                                           or NONE_LORA),
                "strength": Payload(item).float_("strength", 1.0, -10.0,
                                                 10.0),
            })
    count = p.int_("lora_count", len(configured), 0, 4)
    if not configured:
        for slot in range(1, count + 1):
            configured.append({
                "name": catalog.clean_lora(p.get(f"lora_{slot}", NONE_LORA)),
                "strength": p.float_(f"lora_{slot}_strength", 1.0, -10.0,
                                     10.0),
            })
    configured = [item for item in configured[:count]
                  if item["name"] and item["name"] != NONE_LORA]
    if not configured:
        return {"enabled": False, "count": 0, "loras": []}
    for item in configured:
        if not catalog.exists("loras", item["name"]):
            raise ValueError(
                f"MiniMax LoRA '{item['name']}' was not found in "
                "ComfyUI/models/loras. Download the LoRA, refresh/restart "
                "ComfyUI, and select it in MiniMax Video Settings.")

    scheduler_id = node_id_by_class(prompt, "BasicScheduler", fallback="124")
    guider_id = node_id_by_class(prompt, "BasicGuider", fallback="126")
    model_ref = prompt.get(scheduler_id, {}).get("inputs", {}).get("model")
    if not isinstance(model_ref, list) or len(model_ref) != 2:
        raise ValueError(
            "MiniMax LoRA patch could not find the current model connection "
            "feeding BasicScheduler.")
    next_id = 9101
    current = list(model_ref)
    applied = []
    for index, item in enumerate(configured, start=1):
        while str(next_id) in prompt:
            next_id += 1
        node_id = str(next_id)
        next_id += 1
        prompt[node_id] = {
            "class_type": "LoraLoaderModelOnly",
            "inputs": {"model": list(current), "lora_name": item["name"],
                       "strength_model": item["strength"]},
            "_meta": {"title": f"MiniMax LoRA {index}"},
        }
        current = [node_id, 0]
        applied.append({"name": item["name"], "strength": item["strength"],
                        "node": node_id})
    set_input(prompt, scheduler_id, "model", list(current))
    set_input(prompt, guider_id, "model", list(current))
    return {"enabled": True, "count": len(applied), "loras": applied}


def build_minimax_h3_prompt(payload, catalog=None, base=None) -> dict:
    """MiniMax H3 audio-driven scene builder (``:2700-2874``)."""
    catalog = catalog or default_catalog()
    p = Payload(payload)
    raw_mode = (str(p.get("audio_mode") or p.get("audioMode")
                    or "input_audio").strip().lower()
                .replace("-", "_").replace(" ", "_"))
    audio_mode = ("built_in_audio"
                  if raw_mode in {"built_in_audio", "native_audio",
                                  "generated_audio"} else "input_audio")
    template_key = ("minimax_h3_built_in_audio"
                    if audio_mode == "built_in_audio" else "minimax_h3")
    workflow_path, prompt = load_api_template(template_key)
    prompt = copy.deepcopy(prompt)

    video_prompt = str(p.first("prompt", "video_prompt", "i2v_prompt",
                               "t2v_prompt", default="") or "").strip()
    if not video_prompt:
        raise ValueError("MiniMax H3 video prompt is empty.")
    audio_path = ""
    if audio_mode == "input_audio":
        audio_text = str(p.first("audio_path", "source_audio_path",
                                 default="") or "").strip().strip('"')
        if not audio_text:
            raise ValueError("MiniMax H3 source audio path is empty.")
        audio_path = os.path.abspath(audio_text)
        if not os.path.isfile(audio_path):
            raise FileNotFoundError(
                f"MiniMax H3 source audio was not found: {audio_path}")
    project_text = str(p.get("project_folder", "") or "").strip().strip('"')
    if not project_text:
        raise ValueError("Project folder is empty.")
    project_folder = os.path.abspath(project_text)
    if not os.path.isdir(project_folder):
        raise FileNotFoundError(
            f"Project folder was not found: {project_folder}")
    scene_number = p.int_("scene_number", 1, 1, 999999)

    timeline_start = p.first("timeline_start_seconds", "scene_start_seconds",
                             "start", default=0)
    timeline_end = p.first("timeline_end_seconds", "scene_end_seconds",
                           "end", default=None)
    if timeline_end is None:
        scene_duration = p.first("scene_duration_seconds", "scene_duration",
                                 "duration", default=None)
        if scene_duration is None:
            raise ValueError(
                "MiniMax H3 needs timeline_end_seconds or "
                "scene_duration_seconds.")
        try:
            timeline_end = float(timeline_start) + float(scene_duration)
        except (TypeError, ValueError) as exc:
            raise ValueError(
                "MiniMax H3 timeline timing must be numeric.") from exc
    source_duration = p.first("source_duration_seconds",
                              "audio_duration_seconds", default=None)
    if source_duration is None and audio_mode == "input_audio":
        source_duration = probe_media_duration_seconds(audio_path)
    timing = calculate_minimax_h3_timing(
        timeline_start, timeline_end,
        p.first("warmup_frames", "pre_frames", default=0),
        p.first("cooldown_frames", "tail_loss_frames", default=0),
        source_start_seconds=p.first("source_start_seconds",
                                     "audio_start_seconds", default=None),
        source_duration_seconds=source_duration)
    prepared_audio = None
    if audio_mode == "input_audio":
        prepared_audio = trim_h3_audio_context(audio_path, project_folder,
                                               scene_number, timing)

    image_paths = h3_image_paths(p)
    video_references = h3_video_references(p)
    aspect_ratio = p.text("aspect_ratio") or "16:9 (Widescreen)"
    if aspect_ratio not in MINIMAX_H3_ASPECT_RATIOS:
        raise ValueError(
            f"Unsupported MiniMax H3 aspect ratio: {aspect_ratio}")
    diffusion_model = (p.text("diffusion_model_name")
                       or "minimax_h3_ref2va_pruned_int8_convrot.safetensors")
    clip_name = (p.text("clip_name")
                 or "qwen3vl_32b_minimax_h3_nvfp4_awq.safetensors")
    video_vae = (p.text("video_vae_name")
                 or "minimax_h3_video_vae_fp16.safetensors")
    audio_vae = (p.text("audio_vae_name")
                 or "minimax_h3_audio_vae_fp32.safetensors")
    if diffusion_model.lower().endswith(".gguf"):
        raise ValueError("MiniMax H3 GGUF loading is not enabled yet. "
                         "Choose a non-GGUF diffusion model.")
    catalog.require(("diffusion_models", "unet"), diffusion_model,
                    "MiniMax H3 diffusion model")
    catalog.require(("text_encoders", "clip"), clip_name,
                    "MiniMax H3 text encoder")
    catalog.require("vae", video_vae, "MiniMax H3 video VAE")
    catalog.require("vae", audio_vae, "MiniMax H3 audio VAE")

    try:
        seed = int(p.get("seed", 69))
    except (TypeError, ValueError):
        seed = 69
    if seed < 0:
        seed = random.randrange(0, _SEED_MAX + 1)
    seed = min(seed, _SEED_MAX)

    output_folder, filename_prefix = h3_output_location(project_folder,
                                                        scene_number)
    apply_rows(prompt, [
        ("132", "value", timing["workflow_duration_input_seconds"]),
        ("138", "value", video_prompt),
        ("129", "noise_seed", seed),
        ("115", "aspect_ratio", aspect_ratio),
        ("115", "megapixels", p.float_("megapixels", 0.9, 0.1, 16.0)),
        ("115", "multiple", 32),
        ("141", "model_name", diffusion_model),
        ("128", "clip_name", clip_name),
        ("119", "vae_name", video_vae),
        ("120", "vae_name", audio_vae),
    ])
    if audio_mode == "input_audio":
        apply_rows(prompt, [("171", "audio_file",
                             prepared_audio["audio_path"]),
                            ("171", "seek_seconds", 0),
                            ("171", "duration", 0)])
    apply_rows(prompt, [
        ("180", "image_paths", json.dumps(image_paths, ensure_ascii=False)),
        ("180", "video_references",
         json.dumps(video_references, ensure_ascii=False)),
        ("142", "frame_rate", 24),
        ("142", "filename_prefix", filename_prefix),
        # keep every aligned frame: trim_to_audio muxes with -shortest
        # while stream-copying H.264, which can drop the final packets
        # before the exact scene trimmer sees them (reference :2833-2836)
        ("142", "trim_to_audio", False),
    ])
    advanced = _patch_h3_advanced(prompt, p)
    lora_settings = _patch_h3_loras(prompt, p, catalog)
    turbo = _patch_h3_turbo(prompt, p, catalog)
    if turbo["enabled"]:
        advanced = {**advanced,
                    "effective_sampler_name": "MiniMaxH3TurboSampler",
                    "effective_scheduler": "simple",
                    "effective_steps": turbo["steps"]}
    return {
        "workflow_path": workflow_path,
        "output_folder": output_folder,
        "prompt": prompt,
        "used_seed": seed,
        "audio_mode": audio_mode,
        "timing": dict(timing),
        "prepared_audio": prepared_audio,
        "post_render_trim": {"start": timing["final_trim_start_seconds"],
                             "duration": timing["final_trim_duration_seconds"]},
        "reference_inputs": {
            "image_count": len(image_paths),
            "video_count": len(video_references),
            "video_audio_count": sum(1 for item in video_references
                                     if item.get("use_audio")),
        },
        "model_settings": {"diffusion_model_name": diffusion_model,
                           "clip_name": clip_name,
                           "video_vae_name": video_vae,
                           "audio_vae_name": audio_vae},
        "advanced_settings": advanced,
        "lora_settings": lora_settings,
        "turbo_settings": turbo,
    }


# --------------------------------------------------------------------------
# choices surface (lora_list / i2v_choices / model_root routes)
# --------------------------------------------------------------------------

def lora_list(catalog=None) -> dict:
    catalog = catalog or default_catalog()
    return {"loras": catalog.lora_choices()}


def i2v_choices(catalog=None) -> dict:
    """Model dropdown payload (``:4292-4303``)."""
    catalog = catalog or default_catalog()
    gguf, diffusion = catalog.video_model_choices()
    return {"unets": catalog.names(("unet", "diffusion_models")),
            "video_gguf_unets": gguf,
            "video_diffusion_models": diffusion,
            "vae": catalog.names("vae"),
            "clip": catalog.names(("clip", "text_encoders")),
            "upscale_models": catalog.names("upscale_models")}


# builder dispatch used by the HTTP routes and the CLI
BUILDERS = {
    "zimage": build_zimage_prompt,
    "krea2": build_krea2_prompt,
    "krea2_2pass": build_krea2_2pass_prompt,
    "ernie_image": build_ernie_image_prompt,
    "flux_klein": build_flux_klein_prompt,
    "nb_image": build_nb_image_prompt,
    "z_upscale_enhance": build_z_upscale_enhance_prompt,
    "i2v": build_i2v_prompt,
    "t2v": build_t2v_prompt,
    "rtv": build_rtv_prompt,
    "ingredients": build_ingredients_prompt,
    "id_lora": build_id_lora_prompt,
    "flf": build_flf_prompt,
    "minimax_h3": build_minimax_h3_prompt,
    "transcribe": build_transcribe_prompt,
    "timestamped_transcribe": build_timestamped_transcribe_prompt,
}
