"""Krea2 LoRA Studio: project/dataset store, sample tooling, run plans.

A copy of :mod:`vrgdg_tpu.api.krea2_studio` (which cannot be imported
without JAX): every function keeps its original's source, except that
:func:`sync_edit_dataset` reads each edit pair's sizes from the files'
headers with :func:`vrgdg_tpu_torch.runtime.image_io.image_size` (what
Pillow's lazy ``Image.open(path).size`` gives, and its message for a file
that holds no image) in place of Pillow, and
:func:`ai_toolkit_edit_config` reads its YAML template from the JAX
package's ``vrgdg_tpu/workflows/``, where the templates lie.

Re-derivation of the deterministic layer of the reference's Krea 2 LoRA
Studio (``LTXLoraTrain.py:1235-2430`` — the helper
closure inside ``_ensure_krea2_lora_studio_route_registered``).  The
studio manages LoRA training *projects*: a ``project.json`` + dataset
folder of images with ``.txt`` caption sidecars (or control/target
pairs for edit training), import manifests, generated samples, and an
XYZ step-comparison grid.

What stays external (SURVEY §2.5 — LoRA-training drivers and LLM
captioning are out of scope): the musubi-tuner / AI-Toolkit subprocess
runs (``:1763-1789``, ``:2232-2322``), the Gemma/LM-Studio caption
generator (``:1527-1603``), and the installer routes.  Everything those
drivers *consume or produce deterministically* is here: the resolved
run plan with the cache-strategy escalation (`train_plan`), the
AI-Toolkit edit YAML (`ai_toolkit_edit_config`), the training-progress
log parser, and the post-run project update (`record_training_result`)
so an externally-run trainer round-trips through the same store.

File layout, project.json schema, import-manifest schema, and dataset
signatures match the reference byte-for-byte (oracle-fuzzed in
``tests/test_krea2_studio.py``), so a studio folder moves between the
two unchanged.  The *default caption instruction text* does not: the
reference's is authored LLM prompt copy, so the default here is a
first-party text stating the same captioning contract (the
pc_instructions precedent) — projects carry their own instruction text
in project.json, which round-trips untouched.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
from datetime import datetime

from .paths import DEFAULT_OUTPUT_ROOT

IMAGE_EXTS = frozenset({".png", ".jpg", ".jpeg", ".webp", ".bmp",
                        ".tif", ".tiff"})  # ``:1245``
CAPTION_EXTS = frozenset({".txt", ".caption"})  # ``:1246``

# UI option surface (``:1861-1874``)
ASPECT_RATIOS = (
    "1:1 (Square)",
    "3:4 (Portrait Standard)",
    "4:3 (Landscape Standard)",
    "9:16 (Portrait)",
    "16:9 (Widescreen)",
    "2:3 (Portrait)",
    "3:2 (Landscape)",
)
DEFAULT_ASPECT_RATIO = "3:4 (Portrait Standard)"
DEFAULT_SAMPLE_PROMPT = ("portrait photo of the trained subject, "
                         "cinematic studio lighting, detailed skin "
                         "texture, clean background")
SAMPLE_MODEL_DEFAULTS = {
    "diffusion_model": "krea2_turbo_fp8_scaled.safetensors",
    "text_encoder": "qwen3vl_4b_fp8_scaled.safetensors",
    "vae": "qwen_image_vae.safetensors",
}

# first-party default (see module docstring for why this is not the
# reference's authored prompt copy, ``_default_caption_instructions``
# ``:1310-1344``)
DEFAULT_CAPTION_INSTRUCTIONS = (
    "Caption each training image in one short line of plain, "
    "comma-separated visual concepts: main subject first, then "
    "clothing/objects/pose, then setting, then any user-provided "
    "global style tags. Describe only what is visible; no lead-ins "
    "like \"photo of\", no guesses about backstory or intent, no "
    "marketing language, no camera metadata. Each caption must be "
    "suitable to save as a .txt sidecar named after its image."
)

# base settings schema (``_settings_base``, ``:1262-1290``): musubi /
# model paths default to the reference's documented install layout so
# exported projects drop into the same trainer unchanged
_SETTINGS_BASE = {
    # trainer install + model paths (the reference's documented layout)
    "musubi_root": "A:/MUSUBI/musubi-tuner-ltx2",
    "ai_toolkit_root": "A:/MUSUBI/VRGDG_AI_Toolkit",
    "ai_toolkit_model": "krea/Krea-2-Raw",
    "krea2_raw_dit": "A:/MUSUBI/models/krea2/raw.safetensors",
    "text_encoder": "A:/MUSUBI/models/qwen3vl/qwen3vl_4b_bf16.safetensors",
    "vae": "A:/MUSUBI/models/qwen_image/qwen_image_vae.safetensors",
    # network + run shape
    "network_dim": 32, "network_alpha": 32,
    "resolution_width": 1920, "resolution_height": 1080,
    "learning_rate": 0.0001, "num_repeats": 1, "blocks_to_swap": 0,
    "cache_strategy": "auto",
    # captioning + export toggles
    "create_captions": False, "caption_text": "",
    "add_trigger_word": False, "trigger_text": "",
    "copy_latest_to_comfy_loras": False,
    "clear_memory_before_text_encoder": True,
    # precision / scheduler
    "fp8_base": True, "fp8_scaled": True,
    "timestep_sampling": "shift", "discrete_flow_shift": 2.5,
    "edit_quantize": True, "edit_low_vram": False,
}

# preset deltas over the base (``_preset_settings``, ``:1292-1301``)
_PRESET_DELTAS = {
    "fast": {"steps_per_run": 250, "total_target_steps": 500,
             "learning_rate_preset": "1e-4",
             "image_guidance": "Use 10 images or fewer."},
    "medium": {"steps_per_run": 500, "total_target_steps": 1000,
               "learning_rate_preset": "7e-5",
               "image_guidance": "Up to 20 images recommended."},
    "long": {"steps_per_run": 1000, "total_target_steps": 3000,
             "learning_rate_preset": "7e-5",
             "image_guidance": "More than 20 images recommended."},
}


def _now() -> str:
    return datetime.now().isoformat(timespec="seconds")


def safe_name(value, fallback: str = "Krea2Studio") -> str:
    """``:1248-1250``."""
    text = re.sub(r"[^A-Za-z0-9_.-]+", "_",
                  str(value or "").strip()).strip("._")
    return text or fallback


def norm_path(value) -> str:
    """``:1252-1254``."""
    text = str(value or "").strip().strip('"')
    return os.path.normpath(text) if text else ""


def default_project_root(output_root=None) -> str:
    """``:1256-1260`` — ``<output>/VRGDG_Krea2_Studio``."""
    return os.path.normpath(os.path.join(
        os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT),
        "VRGDG_Krea2_Studio"))


def preset_settings(name) -> dict:
    key = str(name or "Fast").strip().lower()
    settings = dict(_SETTINGS_BASE)
    settings.update(_PRESET_DELTAS.get(key, _PRESET_DELTAS["fast"]))
    return settings


def presets() -> dict:
    return {label: preset_settings(label)
            for label in ("Fast", "Medium", "Long")}


def project_paths(project_dir) -> dict:
    """``:1346-1359`` — every folder the studio touches."""
    root = os.path.abspath(norm_path(project_dir))
    dataset = os.path.join(root, "dataset")
    return {
        "project_dir": root,
        "project_json": os.path.join(root, "project.json"),
        "import_manifest": os.path.join(root, "import_manifest.json"),
        "dataset_dir": dataset,
        "images_dir": os.path.join(dataset, "images"),
        "control_dir": os.path.join(dataset, "control"),
        "target_dir": os.path.join(dataset, "target"),
        "workspace_dir": os.path.join(root, "workspace"),
        "samples_dir": os.path.join(root, "samples"),
        "xyz_dir": os.path.join(root, "xyz"),
    }


def read_project(project_dir) -> dict:
    """``:1361-1370``."""
    paths = project_paths(project_dir)
    data = {}
    if os.path.isfile(paths["project_json"]):
        with open(paths["project_json"], "r", encoding="utf-8") as fh:
            data = json.load(fh)
    data.setdefault("project_dir", paths["project_dir"])
    data.setdefault("samples", [])
    return data


def write_project(project: dict) -> dict:
    """``:1372-1380`` — creates the full folder layout, stamps
    ``updated_at``."""
    paths = project_paths(project.get("project_dir", ""))
    for key in ("project_dir", "dataset_dir", "images_dir",
                "control_dir", "target_dir", "workspace_dir",
                "samples_dir", "xyz_dir"):
        os.makedirs(paths[key], exist_ok=True)
    project["project_dir"] = paths["project_dir"]
    project["updated_at"] = _now()
    with open(paths["project_json"], "w", encoding="utf-8") as fh:
        json.dump(project, fh, indent=2)
    return project


def _mtime(path) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0


def _read_text(path) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        return fh.read().strip()


def sync_dataset(project: dict):
    """Folder-truth dataset sync (``_sync_project_dataset_from_folder``,
    ``:1382-1495``): scan ``dataset/images`` for images + ``.txt``
    sidecars, rebuild ``imported_files``/``caption_generation``/
    ``dataset_sync`` and the import manifest, and flag
    ``pending_cache_rebuild`` when the content signature moved.
    Returns ``(project, changed)``."""
    paths = project_paths(project.get("project_dir", ""))
    os.makedirs(paths["images_dir"], exist_ok=True)

    listing = sorted(os.listdir(paths["images_dir"]),
                     key=lambda name: name.lower())
    images, captions, entries, signature_parts = [], [], [], []
    for filename in listing:
        stem, ext = os.path.splitext(filename)
        if ext.lower() not in IMAGE_EXTS:
            continue
        image_path = os.path.normpath(
            os.path.join(paths["images_dir"], filename))
        caption_path = os.path.join(paths["images_dir"], stem + ".txt")
        caption_record = None
        caption_text = ""
        if os.path.isfile(caption_path):
            caption_text = _read_text(caption_path)
            caption_record = {"name": os.path.basename(caption_path),
                              "path": os.path.normpath(caption_path),
                              "type": "caption",
                              "caption": caption_text}
            captions.append(caption_record)
        image_record = {
            "name": filename, "path": image_path, "type": "image",
            "caption_file": os.path.basename(caption_path)
            if caption_record else "",
            "caption": caption_text,
        }
        images.append(image_record)
        entries.append({"new_stem": stem, "image": image_record,
                        "caption": caption_record})
        caption_mtime = _mtime(caption_path) \
            if os.path.isfile(caption_path) else 0
        signature_parts.append(
            f"{filename}\0{_mtime(image_path):.6f}\0"
            f"{os.path.basename(caption_path)}\0{caption_mtime:.6f}\0"
            f"{caption_text}")

    signature = hashlib.sha256(
        "\n".join(signature_parts).encode("utf-8",
                                          errors="replace")).hexdigest()
    previous = project.get("dataset_sync") or {}
    changed = signature != str(previous.get("signature") or "")

    project["imported_files"] = images + captions
    project["import_manifest_path"] = os.path.normpath(
        paths["import_manifest"])
    project["caption_generation"] = {
        "updated_at": _now(),
        "created": [{"image": item["name"],
                     "caption_file": item["caption_file"],
                     "caption": item["caption"],
                     "runner": "folder_sync"}
                    for item in images if item.get("caption_file")],
        "skipped_existing": [],
        "runner": "folder_sync",
        "overwrite_existing": False,
        "cancelled": False,
    }
    project["dataset_sync"] = {
        "updated_at": _now(),
        "signature": signature,
        "image_count": len(images),
        "caption_count": len(captions),
        "source": paths["images_dir"],
        "changed": changed,
        "pending_cache_rebuild":
            bool(previous.get("pending_cache_rebuild")) or changed,
    }

    image_stems = {os.path.splitext(item["name"])[0].lower()
                   for item in images}
    orphans = [{"original_name": filename,
                "reason": "No image with the same filename stem exists "
                          "in the dataset folder."}
               for filename in listing
               if os.path.splitext(filename)[1].lower() in CAPTION_EXTS
               and os.path.splitext(filename)[0].lower()
               not in image_stems]
    manifest = {"imports": [{"created_at": _now(),
                             "source": "folder_sync_before_training",
                             "entries": entries,
                             "orphan_captions": orphans}]}
    with open(paths["import_manifest"], "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2)
    return project, changed


def sync_edit_dataset(project: dict):
    """Edit-training (control/target pair) sync (``_sync_edit_dataset``,
    ``:1662-1695``): pairs by filename stem, validates matching names
    and dimensions plus the instruction sidecar, and rebuilds the
    signature.  Returns ``(project, changed)``."""
    paths = project_paths(project.get("project_dir", ""))
    for key in ("control_dir", "target_dir"):
        os.makedirs(paths[key], exist_ok=True)

    def _by_stem(folder):
        return {os.path.splitext(name)[0].lower(): name
                for name in os.listdir(folder)
                if os.path.splitext(name)[1].lower() in IMAGE_EXTS}

    controls = _by_stem(paths["control_dir"])
    targets = _by_stem(paths["target_dir"])
    records, problems, signature_parts = [], [], []
    for stem in sorted(set(controls) | set(targets)):
        control_name = controls.get(stem)
        target_name = targets.get(stem)
        caption_path = os.path.join(paths["target_dir"], stem + ".txt")
        if not control_name:
            problems.append(f"{stem}: missing control image")
        if not target_name:
            problems.append(f"{stem}: missing target image")
        if control_name and target_name \
                and control_name.lower() != target_name.lower():
            problems.append(f"{stem}: control and target filenames/"
                            f"extensions must match exactly")
        if not os.path.isfile(caption_path):
            problems.append(f"{stem}: missing target instruction .txt")
        if not (control_name and target_name):
            continue
        control_path = os.path.join(paths["control_dir"], control_name)
        target_path = os.path.join(paths["target_dir"], target_name)
        try:
            from ..runtime.image_io import image_size
            control_size = image_size(control_path)
            target_size = image_size(target_path)
            if control_size != target_size:
                problems.append(f"{stem}: control {control_size} and "
                                f"target {target_size} dimensions differ")
        except Exception as exc:  # noqa: BLE001 — parity message
            problems.append(f"{stem}: could not validate image "
                            f"dimensions ({exc})")
        caption = _read_text(caption_path) \
            if os.path.isfile(caption_path) else ""
        records.append({"name": target_name,
                        "path": os.path.normpath(target_path),
                        "control_path": os.path.normpath(control_path),
                        "caption": caption, "type": "edit_pair",
                        "paired": bool(caption)})
        signature_parts.append(
            f"{stem}\0{os.path.getmtime(control_path)}\0"
            f"{os.path.getmtime(target_path)}\0{caption}")

    signature = hashlib.sha256(
        "\n".join(signature_parts).encode("utf-8")).hexdigest()
    changed = signature != str(
        (project.get("dataset_sync") or {}).get("signature") or "")
    project["imported_files"] = records
    project["dataset_sync"] = {
        "signature": signature,
        "pair_count": sum(1 for item in records if item["paired"]),
        "problems": problems,
        "changed": changed,
        "source": paths["dataset_dir"],
        "updated_at": _now(),
    }
    return project, changed


# ------------------------------------------------------------------
# project CRUD (handlers at ``:1941-2037``)
# ------------------------------------------------------------------

def create_project(payload: dict, output_root=None) -> dict:
    """``:1941-1972`` — create or re-open, preset settings merged under
    any explicit overrides."""
    root = norm_path(payload.get("project_root", "")) \
        or default_project_root(output_root)
    name = safe_name(payload.get("project_name", "Krea2Studio"))
    project_dir = os.path.join(root, name)
    preset_name = str(payload.get("preset_name", "Fast") or "Fast")
    settings = preset_settings(preset_name)
    settings.update(payload.get("settings") or {})
    paths = project_paths(project_dir)
    if os.path.isfile(paths["project_json"]):
        project = read_project(project_dir)
    else:
        project = {"project_dir": project_dir, "samples": [],
                   "created_at": _now()}
    project["project_name"] = name
    project["training_type"] = str(payload.get("training_type")
                                   or project.get("training_type")
                                   or "standard")
    project["preset_name"] = preset_name
    project["settings"] = settings
    for key, fallback in (
            ("sample_prompt", ""),
            ("aspect_ratio", DEFAULT_ASPECT_RATIO),
            ("caption_user_notes", "")):
        project[key] = str(payload.get(key, "")
                           or project.get(key, fallback))
    project["sample_model_settings"] = \
        payload.get("sample_model_settings") \
        or project.get("sample_model_settings", {})
    project["caption_instructions"] = str(
        payload.get("caption_instructions", "")
        or project.get("caption_instructions",
                       DEFAULT_CAPTION_INSTRUCTIONS))
    project["caption_final_instructions"] = str(
        payload.get("caption_final_instructions", "")
        or project.get("caption_final_instructions",
                       project["caption_instructions"]))
    project["caption_llm_settings"] = \
        payload.get("caption_llm_settings") \
        or project.get("caption_llm_settings", {})
    project.setdefault("samples", [])
    project = write_project(project)
    return {"project": project, "paths": project_paths(project_dir)}


def load_project(payload: dict) -> dict:
    """``:1974-1987``."""
    project_dir = norm_path(payload.get("project_dir", ""))
    if not project_dir:
        raise ValueError("project_dir is required.")
    paths = project_paths(project_dir)
    if not os.path.isfile(paths["project_json"]):
        raise FileNotFoundError(
            f"project.json was not found in: {project_dir}")
    return {"project": read_project(project_dir), "paths": paths}


def list_projects(payload: dict, output_root=None) -> dict:
    """``:1989-2017`` — newest-updated first."""
    root = norm_path(payload.get("project_root", "")) \
        or default_project_root(output_root)
    projects = []
    if os.path.isdir(root):
        for entry in os.scandir(root):
            if not entry.is_dir():
                continue
            project_json = os.path.join(entry.path, "project.json")
            if not os.path.isfile(project_json):
                continue
            try:
                with open(project_json, "r", encoding="utf-8") as fh:
                    data = json.load(fh)
            except Exception:  # noqa: BLE001 — unreadable json rows list anyway
                data = {}
            settings = data.get("settings", {}) \
                if isinstance(data.get("settings"), dict) else {}
            projects.append({
                "project_name": str(data.get("project_name")
                                    or os.path.basename(entry.path)),
                "project_dir": os.path.normpath(entry.path),
                "updated_at": str(data.get("updated_at")
                                  or data.get("created_at") or ""),
                "completed_steps": int(data.get("completed_steps") or 0),
                "total_target_steps": int(
                    data.get("total_target_steps")
                    or settings.get("total_target_steps") or 0),
            })
    projects.sort(key=lambda item: item.get("updated_at")
                  or item.get("project_name") or "", reverse=True)
    return {"project_root": root, "projects": projects}


def save_project(payload: dict) -> dict:
    """``:2019-2037`` — field updates + the training-type-appropriate
    dataset re-sync; a changed dataset forces a cache rebuild."""
    project = read_project(payload.get("project_dir", ""))
    for key in ("training_type", "preset_name", "settings",
                "sample_prompt", "aspect_ratio",
                "sample_model_settings", "custom_presets",
                "caption_instructions", "caption_user_notes",
                "caption_final_instructions", "caption_llm_settings"):
        if key in payload:
            project[key] = payload[key]
    if str(project.get("training_type") or "standard") == "edit":
        project, changed = sync_edit_dataset(project)
    else:
        project, changed = sync_dataset(project)
    if changed:
        project["dataset_sync"]["pending_cache_rebuild"] = True
        project["dataset_sync"]["cache_reason"] = \
            "Dataset images or caption sidecars changed when the " \
            "project was saved."
    return {"project": write_project(project)}


# ------------------------------------------------------------------
# dataset imports (handlers at ``:2039-2180``)
# ------------------------------------------------------------------

def import_files(project_dir, uploads) -> dict:
    """Standard-dataset import (``:2039-2152``): ``uploads`` is
    ``[(filename, bytes), ...]``.  Images renumber to ``image_NNN``;
    captions pair to images by *original* filename stem (each consumed
    once); unmatched captions are recorded as orphans in the manifest."""
    project_dir = norm_path(project_dir)
    if not project_dir:
        raise ValueError("project_dir is required.")
    paths = project_paths(project_dir)
    os.makedirs(paths["images_dir"], exist_ok=True)
    project = read_project(project_dir)

    next_index = 1
    for filename in os.listdir(paths["images_dir"]):
        match = re.match(r"image_(\d+)\.", filename, flags=re.IGNORECASE)
        if match:
            next_index = max(next_index, int(match.group(1)) + 1)

    rows = []
    for raw_name, data in uploads:
        filename = safe_name(raw_name, "file")
        ext = os.path.splitext(filename)[1].lower()
        if ext not in IMAGE_EXTS and ext not in CAPTION_EXTS:
            continue
        rows.append({"original_name": filename,
                     "original_stem":
                         os.path.splitext(filename)[0].lower(),
                     "ext": ext,
                     "type": "caption" if ext in CAPTION_EXTS
                     else "image",
                     "data": data})

    captions_by_stem = {}
    for row in rows:
        if row["type"] == "caption":
            captions_by_stem.setdefault(row["original_stem"],
                                        []).append(row)

    manifest = {"imports": []}
    if os.path.isfile(paths["import_manifest"]):
        try:
            with open(paths["import_manifest"], "r",
                      encoding="utf-8") as fh:
                manifest = json.load(fh)
            manifest.setdefault("imports", [])
        except Exception:  # noqa: BLE001 — a corrupt manifest restarts
            manifest = {"imports": []}

    def _store(data, target):
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as fh:
            fh.write(data)

    batch = {"created_at": _now(), "entries": [], "orphan_captions": []}
    saved, consumed = [], set()
    for image in (row for row in rows if row["type"] == "image"):
        new_base = f"image_{next_index:03d}"
        next_index += 1
        image_target = os.path.join(paths["images_dir"],
                                    new_base + image["ext"])
        _store(image["data"], image_target)
        image_record = {"name": os.path.basename(image_target),
                        "path": os.path.normpath(image_target),
                        "type": "image",
                        "original_name": image["original_name"]}
        saved.append(image_record)

        caption_record = None
        pool = captions_by_stem.get(image["original_stem"], [])
        while pool and id(pool[0]) in consumed:
            pool.pop(0)
        if pool:
            caption = pool.pop(0)
            consumed.add(id(caption))
            caption_target = os.path.join(paths["images_dir"],
                                          new_base + ".txt")
            _store(caption["data"], caption_target)
            caption_record = {"name": os.path.basename(caption_target),
                              "path": os.path.normpath(caption_target),
                              "type": "caption",
                              "original_name": caption["original_name"]}
            saved.append(caption_record)
        batch["entries"].append({"new_stem": new_base,
                                 "image": image_record,
                                 "caption": caption_record})

    batch["orphan_captions"] = [
        {"original_name": row["original_name"],
         "reason": "No image with the same original filename stem was "
                   "included in this import."}
        for row in rows
        if row["type"] == "caption" and id(row) not in consumed]

    manifest["imports"].append(batch)
    with open(paths["import_manifest"], "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2)

    project.setdefault("imported_files", []).extend(saved)
    project["import_manifest_path"] = os.path.normpath(
        paths["import_manifest"])
    project = write_project(project)
    return {"saved": saved, "project": project, "manifest": batch}


def import_edit_files(project_dir, role, uploads) -> dict:
    """Edit-dataset import (``:2154-2180``): files land in the
    control/target folder under their sanitized original stems; the
    project flips to edit training and re-syncs."""
    role = str(role or "").strip().lower()
    if role not in {"control", "target"}:
        raise ValueError("role must be control or target.")
    project_dir = norm_path(project_dir)
    if not project_dir:
        raise ValueError("project_dir is required.")
    paths = project_paths(project_dir)
    destination = paths[f"{role}_dir"]
    os.makedirs(destination, exist_ok=True)
    saved = []
    for raw_name, data in uploads:
        name = safe_name(raw_name, "file")
        ext = os.path.splitext(name)[1].lower()
        if ext not in IMAGE_EXTS \
                and not (role == "target" and ext in CAPTION_EXTS):
            continue
        stem = safe_name(os.path.splitext(name)[0], "image")
        target = os.path.join(
            destination,
            stem + (".txt" if ext in CAPTION_EXTS else ext))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as fh:
            fh.write(data)
        saved.append({"name": os.path.basename(target),
                      "path": os.path.normpath(target), "role": role})
    project = read_project(project_dir)
    project["training_type"] = "edit"
    project, _changed = sync_edit_dataset(project)
    project = write_project(project)
    return {"saved": saved, "project": project,
            "dataset_sync": project.get("dataset_sync")}


# ------------------------------------------------------------------
# samples, XYZ grid, sample workflow prompt (``:1604-1660, 2334-2430``)
# ------------------------------------------------------------------

def build_sample_prompt(payload: dict) -> dict:
    """Patch the vendored 2-pass sample workflow
    (``_build_sample_prompt`` handler, ``:2334-2361``): aspect ratio
    into both latent nodes, prompt text, optional model overrides, and
    the trained LoRA path/strength."""
    from .workflow_runner import load_api_template

    project = read_project(payload.get("project_dir", ""))
    lora_path = norm_path(payload.get("lora_path", "")
                          or project.get("latest_lora_path", ""))
    if not lora_path:
        raise ValueError("No LoRA path is available for sampling.")
    _path, workflow = load_api_template("krea2_lora_sample")
    import copy
    workflow = copy.deepcopy(workflow)
    aspect_ratio = str(payload.get("aspect_ratio", "")
                       or project.get("aspect_ratio", "")
                       or DEFAULT_ASPECT_RATIO)
    prompt_text = str(payload.get("sample_prompt", "")
                      or project.get("sample_prompt", "") or "")
    models = payload.get("sample_model_settings") \
        or project.get("sample_model_settings") or {}
    workflow["49"]["inputs"]["aspect_ratio"] = aspect_ratio
    workflow["238"]["inputs"]["aspect_ratio"] = aspect_ratio
    workflow["228"]["inputs"]["text"] = prompt_text
    for field, node_id, input_name in (
            ("diffusion_model", "236", "unet_name"),
            ("text_encoder", "233", "clip_name"),
            ("vae", "234", "vae_name")):
        if models.get(field):
            workflow[node_id]["inputs"][input_name] = str(
                models.get(field))
    workflow["250"]["inputs"]["lora_path"] = lora_path
    workflow["250"]["inputs"]["strength_model"] = float(
        payload.get("strength_model", 1.0) or 1.0)
    return {"prompt": workflow}


def save_sample(payload: dict, output_root=None) -> dict:
    """Record a rendered sample under ``samples/`` (``:2363-2389``).
    ``payload["image"]`` is either an absolute path or the reference's
    ``{filename, subfolder, type}`` executor result, resolved against
    the managed root (``_resolve_comfy_image_path``, ``:1610-1622``)."""
    import shutil

    project = read_project(payload.get("project_dir", ""))
    paths = project_paths(project["project_dir"])
    info = payload.get("image") or {}
    if isinstance(info, str):
        source = norm_path(info)
    else:
        filename = os.path.basename(str(info.get("filename", "") or ""))
        subfolder = str(info.get("subfolder", "") or "").strip() \
            .replace("\\", os.sep).replace("/", os.sep)
        base = os.path.abspath(output_root or DEFAULT_OUTPUT_ROOT)
        source = os.path.normpath(
            os.path.join(base, subfolder, filename)) if filename else ""
    if not source or not os.path.isfile(source):
        raise FileNotFoundError(
            f"Could not find generated sample image: {source}")
    step = int(payload.get("step",
                           project.get("completed_steps", 0)) or 0)
    stem = safe_name(project.get("project_name", "Krea2Studio"))
    ext = os.path.splitext(source)[1].lower() or ".png"
    target = os.path.join(paths["samples_dir"],
                          f"{stem}_step_{step:06d}{ext}")
    os.makedirs(paths["samples_dir"], exist_ok=True)
    shutil.copy2(source, target)
    sample = {"step": step, "path": os.path.normpath(target),
              "source": os.path.normpath(source), "created_at": _now()}
    project.setdefault("samples", []).append(sample)
    project["samples"].sort(
        key=lambda item: int(item.get("step", 0) or 0))
    project = write_project(project)
    return {"sample": sample, "project": project}


def make_xyz(samples, destination) -> str:
    """Step-labeled sample grid (``_make_xyz``, ``:1624-1660``): square
    grid of 360px letterboxed thumbnails, each with a ``Step N`` banner."""
    import cv2
    import numpy as np

    readable = []
    for sample in samples:
        path = norm_path(sample.get("path", ""))
        if os.path.isfile(path):
            image = cv2.imread(path, cv2.IMREAD_COLOR)
            if image is not None:
                readable.append((sample, image))
    if not readable:
        raise ValueError("No sample images were found for the XYZ plot.")

    thumb, label_h = 360, 42
    cols = max(1, int(math.ceil(math.sqrt(len(readable)))))
    rows = int(math.ceil(len(readable) / cols))
    grid = np.full((rows * (thumb + label_h), cols * thumb, 3),
                   (22, 24, 28), dtype=np.uint8)
    for index, (sample, image) in enumerate(readable):
        y0 = (index // cols) * (thumb + label_h)
        x0 = (index % cols) * thumb
        h, w = image.shape[:2]
        scale = min(thumb / max(1, w), thumb / max(1, h))
        resized = cv2.resize(image, (max(1, int(w * scale)),
                                     max(1, int(h * scale))),
                             interpolation=cv2.INTER_AREA)
        grid[y0:y0 + label_h, x0:x0 + thumb] = (31, 34, 42)
        cv2.putText(grid, f"Step {int(sample.get('step', 0) or 0)}",
                    (x0 + 14, y0 + 28), cv2.FONT_HERSHEY_SIMPLEX, 0.72,
                    (238, 241, 245), 2, cv2.LINE_AA)
        iy = y0 + label_h + (thumb - resized.shape[0]) // 2
        ix = x0 + (thumb - resized.shape[1]) // 2
        grid[iy:iy + resized.shape[0], ix:ix + resized.shape[1]] = resized
    os.makedirs(os.path.dirname(destination), exist_ok=True)
    if not cv2.imwrite(destination, grid):
        raise RuntimeError(f"Could not write XYZ plot: {destination}")
    return os.path.normpath(destination)


def create_xyz(payload: dict) -> dict:
    """``:2391-2403``."""
    project = read_project(payload.get("project_dir", ""))
    paths = project_paths(project["project_dir"])
    destination = os.path.join(
        paths["xyz_dir"],
        safe_name(project.get("project_name", "Krea2Studio"))
        + "_steps_xyz.png")
    xyz_path = make_xyz(project.get("samples", []), destination)
    project["xyz_plot_path"] = xyz_path
    project = write_project(project)
    return {"xyz_path": xyz_path, "project": project}


# ------------------------------------------------------------------
# training progress + run plans (the execution stays external)
# ------------------------------------------------------------------

_PROGRESS_LINE = re.compile(
    r"steps:\s*(?P<percent>\d+)%\|.*?\|\s*"
    r"(?P<current>\d+)/(?:\s*)?(?P<total>\d+)\s*"
    r"\[(?P<elapsed>[^<\]]+)<(?P<eta>[^,\]]+),\s*"
    r"(?P<seconds>[0-9.]+)s/it,\s*avr_loss=(?P<loss>[0-9.eE+-]+)\]")


def training_progress(project_dir) -> dict:
    """Parse the newest musubi tqdm log line (``:1791-1840``)."""
    paths = project_paths(project_dir)
    logs_dir = os.path.join(paths["workspace_dir"], "logs")
    if not os.path.isdir(logs_dir):
        return {"active": False, "status": "No log folder yet."}
    log_files = [entry.path for entry in os.scandir(logs_dir)
                 if entry.is_file()
                 and entry.name.lower().endswith(".log")]
    if not log_files:
        return {"active": False, "status": "No training log yet."}
    log_path = max(log_files, key=lambda path: os.path.getmtime(path))
    try:
        with open(log_path, "r", encoding="utf-8",
                  errors="replace") as fh:
            tail = fh.readlines()[-240:]
    except Exception as exc:  # noqa: BLE001 — parity message
        return {"active": False,
                "log_path": os.path.normpath(log_path),
                "status": f"Could not read log: {exc}"}
    progress = None
    for line in tail:
        match = _PROGRESS_LINE.search(line)
        if match:
            progress = {"percent": int(match.group("percent")),
                        "current": int(match.group("current")),
                        "total": int(match.group("total")),
                        "elapsed": match.group("elapsed").strip(),
                        "eta": match.group("eta").strip(),
                        "seconds_per_it": float(match.group("seconds")),
                        "avr_loss": match.group("loss"),
                        "raw": line.strip()}
    if progress:
        return {"active": True,
                "log_path": os.path.normpath(log_path), **progress}
    status = "Waiting for step progress..."
    for line in reversed(tail):
        cleaned = line.strip()
        if cleaned:
            status = cleaned[-300:]
            break
    return {"active": False, "log_path": os.path.normpath(log_path),
            "status": status}


def ai_toolkit_edit_config(project: dict, settings: dict,
                           max_steps: int,
                           require_install: bool = False) -> dict:
    """AI-Toolkit edit-training YAML (``_write_ai_toolkit_edit_config``,
    ``:1697-1761``) — the exact config the reference hands to
    ``run.py``.  Standalone, the install check is opt-in
    (``require_install``) since the trainer usually lives on another
    machine; the dataset-completeness gate is kept."""
    paths = project_paths(project["project_dir"])
    toolkit_root = os.path.abspath(
        norm_path(settings.get("ai_toolkit_root", "")))
    if require_install \
            and not os.path.isfile(os.path.join(toolkit_root, "run.py")):
        raise FileNotFoundError(
            "AI Toolkit run.py was not found. Install it, then set "
            "ai_toolkit_root.")
    sync = project.get("dataset_sync") or {}
    problems = sync.get("problems") or []
    if int(sync.get("pair_count") or 0) < 1 or problems:
        raise ValueError("Krea 2 Edit dataset is incomplete: "
                         + ("; ".join(problems[:12])
                            if problems else "no valid pairs"))
    config_dir = os.path.join(paths["workspace_dir"], "config")
    output_dir = os.path.join(paths["workspace_dir"],
                              "ai_toolkit_output")
    os.makedirs(config_dir, exist_ok=True)
    os.makedirs(output_dir, exist_ok=True)
    name = safe_name(project.get("project_name"), "Krea2Edit")

    def q(value):
        return json.dumps(
            os.path.normpath(str(value)).replace("\\", "/"))

    config_path = os.path.join(config_dir, "krea2_edit_ai_toolkit.yaml")
    # the YAML layout is the external trainer's config format, vendored
    # as a data template (workflows/krea2_edit_ai_toolkit.yaml.tmpl) the
    # same way the executor workflow JSONs are; byte parity with the
    # reference's emitted file is locked by the fuzz test
    template_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))), "vrgdg_tpu", "workflows",
        "krea2_edit_ai_toolkit.yaml.tmpl")
    with open(template_path, "r", encoding="utf-8") as fh:
        template = fh.read()
    content = template.format(
        name=json.dumps(name),
        training_folder=q(output_dir),
        network_dim=int(settings.get("network_dim", 32)),
        network_alpha=int(settings.get("network_alpha", 32)),
        save_every=int(settings.get("steps_per_run", 250)),
        target_dir=q(paths["target_dir"]),
        control_dir=q(paths["control_dir"]),
        resolution_width=int(settings.get("resolution_width", 1024)),
        resolution_height=int(settings.get("resolution_height", 1024)),
        steps=int(max_steps),
        learning_rate=float(settings.get("learning_rate", 0.0001)),
        model_name=json.dumps(str(settings.get("ai_toolkit_model")
                                  or "krea/Krea-2-Raw")),
        quantize=str(bool(settings.get("edit_quantize", True))).lower(),
        low_vram=str(bool(settings.get("edit_low_vram",
                                       False))).lower())
    with open(config_path, "w", encoding="utf-8", newline="\n") as fh:
        fh.write(content)
    return {"toolkit_root": toolkit_root, "config_path": config_path,
            "output_dir": output_dir, "name": name,
            "config_text": content,
            "command": ["<ai_toolkit_venv_python>", "run.py",
                        config_path]}


def train_plan(payload: dict) -> dict:
    """The deterministic head of the reference's ``train_chunk``
    handler (``:2232-2287``): apply payload overrides, re-sync the
    dataset, escalate the cache strategy when it changed, and return
    the resolved run plan an external musubi/AI-Toolkit run consumes
    (this framework does not execute CUDA trainers — SURVEY §2.5).
    For edit projects the plan embeds the generated AI-Toolkit YAML."""
    project = read_project(payload.get("project_dir", ""))
    for key in ("settings", "sample_prompt", "aspect_ratio"):
        if key in payload:
            project[key] = payload[key]
    edit = str(project.get("training_type") or "standard") == "edit"
    project, changed = (sync_edit_dataset if edit
                        else sync_dataset)(project)
    changed = changed or bool((project.get("dataset_sync")
                               or {}).get("pending_cache_rebuild"))
    project = write_project(project)
    settings = project.get("settings") \
        or preset_settings(project.get("preset_name", "Fast"))
    cache_strategy = str(settings.get("cache_strategy", "auto"))
    if changed:
        cache_strategy = "force"
        project["dataset_sync"]["cache_strategy_for_run"] = "force"
        project["dataset_sync"]["cache_reason"] = \
            "Dataset images or caption sidecars changed before training."
        project = write_project(project)
    paths = project_paths(project["project_dir"])
    completed = int(project.get("completed_steps") or 0)
    total = int(settings.get("total_target_steps", 500))
    next_steps = min(total,
                     completed + int(settings.get("steps_per_run", 250)))
    plan = {
        "training_type": "edit" if edit else "standard",
        "run_name": safe_name(project.get("project_name",
                                          "Krea2Studio")),
        "images_dir": paths["images_dir"],
        "workspace_dir": paths["workspace_dir"],
        "settings": settings,
        "cache_strategy_for_run": cache_strategy,
        "completed_steps": completed,
        "next_target_steps": next_steps,
        "total_target_steps": total,
    }
    if edit:
        plan["ai_toolkit"] = ai_toolkit_edit_config(project, settings,
                                                    next_steps)
    return {"project": project, "plan": plan}


def record_training_result(payload: dict) -> dict:
    """The deterministic tail of ``train_chunk`` (``:2303-2313``): an
    externally-run trainer reports its artifacts back into the store."""
    project = read_project(payload.get("project_dir", ""))
    for key in ("latest_lora_path", "latest_state_path",
                "latest_log_path", "output_name"):
        if key in payload:
            project[key] = str(payload[key] or "")
    for key in ("completed_steps", "total_target_steps"):
        if key in payload:
            project[key] = int(payload[key] or 0)
    if project.get("dataset_sync"):
        project["dataset_sync"]["pending_cache_rebuild"] = False
    return {"project": write_project(project)}


def defaults(payload: dict | None = None, output_root=None,
             catalog=None) -> dict:
    """GET ``defaults`` payload (``:1842-1881``); model choices come
    from the standalone :class:`ModelCatalog` instead of ComfyUI's
    ``folder_paths``."""
    from .workflow_runner import default_catalog

    cat = catalog or default_catalog()

    def _choices(folder):
        try:
            return [str(value) for value in cat.names(folder)]
        except Exception:  # noqa: BLE001 — missing roots list empty
            return []

    return {
        "project_root": default_project_root(output_root),
        "project_name":
            "Krea2_" + datetime.now().strftime("%Y%m%d_%H%M%S"),
        "presets": presets(),
        "aspect_ratios": list(ASPECT_RATIOS),
        "sample_prompt": DEFAULT_SAMPLE_PROMPT,
        "caption_instructions": DEFAULT_CAPTION_INSTRUCTIONS,
        "caption_user_notes": "",
        "caption_runner": "builtin",
        "lmstudio_base_url": "http://127.0.0.1:1234/v1",
        "sample_model_defaults": dict(SAMPLE_MODEL_DEFAULTS),
        "sample_model_choices": {
            "diffusion_models": _choices("diffusion_models"),
            "text_encoders": _choices("text_encoders"),
            "vae": _choices("vae"),
        },
    }
