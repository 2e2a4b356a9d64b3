"""LoRA dataset file store: image/caption pair CRUD.

A copy of :mod:`vrgdg_tpu.api.lora_dataset` (which cannot be imported
without JAX): every function keeps its original's source.

The non-LLM slice of the reference's LoRA Dataset Creator backend
(``VRGDG_LoraDatasetCreatorNodes.py:174-338``): a
dataset project layout (``dataset/`` + ``project_files/``), the
``save_pair`` image+caption writer with its ``dataset.json`` manifest,
and the ``save_ic_pair`` reference/target instruction-pair writer with
its list-shaped metadata file. The LLM captioning/identity routes and
the desktop folder pickers stay out of scope (SURVEY.md section 2.5).

Differences from the reference, by design:
- image sources are plain file paths or base64/data-URL payloads (this
  framework has no ComfyUI image dicts); images are normalized to PNG
  via cv2 rather than PIL,
- everything else — folder layout, file naming, manifest/metadata
  schemas, replace-by-index semantics, trailing-newline captions — is
  behavior-parity, locked by the oracle fuzz in
  ``tests/test_reference_parity.py``.
"""

from __future__ import annotations

import json
import os
from datetime import datetime, timezone

import cv2

from .builder import _clean, save_data_url_image


def safe_dataset_folder(path) -> str:
    """Expanded absolute dataset root, created on demand (``:174-180``)."""
    raw = _clean(path)
    if not raw:
        raise ValueError("Choose a dataset folder.")
    root = os.path.abspath(os.path.expandvars(os.path.expanduser(raw)))
    os.makedirs(root, exist_ok=True)
    return root


def project_folders(path) -> tuple[str, str, str]:
    """``(root, dataset/, project_files/)``, all created (``:183-189``)."""
    root = safe_dataset_folder(path)
    folders = tuple(os.path.join(root, name)
                    for name in ("dataset", "project_files"))
    for folder in folders:
        os.makedirs(folder, exist_ok=True)
    return (root,) + folders


def _write_image_as_png(source, target_path: str) -> str:
    """Copy an image source (path / {"path": ...} / data URL) to
    ``target_path`` as PNG."""
    if isinstance(source, dict):
        source = source.get("path") or source.get("data") or ""
    text = str(source or "")
    if text.lower().startswith("data:") or (len(text) > 512
                                            and not os.path.isfile(text)):
        return save_data_url_image(text, target_path)
    image = cv2.imread(text, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise ValueError(f"Image source could not be read: {text[:120]}")
    if not cv2.imwrite(target_path, image):
        raise ValueError(f"Could not write image: {target_path}")
    return target_path


def _write_text_line(path: str, text: str) -> None:
    with open(path, "w", encoding="utf-8", newline="\n") as handle:
        handle.write(text + "\n")


def _read_json_or(path: str, fallback, kinds=None):
    """JSON at ``path`` when it parses as an accepted container type
    (``kinds``, default: the fallback's own type), else ``fallback``."""
    if os.path.isfile(path):
        try:
            with open(path, "r", encoding="utf-8") as handle:
                loaded = json.load(handle)
            if isinstance(loaded, kinds or type(fallback)):
                return loaded
        except Exception:
            pass
    return fallback


def _item_index(item, default: int) -> int:
    """A manifest item's integer index, tolerating hand-edited or corrupt
    entries (null / non-numeric values fall back)."""
    try:
        return int(item.get("index", default))
    except (TypeError, ValueError):
        return default


def _dump_json(path: str, value) -> None:
    with open(path, "w", encoding="utf-8", newline="\n") as handle:
        json.dump(value, handle, indent=2, ensure_ascii=False)


def save_pair(payload) -> dict:
    """Save one numbered image+caption pair and update the project
    manifest (``_save_pair``, ``:262-297``): images land in ``dataset/``
    as ``image_NNN.png`` with a sibling ``.txt`` caption; the manifest's
    ``items`` list replaces any record with the same index and stays
    index-sorted."""
    root, dataset_folder, project_files = project_folders(
        payload.get("dataset_folder"))
    index = max(1, int(payload.get("index") or 1))
    stem = f"image_{index:03d}"
    image_path = os.path.join(dataset_folder, stem + ".png")
    caption_path = os.path.join(dataset_folder, stem + ".txt")
    _write_image_as_png(payload.get("image"), image_path)
    _write_text_line(caption_path, str(payload.get("caption") or "").strip())

    manifest_path = os.path.join(project_files, "dataset.json")
    manifest = _read_json_or(manifest_path, {})
    # dataset-level fields the reference stamps on every save (:244-250)
    for field, default in (("art_style", ""), ("trigger_word", ""),
                           ("trigger_phrase", ""), ("generator", "zimage")):
        manifest[field] = payload.get(field, default)
    manifest["updated_at"] = datetime.now(timezone.utc).isoformat()
    items = manifest.setdefault("items", [])
    items[:] = [item for item in items
                if _item_index(item, -1) != index]
    items.append({
        "index": index,
        "concept": payload.get("concept", ""),
        "prompt": payload.get("prompt", ""),
        "caption": payload.get("caption", ""),
        "image": f"../dataset/{stem}.png",
        "text": f"../dataset/{stem}.txt",
        "seed": payload.get("seed"),
    })
    items.sort(key=lambda item: _item_index(item, 0))
    _dump_json(manifest_path, manifest)
    return {"project_root": root, "dataset_folder": dataset_folder,
            "project_files_folder": project_files,
            "image_path": image_path, "caption_path": caption_path,
            "manifest_path": manifest_path}


def save_ic_pair(payload) -> dict:
    """Save one IC-LoRA reference/target pair with its instruction
    (``_save_ic_pair``, ``:300-338``): ``dataset/references/pair_NNN.png``
    + ``dataset/targets/pair_NNN.{png,txt}``; the metadata list replaces
    any record with the same target path."""
    root, dataset_folder, project_files = project_folders(
        payload.get("dataset_folder"))
    reference_dir = os.path.join(dataset_folder, "references")
    target_dir = os.path.join(dataset_folder, "targets")
    for folder in (reference_dir, target_dir):
        os.makedirs(folder, exist_ok=True)
    index = max(1, int(payload.get("index") or 1))
    stem = f"pair_{index:03d}"
    reference_path = os.path.join(reference_dir, stem + ".png")
    target_path = os.path.join(target_dir, stem + ".png")
    instruction_path = os.path.join(target_dir, stem + ".txt")
    _write_image_as_png(payload.get("reference"), reference_path)
    _write_image_as_png(payload.get("target"), target_path)
    instruction = " ".join(str(payload.get("instruction") or "").split())
    _write_text_line(instruction_path, instruction)

    metadata_path = os.path.join(project_files, "dataset.json")
    records = _read_json_or(metadata_path, [])
    record = {
        "caption": instruction,
        "video": f"../dataset/targets/{stem}.png",
        "reference_video": f"../dataset/references/{stem}.png",
        "experimental_one_frame_ic_lora": True,
    }
    records = [item for item in records
               if item.get("video") != record["video"]]
    records.append(record)
    _dump_json(metadata_path, records)
    return {"project_root": root, "dataset_folder": dataset_folder,
            "project_files_folder": project_files,
            "reference_path": reference_path, "target_path": target_path,
            "instruction_path": instruction_path,
            "metadata_path": metadata_path}


def list_dataset(payload) -> dict:
    """Inventory of a dataset project: manifest (when present) plus the
    on-disk pair files. A small observability addition with no exact
    reference counterpart (the reference UI reads dataset.json only)."""
    root, dataset_folder, project_files = project_folders(
        payload.get("dataset_folder"))
    # save_pair projects hold a dict manifest, ic-pair projects a list —
    # accept either container in one read
    manifest = _read_json_or(os.path.join(project_files, "dataset.json"),
                             {}, kinds=(dict, list))
    pairs = sorted(
        name for name in os.listdir(dataset_folder)
        if name.lower().endswith((".png", ".txt")))
    return {"project_root": root, "dataset_folder": dataset_folder,
            "manifest": manifest, "files": pairs}
