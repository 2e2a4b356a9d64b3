"""Start-image storyboard store (per-scene start/end frame manager).

A copy of :mod:`vrgdg_tpu.api.start_storyboard` (which cannot be imported
without JAX): every function keeps its original's source.

Framework-native re-derivation of
``VRGDG_StartImageStoryboard.py``: a board living
inside a Video Builder project (``start_image_storyboard/``) that maps
one start (and optional end) frame plus notes/prompts to every lyric
scene, with attempt archiving, reference images, and location mappings
pulled from the builder session.

Parity targets:
- project/board/image paths + URLs: ``:17-54``,
- builder-session location mapping import: ``:64-172``,
- lyric-source discovery + scene normalization: ``:176-233``,
- board load (with first-run import) / save: ``:236-294``,
- current-builder-start-frame resolution + import: ``:297-431``,
- newest-download import: ``:433-458`` (generalized: explicit
  ``source_path`` or newest image in a watch folder — the reference
  resolves this via its Browser-AI download watcher, which is
  browser-automation scope),
- reference upload ``:460-488``, scene-frame upload ``:490-520``,
- image GET containment roots: ``:628-642``.
"""

from __future__ import annotations

import base64
import os
import re
import shutil
import time
from urllib.parse import quote

from .builder import ProjectLayout, _clean, _read_json, _write_json

BOARD_DIRNAME = "start_image_storyboard"
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp")

# per-scene fields the editor owns and a reimport must preserve (:565-568)
SCENE_KEEP_KEYS = ("note", "preset", "end_transition_preset",
                   "end_frame_note", "prompt", "image_path",
                   "end_image_path", "reference_path", "location_area")


def _s(value) -> str:
    """Plain content strip — `_clean` (which also strips quotes) is for
    filesystem paths only; names/descriptions may end in quotes."""
    return str(value or "").strip()


def project_folder(value) -> str:
    """An existing Video Builder project (``:17-23``)."""
    folder = os.path.abspath(_clean(value))
    if not folder or not os.path.isdir(folder):
        raise ValueError(
            "Choose an existing Video Builder project folder.")
    if not os.path.isfile(ProjectLayout(folder).session_path):
        raise ValueError(
            "That folder is not a Video Builder project. Choose a "
            "folder containing vrgdg_builder_session.json.")
    return folder


def board_folder(folder) -> str:
    return os.path.join(folder, BOARD_DIRNAME)


def board_path(folder) -> str:
    return os.path.join(board_folder(folder), "storyboard.json")


def images_folder(folder) -> str:
    return os.path.join(board_folder(folder), "images")


def _abs_image_path(folder, path) -> str:
    value = _clean(path)
    if not value:
        return ""
    if os.path.isabs(value):
        return os.path.abspath(value)
    return os.path.abspath(os.path.join(folder, value))


def image_url(folder, path) -> str:
    path = _abs_image_path(folder, path)
    if not path:
        return ""
    stamp = (int(os.path.getmtime(path)) if os.path.isfile(path)
             else int(time.time()))
    return ("/vrgdg/start_storyboard/image?project_folder="
            f"{quote(folder)}&path={quote(path)}&v={stamp}")


# ------------------------------------------------------------------
# builder-session location mapping
# ------------------------------------------------------------------

def _nested_lookup(data, keys, list_result=False):
    """First dict (or list) found under ``keys``, searching one level of
    session/state/project nesting (``:66-78``, ``:192-204``)."""
    if not isinstance(data, dict):
        return [] if list_result else {}
    for key in keys:
        value = data.get(key)
        if isinstance(value, list if list_result else dict):
            return value
    for key in ("session", "state", "project"):
        found = _nested_lookup(data.get(key), keys, list_result)
        if found:
            return found
    return [] if list_result else {}


def _reference_builder(session) -> dict:
    return _nested_lookup(session, ("flux_reference_builder",
                                    "fluxReferenceBuilder",
                                    "reference_builder",
                                    "referenceBuilder"))


def segment_list(data) -> list:
    if isinstance(data, list):
        return data
    found = _nested_lookup(data, ("segments", "scenes",
                                  "lyric_segments",
                                  "timelineSegments",
                                  "timeline_segments"),
                           list_result=True)
    if found:
        return found
    # the Prompt Creator writes lyric_segments.json as a flat
    # {segmentN: text} mapping (prompt_creator.save_outputs); accept it
    # as an ordered lyric list — the reference's _segment_list cannot
    # read its own sibling's output here (:192-204 returns []), which
    # breaks first-board import on imported projects
    if isinstance(data, dict):
        from .prompt_creator import canonical_segments

        return list(canonical_segments(data).values())
    return []


def _reference_image(item) -> dict:
    source = item if isinstance(item, dict) else {}
    image = (source.get("image")
             if isinstance(source.get("image"), dict) else source)
    return {
        "path": _s(image.get("path") or source.get("image_path")
                   or source.get("imagePath") or source.get("path")),
        "data": _s(image.get("data") or source.get("image_data")
                   or source.get("imageData") or source.get("data")),
        "name": _s(image.get("name") or source.get("image_name")
                   or source.get("imageName")),
    }


def _mapped_location_id(scene_map, candidates) -> str:
    if not isinstance(scene_map, dict):
        return ""
    for candidate in candidates:
        key = _s(candidate)
        if not key or key not in scene_map:
            continue
        value = scene_map.get(key)
        if isinstance(value, dict):
            value = (value.get("location_id") or value.get("locationId")
                     or value.get("location") or value.get("id"))
        value = _s(value)
        if value:
            return value
    return ""


def apply_location_mappings(folder, board) -> dict:
    """Attach the builder's mapped location reference to each scene
    (``:104-172``)."""
    session = _read_json(ProjectLayout(folder).session_path, {})
    refs = _reference_builder(session)
    locations = (refs.get("locations")
                 if isinstance(refs.get("locations"), list) else [])
    scene_map = refs.get("scene_map") or refs.get("sceneMap") or {}
    cleared = bool(refs.get("locations_cleared")
                   or refs.get("locationsCleared"))
    by_id = {_s(item.get("id")): item for item in locations
             if isinstance(item, dict) and _s(item.get("id"))}
    by_name = {_s(item.get("name") or item.get("label")).lower():
               item for item in locations
               if isinstance(item, dict)
               and _s(item.get("name") or item.get("label"))}
    session_scenes = segment_list(session)
    imported = 0

    for index, scene in enumerate(board.get("scenes") or []):
        if not isinstance(scene, dict):
            continue
        prior = scene.get("location_ref")
        prior_source = (_s(prior.get("source"))
                        if isinstance(prior, dict) else "")
        if cleared:
            if prior_source in ("video_builder", ""):
                scene.pop("location_ref", None)
            continue
        session_scene = (session_scenes[index]
                         if index < len(session_scenes)
                         and isinstance(session_scenes[index], dict)
                         else {})
        scene_id = _s(session_scene.get("id")
                      or scene.get("project_scene_id")
                      or scene.get("id"))
        if scene_id:
            scene["project_scene_id"] = scene_id
        number = index + 1
        location_id = _mapped_location_id(scene_map, [
            scene.get("id"), scene.get("project_scene_id"),
            session_scene.get("id"), number, f"scene{number}",
            f"scene_{number}", f"scene_{number:04d}"])
        if not location_id:
            direct = (session_scene.get("location_ref")
                      or session_scene.get("locationRef"))
            if isinstance(direct, dict):
                location_id = _s(direct.get("id")
                                 or direct.get("name"))
            else:
                location_id = _s(
                    session_scene.get("mapped_location")
                    or session_scene.get("location_id"))
        location = by_id.get(location_id) \
            or by_name.get(location_id.lower())
        if not location:
            if prior_source == "video_builder":
                scene.pop("location_ref", None)
            continue
        image = _reference_image(location)
        image["path"] = _abs_image_path(folder, image.get("path"))
        scene["location_ref"] = {
            "id": _s(location.get("id") or location_id),
            "name": _s(location.get("name") or location.get("label")
                       or "Mapped location"),
            "description": _s(location.get("description")
                              or location.get("prompt")),
            "image": image,
            "source": "video_builder",
        }
        imported += 1

    board["project_location_catalog"] = [
        {"id": _s(item.get("id")),
         "name": _s(item.get("name") or item.get("label")
                    or "Mapped location"),
         "description": _s(item.get("description")
                           or item.get("prompt")),
         "image": _reference_image(item)}
        for item in locations if isinstance(item, dict)]
    board["imported_location_count"] = imported
    return board


# ------------------------------------------------------------------
# board load / save
# ------------------------------------------------------------------

def find_lyric_source(folder) -> str:
    """First lyric/scene source a builder project carries (``:176-188``)."""
    for path in (
            os.path.join(folder, "prompts", "lyric_segments.json"),
            os.path.join(folder, "lyric_segments.json"),
            os.path.join(folder, "project_context",
                         "lyric_segments.json"),
            ProjectLayout(folder).session_path,
            os.path.join(folder, "session.json"),
            os.path.join(folder, "music_video_builder_session.json")):
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        "No lyric_segments.json or Video Builder session was found in "
        "this project.")


def normalize_scenes(items) -> list[dict]:
    """Lyric segments (dicts or raw strings) -> empty board scene cards
    (``:207-233``)."""
    scenes = []
    for item in items:
        if isinstance(item, str):
            lyric, item = item.strip(), {}
        elif isinstance(item, dict):
            lyric = _s(item.get("lyric_text") or item.get("lyrics")
                       or item.get("text") or item.get("line"))
        else:
            continue
        if not lyric and str(item.get("type") or "").lower() \
                in {"overlay", "marker"}:
            continue
        number = len(scenes) + 1
        scenes.append({
            "id": str(item.get("id") or f"scene_{number:04d}"),
            "number": number, "lyric": lyric, "note": "",
            "preset": "", "end_transition_preset": "",
            "end_frame_note": "", "prompt": "", "image_path": "",
            "end_image_path": "", "location_area": ""})
    return scenes


def save_board(folder, board) -> dict:
    """Persist the board, stripping derived URLs and renumbering
    (``:269-291``)."""
    os.makedirs(images_folder(folder), exist_ok=True)
    clean = dict(board or {})
    clean.update(version=2, project_folder=folder,
                 updated_at=int(time.time()))
    scenes = []
    for index, source in enumerate(clean.get("scenes") or [], start=1):
        scene = dict(source or {})
        for derived in ("image_url", "end_image_url", "reference_url",
                        "location_image_url"):
            scene.pop(derived, None)
        scene["number"] = index
        scene["id"] = str(scene.get("id") or f"scene_{index:04d}")
        scenes.append(scene)
    clean["scenes"] = scenes
    _write_json(board_path(folder), clean)
    return clean


def load_board(folder, import_if_missing: bool = True) -> dict:
    """Saved board, or a fresh one imported from the project's lyric
    scenes; derived image URLs are attached (``:236-267``)."""
    path = board_path(folder)
    created = False
    board = _read_json(path)
    if not isinstance(board, dict):
        if import_if_missing:
            source = find_lyric_source(folder)
            board = {"version": 1, "project_folder": folder,
                     "global_idea": "",
                     "scenes": normalize_scenes(
                         segment_list(_read_json(source, {}))),
                     "lyric_source": source}
            if not board["scenes"]:
                raise ValueError(
                    f"No lyric scenes were found in {source}.")
            created = True
        else:
            board = {"version": 1, "project_folder": folder,
                     "global_idea": "", "scenes": []}
    apply_location_mappings(folder, board)
    if created:
        save_board(folder, board)
    for scene in board.get("scenes", []):
        scene["image_url"] = image_url(folder,
                                       scene.get("image_path", ""))
        scene["end_image_url"] = image_url(
            folder, scene.get("end_image_path", ""))
        scene["reference_url"] = image_url(
            folder, scene.get("reference_path", ""))
        location = (scene.get("location_ref")
                    if isinstance(scene.get("location_ref"), dict)
                    else {})
        loc_image = (location.get("image")
                     if isinstance(location.get("image"), dict) else {})
        data = _clean(loc_image.get("data"))
        scene["location_image_url"] = (
            data if data.startswith("data:image/")
            else image_url(folder, loc_image.get("path", "")))
    board["global_reference_url"] = image_url(
        folder, board.get("global_reference_path", ""))
    return board


def reimport_board(folder) -> dict:
    """Re-pull lyric scenes while keeping the user's per-scene edits
    (``:551-571``)."""
    source = find_lyric_source(folder)
    old = load_board(folder, import_if_missing=False)
    imported = normalize_scenes(segment_list(_read_json(source, {})))
    for index, scene in enumerate(imported):
        if index < len(old.get("scenes", [])):
            previous = old["scenes"][index]
            for key in SCENE_KEEP_KEYS:
                scene[key] = previous.get(key, scene.get(key, ""))
    old["scenes"] = imported
    old["lyric_source"] = source
    apply_location_mappings(folder, old)
    save_board(folder, old)
    return load_board(folder)


# ------------------------------------------------------------------
# frame imports / uploads
# ------------------------------------------------------------------

def _frame_field(frame) -> str:
    return ("end_image_path"
            if _clean(frame).lower() == "end" else "image_path")


def _frame_stem(scene_number, frame) -> str:
    suffix = "_end" if _frame_field(frame) == "end_image_path" else ""
    return f"scene_{int(scene_number):04d}{suffix}"


def _archive_existing(images, stem) -> None:
    """Move every prior take of a frame into ``attempts/<stem>``."""
    attempts = os.path.join(images, "attempts", stem)
    os.makedirs(attempts, exist_ok=True)
    stamp = int(time.time() * 1000)
    index = 0
    for name in os.listdir(images):
        existing = os.path.join(images, name)
        if not os.path.isfile(existing) \
                or not name.startswith(f"{stem}."):
            continue
        index += 1
        archive = os.path.join(
            attempts,
            f"attempt_{stamp}_{index:02d}{os.path.splitext(name)[1]}")
        shutil.copy2(existing, archive)
        os.remove(existing)


def _decode_image_data_url(data_url) -> tuple[bytes, str]:
    match = re.match(r"^data:image/([A-Za-z0-9.+-]+);base64,(.+)$",
                     str(data_url or ""), flags=re.S)
    if not match:
        raise ValueError("Upload did not contain valid image data.")
    subtype = match.group(1).lower()
    ext = (".jpg" if subtype in {"jpeg", "jpg"}
           else ".webp" if subtype == "webp" else ".png")
    return base64.b64decode(match.group(2)), ext


def current_builder_start_frame(folder, segment) -> dict:
    """The start image the Video Builder UI currently shows for a scene
    (``:299-331``): selected history entry, then approved, then custom,
    then inline custom data."""
    if not isinstance(segment, dict) \
            or bool(segment.get("image_assignment_cleared")):
        return {}
    history = (segment.get("image_history")
               if isinstance(segment.get("image_history"), list)
               else [])
    history = [_clean(item) for item in history if _clean(item)]
    candidates = []
    if history:
        try:
            index = int(segment.get("image_history_index",
                                    len(history) - 1))
        except (TypeError, ValueError):
            index = len(history) - 1
        candidates.append((history[max(0, min(len(history) - 1,
                                              index))],
                           "selected image history"))
    candidates += [(segment.get("approved_image_path"),
                    "approved image"),
                   (segment.get("custom_image_path"), "custom image")]
    for raw_path, source in candidates:
        path = _abs_image_path(folder, raw_path)
        if path and os.path.isfile(path):
            return {"path": path, "source": source}
    data_url = _s(segment.get("custom_image_data"))
    if re.match(r"^data:image/[A-Za-z0-9.+-]+;base64,", data_url,
                flags=re.I):
        return {"data": data_url,
                "name": _s(segment.get("custom_image_name"))
                or "custom_image.png",
                "source": "custom image data"}
    return {}


def _store_frame_bytes(folder, scene_number, frame, data: bytes,
                       ext: str) -> str:
    images = images_folder(folder)
    os.makedirs(images, exist_ok=True)
    stem = _frame_stem(scene_number, frame)
    target = os.path.join(images, f"{stem}{ext}")
    _archive_existing(images, stem)
    with open(target, "wb") as handle:
        handle.write(data)
    return target


def _store_frame_file(folder, scene_number, frame, source_path) -> str:
    images = images_folder(folder)
    os.makedirs(images, exist_ok=True)
    stem = _frame_stem(scene_number, frame)
    ext = os.path.splitext(source_path)[1].lower() or ".png"
    if ext not in IMAGE_EXTENSIONS:
        ext = ".png"
    target = os.path.join(images, f"{stem}{ext}")
    _archive_existing(images, stem)
    shutil.copy2(source_path, target)
    return target


def import_project_start_frames(folder, overwrite: bool = False) -> dict:
    """Pull every scene's current Video Builder start image into the
    board (``:399-431``)."""
    board = load_board(folder)
    session = _read_json(ProjectLayout(folder).session_path, {})
    project_scenes = segment_list(session)
    by_id = {_clean(scene.get("id")): scene for scene in project_scenes
             if isinstance(scene, dict) and _clean(scene.get("id"))}
    imported = skipped = missing = 0
    failures = []
    for index, scene in enumerate(board.get("scenes") or []):
        if not isinstance(scene, dict):
            continue
        existing = _abs_image_path(folder, scene.get("image_path"))
        if existing and os.path.isfile(existing) and not overwrite:
            skipped += 1
            continue
        scene_id = _clean(scene.get("project_scene_id")
                          or scene.get("id"))
        project_scene = by_id.get(scene_id)
        if not isinstance(project_scene, dict):
            project_scene = (project_scenes[index]
                             if index < len(project_scenes)
                             and isinstance(project_scenes[index],
                                            dict) else {})
        source = current_builder_start_frame(folder, project_scene)
        if not source:
            missing += 1
            continue
        try:
            if source.get("path"):
                scene["image_path"] = _store_frame_file(
                    folder, index + 1, "start", source["path"])
            else:
                data, ext = _decode_image_data_url(source.get("data"))
                scene["image_path"] = _store_frame_bytes(
                    folder, index + 1, "start", data, ext)
            imported += 1
        except Exception as exc:  # noqa: BLE001 — per-scene report
            failures.append({"scene_number": index + 1,
                             "error": str(exc)})
    if imported:
        board["last_project_frame_import_at"] = int(time.time())
        save_board(folder, board)
    return {"storyboard": load_board(folder), "imported": imported,
            "skipped_existing": skipped, "missing": missing,
            "failed": len(failures), "failures": failures}


def newest_download(downloads_folder=None) -> str:
    """Newest image in the watch folder — the framework stand-in for
    the reference's per-provider Browser-AI download watcher."""
    folder = _clean(downloads_folder) \
        or os.environ.get("VRGDG_TPU_DOWNLOADS") \
        or os.path.join(os.path.expanduser("~"), "Downloads")
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"Downloads folder was not found: {folder}")
    found = [os.path.join(folder, name) for name in os.listdir(folder)
             if name.lower().endswith(IMAGE_EXTENSIONS)
             and os.path.isfile(os.path.join(folder, name))]
    if not found:
        raise FileNotFoundError(
            f"No downloaded images were found in: {folder}")
    return max(found, key=os.path.getmtime)


def import_latest(folder, scene_number, frame="start",
                  source_path="", downloads_folder=None) -> dict:
    """Attach the newest downloaded image (or an explicit file) to a
    scene frame, archiving the prior take (``:433-458``)."""
    source = _clean(source_path) or newest_download(downloads_folder)
    if not os.path.isfile(source):
        raise FileNotFoundError(f"Image was not found: {source}")
    scene_number = int(scene_number)
    board = load_board(folder)
    if not 1 <= scene_number <= len(board.get("scenes", [])):
        raise ValueError("Scene number is outside this storyboard.")
    target = _store_frame_file(folder, scene_number, frame, source)
    board["scenes"][scene_number - 1][_frame_field(frame)] = target
    save_board(folder, board)
    return {"saved_path": target,
            "image_url": image_url(folder, target),
            "source_path": source}


def save_reference(folder, data_url, scene_number=None) -> dict:
    """Global character reference or a per-scene reference image
    (``:460-488``)."""
    data, ext = _decode_image_data_url(data_url)
    refs = os.path.join(board_folder(folder), "references")
    os.makedirs(refs, exist_ok=True)
    target_name = ("global_character_reference" if not scene_number
                   else f"scene_{int(scene_number):04d}_reference")
    target = os.path.join(refs, target_name + ext)
    stale = [entry.path for entry in os.scandir(refs)
             if entry.name.startswith(target_name + ".") and entry.is_file()]
    for old in stale:
        os.remove(old)
    with open(target, "wb") as handle:
        handle.write(data)
    board = load_board(folder)
    if scene_number:
        number = int(scene_number)
        if not 1 <= number <= len(board.get("scenes", [])):
            raise ValueError("Scene number is outside this storyboard.")
        board["scenes"][number - 1]["reference_path"] = target
    else:
        board["global_reference_path"] = target
        board["use_global_reference"] = True
    save_board(folder, board)
    return {"saved_path": target,
            "image_url": image_url(folder, target)}


def save_scene_upload(folder, data_url, scene_number,
                      frame="start") -> dict:
    """Dropped/uploaded image -> the scene's start or end frame
    (``:490-520``)."""
    data, ext = _decode_image_data_url(data_url)
    scene_number = int(scene_number)
    board = load_board(folder)
    if not 1 <= scene_number <= len(board.get("scenes", [])):
        raise ValueError("Scene number is outside this storyboard.")
    target = _store_frame_bytes(folder, scene_number, frame, data, ext)
    board["scenes"][scene_number - 1][_frame_field(frame)] = target
    save_board(folder, board)
    return {"saved_path": target,
            "image_url": image_url(folder, target)}


def image_roots(folder) -> tuple[str, ...]:
    """Roots the image GET route may serve from (``:632-637``)."""
    return (os.path.abspath(folder),
            os.path.abspath(images_folder(folder)),
            os.path.abspath(os.path.join(board_folder(folder),
                                         "references")))
