"""Scene-video collection, trimming, stitching and slideshow rendering.

A copy of :mod:`vrgdg_tpu.api.scene_render` (which cannot be imported
without JAX): every function keeps its original's source, except that
:func:`match_scene_start_color` reads its two frames' channel statistics
with :func:`vrgdg_tpu_torch.runtime.image_io.channel_stats` (Pillow's
``ImageStat`` mean and stddev, to the bit) in place of Pillow.

The workflow runner's executor-output management routes
(``VRGDG_WorkflowRunnerNodes.py:3162-4271``): move rendered scene clips
into the project's ``rendered_scene_videos`` store, trim/color-match
them, locate fresh renders, and assemble the final video.  The pixel
work here is codec work, so (like the reference) it shells out to
ffmpeg — but every invocation goes through one injectable seam
(:func:`set_ffmpeg_runner`), which keeps the *plan* — command
construction, ordering, temp-file lifecycle, result dicts — pure and
lets ``tests/test_scene_render.py`` fuzz it against the AST-extracted
reference functions with the same fake runner on both sides (this
image ships no ffmpeg binary).

Standalone adaptations (documented per function): ComfyUI's
``folder_paths`` roots become the framework's output/ingest roots, and
thumbnails fall back to cv2 when ffmpeg is absent.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import time

from .paths import DEFAULT_OUTPUT_ROOT

_VIDEO_EXTS = {".mp4", ".mov", ".mkv", ".webm", ".avi", ".m4v"}
_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tif", ".tiff"}


# --------------------------------------------------------------------------
# the ffmpeg seam
# --------------------------------------------------------------------------

def _default_runner(cmd, *, check=False, cwd=None):
    result = subprocess.run(cmd, capture_output=True, text=True,
                            errors="replace", cwd=cwd, check=False)
    if check and result.returncode != 0:
        raise subprocess.CalledProcessError(
            result.returncode, cmd, output=result.stdout,
            stderr=result.stderr)
    return result


_RUNNER = _default_runner


def set_ffmpeg_runner(runner) -> None:
    """Replace the subprocess seam (None restores the default)."""
    global _RUNNER
    _RUNNER = runner or _default_runner


def find_ffmpeg_path() -> str:
    """The ffmpeg binary or a loud error (reference ``:3226-3235``; the
    imageio_ffmpeg fallback does not exist in this environment)."""
    from ..runtime import video_io

    path = video_io.find_ffmpeg()
    if not path:
        raise RuntimeError(
            "FFmpeg was not found: install ffmpeg to use the scene-video "
            "render routes.")
    return path


def _run(cmd, message, *, check=False, cwd=None):
    result = _RUNNER(cmd, check=check, cwd=cwd)
    if not check and (result.returncode != 0):
        raise RuntimeError(
            (result.stderr or result.stdout or message).strip())
    return result


# --------------------------------------------------------------------------
# filesystem primitives (reference :3341-3471)
# --------------------------------------------------------------------------

def _is_sharing_violation(exc: OSError) -> bool:
    """True for the lock classes the reference retries: any
    PermissionError, or the Windows sharing-violation winerror (32)."""
    return isinstance(exc, PermissionError) or (
        getattr(exc, "winerror", None) == 32)


def retry_file_op(operation, description, attempts=30, delay=0.25):
    """Retry a locked-file operation (Windows sharing violations in the
    reference; kept for parity of failure text)."""
    remaining = max(1, attempts)
    while True:
        remaining -= 1
        try:
            return operation()
        except OSError as exc:
            if not _is_sharing_violation(exc):
                raise
            if remaining <= 0:
                raise RuntimeError(
                    f"{description} failed because the file stayed "
                    f"locked: {exc}") from exc
        time.sleep(delay)


def _probe_size(path):
    """One readability probe: the byte size if the file can actually be
    opened and read, else the blocking exception."""
    try:
        with open(path, "rb") as handle:
            handle.read(1)
        return os.path.getsize(path), None
    except (OSError, PermissionError) as exc:
        return None, exc


def wait_for_stable_readable_file(path, timeout=20.0, interval=0.25):
    """Block until the file's size is stable across two reads
    (``:3413-3435`` — executors may still be flushing the render)."""
    deadline = time.time() + max(0.5, float(timeout or 0))
    history, last_exc = [], None
    while time.time() < deadline:
        size, exc = _probe_size(path)
        if exc is not None:
            last_exc, history = exc, []
        else:
            history = (history + [size])[-3:]
            stable = len(history) >= 3 and len(set(history)) == 1
            if stable and history[-1] > 0:
                return
        time.sleep(interval)
    if last_exc:
        raise RuntimeError(
            f"Scene video is still locked and cannot be read: {path}"
        ) from last_exc


def replace_file_with_retry(source_path, target_path):
    """copy -> atomic replace -> best-effort remove of the scratch source
    (``:3438-3470``)."""
    wait_for_stable_readable_file(source_path)
    temp_target = f"{target_path}.copying"
    index = 2
    while os.path.exists(temp_target):
        temp_target = f"{target_path}.copying_{index:02d}"
        index += 1
    try:
        retry_file_op(lambda: shutil.copy2(source_path, temp_target),
                      f"Copying scene video to temporary file "
                      f"'{temp_target}'")
        retry_file_op(lambda: os.replace(temp_target, target_path),
                      f"Replacing scene video '{target_path}'")
    finally:
        if os.path.exists(temp_target):
            try:
                os.remove(temp_target)
            except OSError:
                pass
    try:
        retry_file_op(lambda: os.remove(source_path),
                      f"Removing scratch scene video '{source_path}'",
                      attempts=8, delay=0.25)
    except Exception:
        pass  # copied fine; a locked scratch source is not fatal


def safe_project_subfolder(project_folder, folder_name):
    # validate BEFORE abspath: abspath("") is the server CWD, which
    # would silently move user media under the process working dir
    cleaned = str(project_folder or "").strip().strip('"')
    if not cleaned:
        raise ValueError("Project folder is empty.")
    project = os.path.abspath(cleaned)
    target = os.path.abspath(os.path.join(project, folder_name))
    if os.path.commonpath([project, target]) != project:
        raise ValueError("Target folder escapes the project folder.")
    os.makedirs(target, exist_ok=True)
    return project, target


def unique_final_video_path(project_folder, prefix="FINAL_VIDEO"):
    safe = "".join(ch if ch.isalnum() or ch in {"_", "-"} else "_"
                   for ch in str(prefix or "FINAL_VIDEO")).strip("_") \
        or "FINAL_VIDEO"
    candidate = os.path.join(project_folder, f"{safe}.mp4")
    index = 2
    while os.path.exists(candidate):
        candidate = os.path.join(project_folder, f"{safe}{index}.mp4")
        index += 1
    return candidate


def concat_escape(path):
    """Path escaping for ffmpeg concat list files (``:3365-3366``)."""
    return os.path.abspath(path).replace("\\", "/").replace("'", "'\\''")


def cleanup_video_scratch_folders(project_folder, keep_folders=None):
    """Delete per-scene scratch render folders, keeping the permanent
    stores (``:3369-3390``)."""
    project_folder = os.path.abspath(
        str(project_folder or "").strip().strip('"'))
    keep = {os.path.abspath(path) for path in (keep_folders or []) if path}
    prefixes = ("image_to_video_clips_", "text_to_video_clips_")
    permanent = {"image_to_video_clips", "text_to_video_clips",
                 "rendered_scene_videos", "rendered_scene_videos_backup"}
    removed = []
    if not os.path.isdir(project_folder):
        return removed
    for name in os.listdir(project_folder):
        path = os.path.abspath(os.path.join(project_folder, name))
        if path in keep or not os.path.isdir(path):
            continue
        if name in permanent or not name.startswith(prefixes):
            continue
        try:
            if os.path.commonpath([project_folder, path]) != project_folder:
                continue
            shutil.rmtree(path)
            removed.append(path)
        except OSError:
            pass
    return removed


# --------------------------------------------------------------------------
# approved-image save (reference :3162-3223)
# --------------------------------------------------------------------------

def resolve_generated_image_path(image_info, base=None):
    """Resolve an executor-emitted {filename, subfolder, type} reference
    against the framework's roots (standalone: output root + ingest dir
    stand in for ComfyUI's output/input/temp trees)."""
    from .workflow_runner import input_dir

    if not isinstance(image_info, dict):
        raise ValueError("Image info is missing.")
    filename = os.path.basename(str(image_info.get("filename", "") or ""))
    if not filename:
        raise ValueError("Image filename is empty.")
    image_type = str(image_info.get("type", "output") or "output").lower()
    base_dir = (input_dir(base) if image_type == "input"
                else os.path.abspath(base or DEFAULT_OUTPUT_ROOT))
    base_abs = os.path.abspath(base_dir)
    folder = os.path.abspath(os.path.join(
        base_abs, str(image_info.get("subfolder", "") or "")))
    if os.path.commonpath([base_abs, folder]) != base_abs:
        raise ValueError("Image subfolder escapes the allowed folder.")
    image_path = os.path.abspath(os.path.join(folder, filename))
    if os.path.commonpath([base_abs, image_path]) != base_abs:
        raise ValueError("Image path escapes the allowed folder.")
    if not os.path.isfile(image_path):
        raise FileNotFoundError(
            f"Generated image was not found: {image_path}")
    return image_path


def save_generated_image(payload, base=None) -> dict:
    """Copy an approved executor output into a keep folder
    (``:3215-3223``) with the reference's timestamped unique naming."""
    source_path = resolve_generated_image_path(payload.get("image"), base)
    raw_folder = str(payload.get("save_folder") or "").strip().strip('"')
    if not raw_folder:
        raw_folder = "VRGDG_WorkflowRunner_Saved"
    target_dir = (os.path.abspath(raw_folder) if os.path.isabs(raw_folder)
                  else os.path.abspath(os.path.join(
                      base or DEFAULT_OUTPUT_ROOT, raw_folder)))
    os.makedirs(target_dir, exist_ok=True)
    stem, ext = os.path.splitext(os.path.basename(source_path))
    ext = ext or ".png"
    stamp = time.strftime("%Y%m%d_%H%M%S")
    target = os.path.join(target_dir, f"{stem}_approved_{stamp}{ext}")
    counter = 2
    while os.path.exists(target):
        target = os.path.join(target_dir,
                              f"{stem}_approved_{stamp}_{counter}{ext}")
        counter += 1
    shutil.copy2(source_path, target)
    return {"saved_path": target, "save_folder": target_dir}


# --------------------------------------------------------------------------
# thumbnails + canvas probe (reference :3247-3338)
# --------------------------------------------------------------------------

def scene_thumbnail_path(video_path):
    root, _ext = os.path.splitext(os.path.abspath(str(video_path or "")))
    return f"{root}.jpg"


def create_scene_thumbnail(video_path, thumbnail_path=None) -> str:
    """Best-effort 480px poster frame.  ffmpeg when available (the
    reference's two-timestamp retry); cv2 first-frame fallback when not
    (this image ships no ffmpeg binary)."""
    video_path = os.path.abspath(str(video_path or "").strip().strip('"'))
    if not os.path.isfile(video_path):
        return ""
    thumbnail_path = os.path.abspath(
        str(thumbnail_path or scene_thumbnail_path(video_path))
        .strip().strip('"'))
    os.makedirs(os.path.dirname(thumbnail_path), exist_ok=True)
    try:
        ffmpeg = find_ffmpeg_path()
    except RuntimeError:
        return _cv2_thumbnail(video_path, thumbnail_path)

    def extract(timestamp):
        return _RUNNER([ffmpeg, "-y", "-ss", str(timestamp), "-i",
                        video_path, "-frames:v", "1", "-vf", "scale=480:-2",
                        "-q:v", "3", thumbnail_path], check=False)

    result = extract(0.5)
    if result.returncode != 0 or not os.path.isfile(thumbnail_path):
        result = extract(0)
    if result.returncode != 0 or not os.path.isfile(thumbnail_path):
        return ""
    return thumbnail_path


def _cv2_thumbnail(video_path, thumbnail_path) -> str:
    try:
        import cv2
    except ImportError:
        return ""
    capture = cv2.VideoCapture(video_path)
    try:
        ok, frame = capture.read()
    finally:
        capture.release()
    if not ok:
        return ""
    height, width = frame.shape[:2]
    if width > 480:
        frame = cv2.resize(frame, (480, max(2, int(round(
            height * 480.0 / width / 2)) * 2)))
    return thumbnail_path if cv2.imwrite(thumbnail_path, frame) else ""


def probe_video_size(video_path, ffmpeg_path=None):
    ffprobe = "ffprobe"
    if ffmpeg_path and ffmpeg_path != "ffmpeg":
        candidate = os.path.join(os.path.dirname(os.path.abspath(
            ffmpeg_path)), "ffprobe")
        if os.path.isfile(candidate):
            ffprobe = candidate
    result = _run([ffprobe, "-v", "error", "-select_streams", "v:0",
                   "-show_entries", "stream=width,height",
                   "-of", "csv=s=x:p=0", video_path],
                  "FFprobe could not read the video size.", check=True)
    text = (result.stdout or "").strip().splitlines()[0]
    width_text, height_text = text.lower().split("x", 1)
    return int(width_text), int(height_text)


def normalize_video_canvas(ffmpeg_path, source_path, target_path, width,
                           height) -> bool:
    """Cover-scale + center-crop onto the exact target canvas
    (``:3267-3297``); skipped when the source already matches."""
    width, height = int(width or 0), int(height or 0)
    if width <= 0 or height <= 0:
        return False
    try:
        source_size = probe_video_size(source_path, ffmpeg_path)
        if source_size == (width, height):
            return False
    except Exception:
        pass  # probe failure -> normalize anyway, like the reference
    vf = (f"scale={width}:{height}:force_original_aspect_ratio=increase,"
          f"crop={width}:{height},setsar=1")
    _run([ffmpeg_path, "-y", "-i", source_path, "-an", "-vf", vf,
          "-c:v", "libx264", "-pix_fmt", "yuv420p", "-preset", "veryfast",
          target_path],
         "FFmpeg could not normalize the final canvas.", check=True)
    return True


# --------------------------------------------------------------------------
# collect / trim / find (reference :3473-3610, :3720-3793)
# --------------------------------------------------------------------------

def _int_of(payload, key, default, lo, hi):
    try:
        value = int(payload.get(key, default))
    except Exception:
        value = default
    return max(lo, min(hi, value))


def _abs_path(payload, key):
    # "" stays "" — abspath("") is the server CWD, which would make the
    # folder guards downstream pass vacuously and scan/mutate the
    # process working directory
    cleaned = str(payload.get(key, "") or "").strip().strip('"')
    return os.path.abspath(cleaned) if cleaned else ""


def collect_scene_video(payload) -> dict:
    """Move a rendered scene into ``rendered_scene_videos`` as
    ``video_NNNN-audio.mp4`` (``:3473-3551``): prefer the newest
    ``-audio.mp4`` sibling of the given source, back up or overwrite an
    existing target, refresh the thumbnail."""
    source_path = _abs_path(payload, "source_path")
    if not os.path.isfile(source_path):
        raise FileNotFoundError(f"Scene video was not found: {source_path}")
    project_folder, target_dir = safe_project_subfolder(
        payload.get("project_folder", ""), "rendered_scene_videos")
    scene_number = _int_of(payload, "scene_number", 1, 1, 999999)
    existing_action = str(payload.get("existing_action", "overwrite")
                          or "overwrite").strip().lower()
    if existing_action not in {"overwrite", "backup"}:
        existing_action = "overwrite"

    source_dir = os.path.abspath(os.path.dirname(source_path))
    if not source_path.lower().endswith("-audio.mp4"):
        siblings = [os.path.join(source_dir, name)
                    for name in os.listdir(source_dir)
                    if name.lower().endswith("-audio.mp4")
                    and os.path.isfile(os.path.join(source_dir, name))]
        siblings.sort(key=os.path.getmtime, reverse=True)
        if siblings:
            source_path = os.path.abspath(siblings[0])

    target_path = os.path.join(target_dir,
                               f"video_{scene_number:04d}-audio.mp4")
    target_thumb = scene_thumbnail_path(target_path)
    backup_path = backup_thumb = ""
    if os.path.abspath(source_path) != os.path.abspath(target_path):
        if os.path.exists(target_path):
            if existing_action == "backup":
                backup_dir = os.path.join(project_folder,
                                          "rendered_scene_videos_backup",
                                          f"scene_{scene_number:04d}")
                os.makedirs(backup_dir, exist_ok=True)
                stamp = time.strftime("%Y%m%d_%H%M%S")
                backup_path = os.path.join(
                    backup_dir, f"video_{scene_number:04d}-audio_{stamp}.mp4")
                index = 2
                while os.path.exists(backup_path):
                    backup_path = os.path.join(
                        backup_dir,
                        f"video_{scene_number:04d}-audio_{stamp}_"
                        f"{index:02d}.mp4")
                    index += 1
                retry_file_op(
                    lambda: shutil.move(target_path, backup_path),
                    f"Backing up existing scene video '{target_path}'")
                if os.path.exists(target_thumb):
                    backup_thumb = scene_thumbnail_path(backup_path)
                    retry_file_op(
                        lambda: shutil.move(target_thumb, backup_thumb),
                        f"Backing up existing scene video thumbnail "
                        f"'{target_thumb}'")
            else:
                retry_file_op(
                    lambda: os.remove(target_path),
                    f"Removing existing scene video '{target_path}'")
                if os.path.exists(target_thumb):
                    try:
                        retry_file_op(
                            lambda: os.remove(target_thumb),
                            f"Removing existing scene video thumbnail "
                            f"'{target_thumb}'")
                    except Exception:
                        pass
        replace_file_with_retry(source_path, target_path)

    thumbnail_path = create_scene_thumbnail(target_path, target_thumb)
    return {
        "video_path": target_path,
        "thumbnail_path": thumbnail_path,
        "video_folder": target_dir,
        "backup_path": backup_path,
        "backup_thumbnail_path": backup_thumb,
        "existing_action": existing_action,
        "source_path": source_path,
        "removed_files": [],
        "removed_folder": "",
        "removed_scratch_folders": [],
    }


def trim_scene_video(payload) -> dict:
    """Re-encode a [start, start+duration) window of a scene clip into
    the scene store (``:3554-3610``)."""
    source_path = _abs_path(payload, "source_path")
    if not os.path.isfile(source_path):
        raise FileNotFoundError(f"Scene video was not found: {source_path}")
    if os.path.splitext(source_path)[1].lower() not in _VIDEO_EXTS:
        raise ValueError(
            f"Scene media is not a supported video file: {source_path}")
    _project, target_dir = safe_project_subfolder(
        payload.get("project_folder", ""), "rendered_scene_videos")
    scene_number = _int_of(payload, "scene_number", 1, 1, 999999)
    start = max(0.0, float(payload.get("start", 0) or 0))
    duration = max(0.05, float(payload.get("duration", 0) or 0))
    label = re.sub(r"[^A-Za-z0-9_-]+", "_",
                   str(payload.get("label", "trim") or "trim")
                   .strip().lower()).strip("_") or "trim"
    stamp = time.strftime("%Y%m%d_%H%M%S")
    mark = payload.get("mark_as_audio_video", False)
    if isinstance(mark, str):
        mark = mark.strip().lower() in {"1", "true", "yes", "on"}
    audio_suffix = "-audio" if mark else ""
    target_path = os.path.join(
        target_dir,
        f"video_{scene_number:04d}-{label}_{stamp}{audio_suffix}.mp4")
    index = 2
    while os.path.exists(target_path):
        target_path = os.path.join(
            target_dir,
            f"video_{scene_number:04d}-{label}_{stamp}_{index:02d}"
            f"{audio_suffix}.mp4")
        index += 1

    ffmpeg = find_ffmpeg_path()
    result = _RUNNER([ffmpeg, "-y", "-ss", f"{start:.6f}", "-i", source_path,
                      "-t", f"{duration:.6f}", "-map", "0:v:0",
                      "-map", "0:a?", "-c:v", "libx264", "-pix_fmt",
                      "yuv420p", "-preset", "veryfast", "-c:a", "aac",
                      "-movflags", "+faststart", target_path], check=False)
    if result.returncode != 0 or not os.path.isfile(target_path):
        raise RuntimeError((result.stderr or result.stdout
                            or "ffmpeg failed to trim scene video.").strip())
    return {
        "video_path": target_path,
        "thumbnail_path": create_scene_thumbnail(target_path),
        "video_folder": target_dir,
        "source_path": source_path,
        "start": start,
        "duration": duration,
    }


_MODE_PREFIXES = {
    "rtv": ("reference_to_video_clips", "reference_to_video_clips_"),
    "t2v": ("text_to_video_clips", "text_to_video_clips_"),
    "ingredients": ("ingredients_to_video_clips",
                    "ingredients_to_video_clips_"),
    "id_lora": ("id_lora_i2v_clips", "id_lora_i2v_clips_"),
}


def find_scene_video_output(payload) -> dict:
    """Locate the freshest ``-audio.mp4`` render for a scene by scored
    filename/mtime search over the mode's clip folders (``:3720-3793``)."""
    project_folder = _abs_path(payload, "project_folder")
    if not project_folder or not os.path.isdir(project_folder):
        raise ValueError("Project folder is empty or does not exist.")
    mode = str(payload.get("video_mode", "") or "").strip().lower()
    prefixes = _MODE_PREFIXES.get(
        mode, ("image_to_video_clips", "image_to_video_clips_"))
    scene_number = _int_of(payload, "scene_number", 0, 0, 999999)
    prompt_number = _int_of(payload, "prompt_number_one_based",
                            scene_number or 0, 0, 999999)
    min_mtime = float(payload.get("min_mtime") or 0)
    output_folder = (_abs_path(payload, "output_folder")
                     if payload.get("output_folder") else "")

    folders = []
    if output_folder and os.path.isdir(output_folder):
        try:
            if os.path.commonpath([project_folder, output_folder]) \
                    == project_folder:
                folders.append(output_folder)
        except ValueError:
            pass
    for name in os.listdir(project_folder):
        path = os.path.abspath(os.path.join(project_folder, name))
        if not os.path.isdir(path):
            continue
        if any(name == prefix.rstrip("_") or name.startswith(prefix)
               for prefix in prefixes):
            folders.append(path)
    folders = list(dict.fromkeys(folders))

    def _fresh_file_stat(path, floor):
        """mtime for a non-empty file at least as new as ``floor`` (1 s
        slack for coarse filesystem timestamps), else None."""
        try:
            stat = os.stat(path)
        except OSError:
            return None
        fresh = (not floor) or (stat.st_mtime + 1 >= floor)
        return stat.st_mtime if (stat.st_size > 0 and fresh) else None

    def _candidate_score(name, scene, prompt):
        """Reference ranking (:3776-3782): exact scene stem 1000, prompt
        prefix 700, embedded scene index 100 — additive."""
        rules = (
            (1000, scene and re.match(
                rf"^video_{scene:04d}-audio\.mp4$", name, re.IGNORECASE)),
            (700, prompt and re.match(
                rf"^video_{prompt:04d}(?:_|-)", name, re.IGNORECASE)),
            (100, scene and f"_{scene:04d}_" in name),
        )
        return sum(points for points, hit in rules if hit)

    candidates = []
    for folder in folders:
        for root, _dirs, files in os.walk(folder):
            try:
                if os.path.commonpath([project_folder,
                                       os.path.abspath(root)]) \
                        != project_folder:
                    continue
            except ValueError:
                continue
            for name in files:
                if not name.lower().endswith("-audio.mp4"):
                    continue
                path = os.path.abspath(os.path.join(root, name))
                stat = _fresh_file_stat(path, min_mtime)
                if stat is None:
                    continue
                candidates.append((_candidate_score(
                    name, scene_number, prompt_number), stat, path, folder))
    if not candidates:
        return {"video_path": "", "output_folder": "",
                "searched_folders": folders}
    candidates.sort(key=lambda item: (item[0], item[1]), reverse=True)
    _score, _mtime, path, folder = candidates[0]
    wait_for_stable_readable_file(path, timeout=8.0, interval=0.25)
    return {"video_path": path, "output_folder": folder,
            "searched_folders": folders}


# --------------------------------------------------------------------------
# opening color match (reference :3613-3717)
# --------------------------------------------------------------------------

def color_match_correction(reference_stats, target_stats):
    """Per-channel affine correction from PIL ImageStat pairs: scale
    clamped to [0.25, 4], std floored at 1 (``:3665-3670``)."""
    ref_mean = [float(v) for v in reference_stats.mean[:3]]
    ref_std = [max(1.0, float(v)) for v in reference_stats.stddev[:3]]
    tgt_mean = [float(v) for v in target_stats.mean[:3]]
    tgt_std = [max(1.0, float(v)) for v in target_stats.stddev[:3]]
    scales = [max(0.25, min(4.0, ref_std[i] / tgt_std[i])) for i in range(3)]
    offsets = [ref_mean[i] - tgt_mean[i] * scales[i] for i in range(3)]
    return scales, offsets


def write_color_match_cube(path, scales, offsets, cube_size=17):
    """Bake the affine correction into a .cube LUT for ffmpeg's lut3d
    (``:3672-3684``)."""
    with open(path, "w", encoding="utf-8", newline="\n") as handle:
        handle.write('TITLE "VRGDG opening color match"\n')
        handle.write(f"LUT_3D_SIZE {cube_size}\n"
                     "DOMAIN_MIN 0.0 0.0 0.0\nDOMAIN_MAX 1.0 1.0 1.0\n")
        for blue in range(cube_size):
            for green in range(cube_size):
                for red in range(cube_size):
                    values = [red, green, blue]
                    corrected = [
                        max(0.0, min(1.0,
                                     ((values[i] / (cube_size - 1)) * 255.0
                                      * scales[i] + offsets[i]) / 255.0))
                        for i in range(3)]
                    handle.write(f"{corrected[0]:.8f} {corrected[1]:.8f} "
                                 f"{corrected[2]:.8f}\n")


def match_scene_start_color(payload) -> dict:
    """Match a clip's opening color to the previous clip's final frame
    and fade the correction out over ``fade_seconds`` (``:3613-3717``):
    frame grabs -> affine stats correction -> baked LUT -> lut3d+blend
    with a time-decaying weight, replacing the clip in place."""
    from ..runtime.image_io import channel_stats

    project_folder = _abs_path(payload, "project_folder")
    video_path = _abs_path(payload, "video_path")
    reference_video_path = _abs_path(payload, "reference_video_path")
    if not project_folder or not os.path.isdir(project_folder):
        raise ValueError("Project folder is empty or does not exist.")
    for label, path in (("Scene video", video_path),
                        ("Previous scene video", reference_video_path)):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{label} was not found: {path}")
        try:
            inside = os.path.commonpath([project_folder, path]) \
                == project_folder
        except ValueError:
            inside = False
        if not inside:
            raise ValueError(
                f"{label} must be inside the current project folder.")

    fade_seconds = max(0.05, min(30.0,
                                 float(payload.get("fade_seconds", 1.0)
                                       or 1.0)))
    strength = max(0.0, min(1.0, float(payload.get("strength", 0.85)
                                       or 0.85)))
    if strength <= 0.0:
        return {"video_path": video_path, "applied": False,
                "reason": "strength is zero"}

    ffmpeg = find_ffmpeg_path()
    work_dir = os.path.dirname(video_path)
    token = f"{int(time.time() * 1000)}_{os.getpid()}"
    reference_frame = os.path.join(work_dir,
                                   f".vrgdg_color_reference_{token}.png")
    target_frame = os.path.join(work_dir,
                                f".vrgdg_color_target_{token}.png")
    cube_path = os.path.join(work_dir, f".vrgdg_color_match_{token}.cube")
    output_path = os.path.join(work_dir,
                               f".vrgdg_color_matched_{token}.mp4")
    try:
        # -update 1 keeps the LAST decoded frame of the final second
        _run([ffmpeg, "-y", "-sseof", "-1", "-i", reference_video_path,
              "-map", "0:v:0", "-an", "-update", "1", reference_frame],
             "FFmpeg could not read the previous clip's final frame.",
             cwd=work_dir)
        _run([ffmpeg, "-y", "-i", video_path, "-map", "0:v:0", "-an",
              "-frames:v", "1", target_frame],
             "FFmpeg could not read the new clip's first frame.",
             cwd=work_dir)

        ref_stats = channel_stats(reference_frame)
        tgt_stats = channel_stats(target_frame)
        scales, offsets = color_match_correction(ref_stats, tgt_stats)
        write_color_match_cube(cube_path, scales, offsets)

        weight = (f"max(0\\,min(1\\,{strength:.6f}"
                  f"*(1-T/{fade_seconds:.6f})))")
        filter_graph = (
            "[0:v]split=2[original][to_match];"
            f"[to_match]lut3d=file='{os.path.basename(cube_path)}'"
            "[matched];"
            f"[original][matched]blend=all_expr="
            f"'A*(1-({weight}))+B*({weight})'[video]")
        _run([ffmpeg, "-y", "-i", video_path,
              "-filter_complex", filter_graph,
              "-map", "[video]", "-map", "0:a?",
              "-c:v", "libx264", "-preset", "veryfast", "-crf", "16",
              "-pix_fmt", "yuv420p", "-c:a", "copy",
              "-movflags", "+faststart", output_path],
             "FFmpeg could not apply the opening color match.",
             cwd=work_dir)
        if not os.path.isfile(output_path) or \
                os.path.getsize(output_path) <= 0:
            raise RuntimeError(
                "Opening color match did not create a valid video.")
        os.replace(output_path, video_path)
        thumbnail_path = create_scene_thumbnail(
            video_path, scene_thumbnail_path(video_path))
        return {"video_path": video_path, "thumbnail_path": thumbnail_path,
                "applied": True, "fade_seconds": fade_seconds,
                "strength": strength,
                "reference_video_path": reference_video_path}
    finally:
        for temporary in (reference_frame, target_frame, cube_path,
                          output_path):
            try:
                if os.path.isfile(temporary):
                    os.remove(temporary)
            except OSError:
                pass


# --------------------------------------------------------------------------
# final-video stitcher (reference :3796-4169)
# --------------------------------------------------------------------------

def _validated_scene_paths(raw_paths) -> list[str]:
    paths = []
    for index, raw in enumerate(raw_paths, start=1):
        path = os.path.abspath(str(raw or "").strip().strip('"'))
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"Scene {index} video was not found: {path}")
        if os.path.splitext(path)[1].lower() not in _VIDEO_EXTS:
            raise ValueError(
                f"Scene {index} media is not a supported video file: {path}")
        paths.append(path)
    return paths


def _validated_scene_audio(payload, scene_paths):
    """(paths, items) for the three audio sourcing modes: explicit timed
    items, plain paths, or the scenes' own embedded audio
    (``:3830-3859``)."""
    raw_items = payload.get("scene_audio_items", [])
    raw_items = raw_items if isinstance(raw_items, list) else []
    raw_paths = payload.get("scene_audio_paths", [])
    raw_paths = raw_paths if isinstance(raw_paths, list) else []
    paths, items = [], []
    if raw_items and any(str((item or {}).get("path", "")
                             if isinstance(item, dict) else "").strip()
                         for item in raw_items):
        if len(raw_items) != len(scene_paths):
            raise ValueError(
                "Scene audio item count does not match scene video count.")
        for index, item in enumerate(raw_items, start=1):
            if not isinstance(item, dict):
                raise ValueError(f"Scene {index} audio item is invalid.")
            path = os.path.abspath(str(item.get("path", "") or "").strip()
                                   .strip('"'))
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"Scene {index} audio was not found: {path}")
            items.append({"path": path,
                          "start": max(0.0, float(item.get("start", 0)
                                                  or 0)),
                          "duration": max(0.05, float(item.get("duration", 0)
                                                      or 0))})
            paths.append(path)
    elif raw_paths and any(str(item or "").strip() for item in raw_paths):
        if len(raw_paths) != len(scene_paths):
            raise ValueError(
                "Scene audio path count does not match scene video count.")
        for index, raw in enumerate(raw_paths, start=1):
            path = os.path.abspath(str(raw or "").strip().strip('"'))
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"Scene {index} audio was not found: {path}")
            paths.append(path)
            items.append({"path": path, "start": 0.0, "duration": 0.0})
    elif payload.get("use_embedded_scene_audio"):
        for path in scene_paths:
            paths.append(path)
            items.append({"path": path, "start": 0.0, "duration": 0.0,
                          "embedded": True})
    return paths, items


def _validated_inserts(raw_items) -> list[dict]:
    inserts = []
    for index, item in enumerate(raw_items, start=1):
        if not isinstance(item, dict):
            raise ValueError(f"Insert {index} item is invalid.")
        path = os.path.abspath(str(item.get("path", "") or "").strip()
                               .strip('"'))
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"Insert {index} video was not found: {path}")
        if os.path.splitext(path)[1].lower() not in _VIDEO_EXTS:
            raise ValueError(
                f"Insert {index} media is not a supported video file: "
                f"{path}")
        start = max(0.0, float(item.get("start", 0) or 0))
        end = max(start + 0.05, float(item.get("end", start + 4)
                                      or start + 4))
        inserts.append({"path": path, "start": start, "end": end,
                        "duration": end - start,
                        "source_start": max(0.0,
                                            float(item.get("source_start", 0)
                                                  or 0))})
    inserts.sort(key=lambda item: (item["start"], item["end"]))
    return inserts


def _write_concat_list(path, entries):
    with open(path, "w", encoding="utf-8") as handle:
        for entry in entries:
            handle.write(entry)


def _remove_quietly(*paths):
    for path in paths:
        try:
            if path and os.path.exists(path):
                os.remove(path)
        except OSError:
            pass


def stitch_scene_videos(payload) -> dict:
    """Assemble the final video (``:3796-4169``): optional per-scene
    timeline frame alignment, stream-copy concat, insert-clip
    flattening, canvas normalization, scene/global audio assembly, and
    the final mux — then scratch-folder cleanup.  All ffmpeg work flows
    through the runner seam; the command plan is parity-locked against
    the reference in tests/test_scene_render.py."""
    raw_paths = payload.get("scene_paths", [])
    if not isinstance(raw_paths, list) or not raw_paths:
        raise ValueError("No scene video paths were provided.")
    project_folder, target_dir = safe_project_subfolder(
        payload.get("project_folder", ""), "rendered_scene_videos")
    scene_paths = _validated_scene_paths(raw_paths)
    scene_audio_paths, scene_audio_items = _validated_scene_audio(
        payload, scene_paths)
    raw_overlays = payload.get("overlay_items", [])
    raw_overlays = raw_overlays if isinstance(raw_overlays, list) else []
    raw_timing = payload.get("scene_timing_items", [])
    raw_timing = raw_timing if isinstance(raw_timing, list) else []
    audio_path = _abs_path(payload, "audio_path")
    preview_audio_start = max(0.0, float(payload.get("audio_start", 0) or 0))
    preview_audio_duration = max(0.0, float(payload.get("audio_duration", 0)
                                            or 0))
    target_width = _int_of(payload, "width", 0, 0, 8192)
    target_height = _int_of(payload, "height", 0, 0, 8192)
    timeline_fps = _int_of(payload, "timeline_fps", 0, 0, 120)
    if not scene_audio_paths and not os.path.isfile(audio_path):
        raise FileNotFoundError(f"Audio file was not found: {audio_path}")

    ffmpeg = find_ffmpeg_path()

    # --- optional per-scene timeline frame alignment (:3862-3916) ---
    timeline_sync_paths = []
    timeline_frames = 0
    concat_scene_paths = scene_paths
    if raw_timing:
        if timeline_fps <= 0:
            raise ValueError(
                "Timeline FPS is required when scene timing items are "
                "provided.")
        if len(raw_timing) != len(scene_paths):
            raise ValueError(
                "Scene timing item count does not match scene video count.")
        concat_scene_paths = []
        for index, (path, item) in enumerate(zip(scene_paths, raw_timing),
                                             start=1):
            if not isinstance(item, dict):
                raise ValueError(f"Scene {index} timing item is invalid.")
            start = max(0.0, float(item.get("start", 0) or 0))
            end = max(start, float(item.get("end", start) or start))
            target_frames = max(1, int(end * timeline_fps + 0.5)
                                - int(start * timeline_fps + 0.5))
            timeline_frames += target_frames
            sync_path = os.path.join(
                target_dir, f"_temp_timeline_scene_{index:04d}.mp4")
            sync_filter = (f"fps={timeline_fps},"
                           "tpad=stop_mode=clone:stop_duration=1,"
                           f"trim=start_frame=0:end_frame={target_frames},"
                           "setpts=PTS-STARTPTS")
            result = _RUNNER([ffmpeg, "-y", "-i", path, "-map", "0:v:0",
                              "-an", "-vf", sync_filter, "-frames:v",
                              str(target_frames), "-r", str(timeline_fps),
                              "-c:v", "libx264", "-pix_fmt", "yuv420p",
                              "-preset", "veryfast", sync_path],
                             check=False)
            if result.returncode != 0 or not os.path.isfile(sync_path):
                raise RuntimeError(
                    (result.stderr or result.stdout
                     or f"FFmpeg failed to align scene {index} to the "
                        "timeline.").strip())
            timeline_sync_paths.append(sync_path)
            concat_scene_paths.append(sync_path)

    concat_file = os.path.join(target_dir, "concat_list.txt")
    _write_concat_list(concat_file,
                       [f"file '{concat_escape(path)}'\n"
                        for path in concat_scene_paths])

    temp_video = os.path.join(target_dir, "_temp_video_no_audio.mp4")
    normalized_video = os.path.join(target_dir,
                                    "_temp_video_normalized_canvas.mp4")
    temp_audio = os.path.join(target_dir, "_temp_scene_audio.m4a")
    temp_global_audio = os.path.join(target_dir, "_temp_global_audio.m4a")
    temp_audio_parts = []
    audio_concat_file = os.path.join(target_dir, "audio_concat_list.txt")
    final_output = unique_final_video_path(
        project_folder, payload.get("output_prefix", "FINAL_VIDEO"))
    normalized_canvas = False

    _RUNNER([ffmpeg, "-y", "-f", "concat", "-safe", "0", "-i", concat_file,
             "-an", "-c:v", "copy", temp_video], check=True)

    # --- insert clips flattened into the main video (:3948-4031) ---
    insert_items = _validated_inserts(raw_overlays)
    if insert_items:
        flattened = os.path.join(target_dir, "_temp_video_with_inserts.mp4")
        flatten_list = os.path.join(target_dir, "flatten_concat_list.txt")
        flatten_parts = []

        def add_part(source, start=None, duration=None):
            part = os.path.join(
                target_dir, f"_temp_flatten_part_{len(flatten_parts) + 1:04d}"
                            ".mp4")
            cmd = [ffmpeg, "-y"]
            if start is not None:
                cmd += ["-ss", f"{max(0.0, float(start)):.6f}"]
            cmd += ["-i", source]
            if duration is not None:
                cmd += ["-t", f"{max(0.05, float(duration)):.6f}"]
            cmd += ["-an", "-c:v", "libx264", "-pix_fmt", "yuv420p",
                    "-preset", "veryfast", part]
            _RUNNER(cmd, check=True)
            flatten_parts.append(part)

        cursor = 0.0
        for item in insert_items:
            if item["start"] > cursor + 0.01:
                add_part(temp_video, cursor, item["start"] - cursor)
            add_part(item["path"], item.get("source_start", 0.0),
                     item["duration"])
            cursor = max(cursor, item["end"])
        add_part(temp_video, cursor, None)
        _write_concat_list(flatten_list,
                           [f"file '{concat_escape(path)}'\n"
                            for path in flatten_parts])
        _RUNNER([ffmpeg, "-y", "-f", "concat", "-safe", "0", "-i",
                 flatten_list, "-an", "-c:v", "copy", flattened],
                check=True)
        _remove_quietly(temp_video, flatten_list, *flatten_parts)
        temp_video = flattened

    if target_width > 0 and target_height > 0:
        normalized_canvas = normalize_video_canvas(
            ffmpeg, temp_video, normalized_video, target_width,
            target_height)
        if normalized_canvas:
            _remove_quietly(temp_video)
            temp_video = normalized_video

    # --- audio assembly: per-scene concat or global trim (:4042-4090) ---
    mux_audio_path = audio_path
    if scene_audio_paths:
        entries = []
        for index, item in enumerate(scene_audio_items, start=1):
            path = item["path"]
            duration = float(item.get("duration", 0) or 0)
            if item.get("embedded") or item.get("start", 0) or duration:
                part = os.path.join(target_dir,
                                    f"_temp_scene_audio_{index:04d}.m4a")
                cmd = [ffmpeg, "-y", "-ss",
                       str(float(item.get("start", 0) or 0)), "-i", path]
                if duration:
                    cmd += ["-t", str(duration)]
                cmd += ["-vn", "-c:a", "aac", part]
                _RUNNER(cmd, check=True)
                temp_audio_parts.append(part)
                path = part
            entries.append(f"file '{concat_escape(path)}'\n")
        _write_concat_list(audio_concat_file, entries)
        _RUNNER([ffmpeg, "-y", "-f", "concat", "-safe", "0", "-i",
                 audio_concat_file, "-vn", "-c:a", "aac", temp_audio],
                check=True)
        mux_audio_path = temp_audio
    elif preview_audio_start or preview_audio_duration:
        cmd = [ffmpeg, "-y"]
        if preview_audio_start:
            cmd += ["-ss", f"{preview_audio_start:.6f}"]
        cmd += ["-i", audio_path]
        if preview_audio_duration:
            cmd += ["-t", f"{preview_audio_duration:.6f}"]
        cmd += ["-vn", "-c:a", "aac", temp_global_audio]
        _RUNNER(cmd, check=True)
        mux_audio_path = temp_global_audio

    mux_cmd = [ffmpeg, "-y", "-i", temp_video, "-i", mux_audio_path,
               "-c:v", "copy", "-c:a", "aac"]
    if not timeline_sync_paths:
        mux_cmd.append("-shortest")
    mux_cmd.append(final_output)
    try:
        _RUNNER(mux_cmd, check=True)
    finally:
        _remove_quietly(temp_video, normalized_video, concat_file,
                        audio_concat_file, temp_audio, temp_global_audio,
                        *temp_audio_parts, *timeline_sync_paths)
    removed = cleanup_video_scratch_folders(project_folder,
                                            keep_folders=[target_dir])
    return {
        "final_video_path": final_output,
        "video_folder": target_dir,
        "concat_file": "",
        "scene_count": len(scene_paths),
        "insert_count": len(insert_items),
        "used_scene_audio": bool(scene_audio_paths),
        "used_embedded_scene_audio": bool(
            payload.get("use_embedded_scene_audio") and scene_audio_paths),
        "normalized_canvas": normalized_canvas,
        "timeline_frame_sync": bool(timeline_sync_paths),
        "timeline_fps": timeline_fps if timeline_sync_paths else 0,
        "timeline_frame_count": timeline_frames,
        "output_width": target_width,
        "output_height": target_height,
        "removed_scratch_folders": removed,
    }


# --------------------------------------------------------------------------
# image slideshow preview (reference :4172-4271)
# --------------------------------------------------------------------------

def render_image_slideshow(payload) -> dict:
    """Stills -> normalized common canvas -> concat-demuxer slideshow ->
    audio mux (``:4172-4271``).  Every still is normalized to one RGB
    frame first: the concat demuxer can drop an image at a mid-list
    resolution change while the filter graph reinitializes."""
    import tempfile

    raw_items = payload.get("image_items", [])
    if not isinstance(raw_items, list) or not raw_items:
        raise ValueError(
            "No scene images were provided for the slideshow preview.")
    project_folder, target_dir = safe_project_subfolder(
        payload.get("project_folder", ""), "slideshow_previews")
    audio_path = _abs_path(payload, "audio_path")
    if not os.path.isfile(audio_path):
        raise FileNotFoundError(
            f"Global audio file was not found: {audio_path}")
    audio_start = max(0.0, float(payload.get("audio_start", 0) or 0))
    target_width = _int_of(payload, "width", 1920, 64, 8192)
    target_height = _int_of(payload, "height", 1080, 64, 8192)
    fps = _int_of(payload, "fps", 24, 1, 120)

    items = []
    for index, item in enumerate(raw_items, start=1):
        if not isinstance(item, dict):
            raise ValueError(f"Scene {index} slideshow item is invalid.")
        path = os.path.abspath(str(item.get("path", "") or "").strip()
                               .strip('"'))
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"Scene {index} image was not found: {path}")
        if os.path.splitext(path)[1].lower() not in _IMAGE_EXTS:
            raise ValueError(
                f"Scene {index} media is not a supported slideshow image: "
                f"{path}")
        items.append({"path": path,
                      "duration": max(0.05, float(item.get("duration", 0)
                                                  or 0))})

    total_duration = sum(item["duration"] for item in items)
    ffmpeg = find_ffmpeg_path()
    scratch = tempfile.mkdtemp(prefix="_slideshow_", dir=target_dir)
    concat_file = os.path.join(scratch, "images.txt")
    video_only = os.path.join(scratch, "video.mp4")
    final_output = unique_final_video_path(
        project_folder, payload.get("output_prefix",
                                    "IMAGE_SLIDESHOW_PREVIEW"))
    try:
        normalize_filter = (
            f"scale={target_width}:{target_height}:"
            "force_original_aspect_ratio=decrease,"
            f"pad={target_width}:{target_height}:(ow-iw)/2:(oh-ih)/2:"
            "color=black,setsar=1,format=rgb24")
        normalized = []
        for index, item in enumerate(items, start=1):
            frame_path = os.path.join(scratch, f"image_{index:06d}.png")
            try:
                _RUNNER([ffmpeg, "-y", "-i", item["path"], "-vf",
                         normalize_filter, "-frames:v", "1", frame_path],
                        check=True)
            except subprocess.CalledProcessError as exc:
                detail = exc.stderr or exc.output or str(exc)
                raise RuntimeError(
                    f"Could not normalize slideshow Scene {index}:\n"
                    f"{detail}") from exc
            normalized.append({"path": frame_path,
                               "duration": item["duration"]})

        entries = []
        for item in normalized:
            entries.append(f"file '{concat_escape(item['path'])}'\n")
            entries.append(f"duration {item['duration']:.6f}\n")
        # the demuxer only honors the final duration when the last still
        # repeats once
        entries.append(f"file '{concat_escape(normalized[-1]['path'])}'\n")
        _write_concat_list(concat_file, entries)

        _RUNNER([ffmpeg, "-y", "-f", "concat", "-safe", "0", "-i",
                 concat_file, "-vf", f"fps={fps},format=yuv420p", "-an",
                 "-c:v", "libx264", "-preset", "veryfast", "-crf", "20",
                 "-t", f"{total_duration:.6f}", "-movflags", "+faststart",
                 video_only], check=True)
        mux_cmd = [ffmpeg, "-y", "-i", video_only]
        if audio_start:
            mux_cmd += ["-ss", f"{audio_start:.6f}"]
        mux_cmd += ["-i", audio_path, "-map", "0:v:0", "-map", "1:a:0",
                    "-t", f"{total_duration:.6f}", "-c:v", "copy",
                    "-c:a", "aac", "-shortest", "-movflags", "+faststart",
                    final_output]
        _RUNNER(mux_cmd, check=True)
        if not os.path.isfile(final_output) or \
                os.path.getsize(final_output) <= 0:
            raise RuntimeError(
                "FFmpeg did not create the slideshow preview video.")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return dict(
        final_video_path=final_output, video_folder=target_dir,
        scene_count=len(items), duration=total_duration,
        audio_start=audio_start, output_width=target_width,
        output_height=target_height, fps=fps)
