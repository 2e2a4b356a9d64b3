"""Folder-indexed media loaders.

Counterpart of :mod:`vrgdg_tpu.runtime.media_loaders`: the reference's
folder-driven loading surface as pure functions over numpy BHWC float32
[0,1] arrays (the framework frame contract), with images decoded as
Pillow decodes them (:func:`vrgdg_tpu_torch.runtime.image_io.read_rgb`):

- indexed image loading with numeric filename order, wrap-around, and a
  random-after-end mode that avoids the two most recent picks
  (``GeneralVideoNodes.py:2754-2845``, IndexedImageFromFolder)
- remake-mode loading that matches the number embedded in the filename to
  ``index + 1`` (``GeneralVideoNodes.py:2917-2979``)
- multi-video folder concatenation into one frame batch
  (``nodes.py:1327-1377``, VRGDG_LoadVideos)

Random-pick history is explicit state passed in and returned (no
class-level globals) so jobs and tests stay deterministic; a module-level
convenience history keeps the "no repeat within two picks" behavior for
interactive callers.
"""

from __future__ import annotations

import os
import random
import re

import numpy as np

from .image_io import read_rgb
from .video_io import IMAGE_EXTENSIONS as _IMAGE_EXTS
from .video_io import VIDEO_EXTENSIONS as _VIDEO_EXTS

# The reference's loaders additionally accept .tiff images
# (GeneralVideoNodes.py:2795); videos reuse the shared framework set.
IMAGE_EXTENSIONS = tuple(sorted(_IMAGE_EXTS | {".tiff"}))
VIDEO_EXTENSIONS = tuple(sorted(_VIDEO_EXTS))


def _first_number(filename: str) -> float:
    """Sort key: the first integer embedded in the name, unnumbered last."""
    match = re.search(r"\d+", filename)
    return int(match.group()) if match else float("inf")


def list_images(folder: str) -> list[str]:
    """Image filenames in ``folder`` sorted by embedded number.

    Matches the reference's numeric ordering
    (GeneralVideoNodes.py:2806-2813).
    """
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"Folder does not exist: {folder}")
    names = [n for n in os.listdir(folder)
             if n.lower().endswith(IMAGE_EXTENSIONS)]
    if not names:
        raise FileNotFoundError(f"No images found in folder: {folder}")
    return sorted(names, key=_first_number)


def load_image(path: str) -> np.ndarray:
    """Decode one image file to (1, H, W, 3) float32 RGB in [0,1]."""
    rgb = read_rgb(path).astype(np.float32) / 255.0
    return rgb[None, ...]


# Convenience history for interactive use; deterministic callers pass
# their own list (the reference keeps this on the node class:
# GeneralVideoNodes.py:2763).
_RANDOM_HISTORY: list[int] = []


def indexed_image_from_folder(folder: str, index: int,
                              random_after_end: bool = False,
                              history: list[int] | None = None,
                              rng: random.Random | None = None,
                              ) -> tuple[np.ndarray, int]:
    """Load image number ``index`` from a numerically sorted folder.

    In-range (or ``random_after_end=False``) indices wrap modulo the file
    count. Past the end with ``random_after_end=True``, a random index is
    drawn that avoids the last two picks recorded in ``history`` (which
    is mutated in place). Returns ``(frames, picked_index)``.

    Reference behavior: GeneralVideoNodes.py:2788-2845.
    """
    files = list_images(folder)
    if history is None:
        history = _RANDOM_HISTORY
    if random_after_end and index >= len(files):
        picker = rng if rng is not None else random
        choices = list(range(len(files)))
        for previous in history:
            if previous in choices and len(choices) > 2:
                choices.remove(previous)
        index = picker.choice(choices)
        history.append(index)
        while len(history) > 2:
            history.pop(0)
    else:
        index = index % len(files)
    return load_image(os.path.join(folder, files[index])), index


def numbered_image_from_folder(folder: str, index: int) -> np.ndarray:
    """Load the image whose embedded filename number equals ``index + 1``.

    The remake-mode contract: index 0 selects ``*_00001_*``; a missing
    number is an error, not a wrap (GeneralVideoNodes.py:2917-2979).
    """
    files = list_images(folder)
    target = index + 1
    for name in files:
        match = re.search(r"\d+", name)
        if match and int(match.group()) == target:
            return load_image(os.path.join(folder, name))
    raise FileNotFoundError(
        f"No image numbered {target} (index {index}) in folder: {folder}")


def image_batch_from_paths(paths) -> np.ndarray:
    """Stack image files into one (N, H, W, 3) float32 [0,1] batch; all
    images must share dimensions (VRGDG_GeneralNodes2.py:4056,
    VRGDG_ImageBatchMultiFromPaths).
    """
    frames = [load_image(str(p))[0] for p in paths if str(p).strip()]
    if not frames:
        raise ValueError("At least one image path is required.")
    shapes = {f.shape for f in frames}
    if len(shapes) > 1:
        raise ValueError(f"Images must share dimensions to batch; "
                         f"got {sorted(shapes)}.")
    return np.stack(frames, axis=0)


def load_videos_from_folder(folder: str, scene_count: int = 3
                            ) -> np.ndarray:
    """Concatenate the first ``scene_count`` videos (name order) into one
    (N, H, W, 3) float32 [0,1] batch.

    Reference behavior: nodes.py:1343-1377 (VRGDG_LoadVideos). Videos
    must share spatial dims to concatenate — same constraint the
    reference inherits from ``torch.cat``.
    """
    from .video_io import VideoReader

    if not os.path.isdir(folder):
        raise FileNotFoundError(f"Folder does not exist: {folder}")
    names = sorted(n for n in os.listdir(folder)
                   if n.lower().endswith(VIDEO_EXTENSIONS))
    if not names:
        raise FileNotFoundError(f"No video files found in {folder}")
    batches: list[np.ndarray] = []
    for name in names[:max(1, int(scene_count))]:
        with VideoReader(os.path.join(folder, name), batch_size=64) as rd:
            batches.extend(batch for _, batch in rd)
    if not batches:
        raise ValueError("No frames loaded from any videos.")
    return np.concatenate(batches, axis=0)
