"""Generate example JPEGs for every bundled LUT, graded on the device.

    python -m vrgdg_tpu_torch.tools.generate_lut_examples [OUTPUT_DIR]
        [--device cuda|cpu]

Counterpart of ``tools/generate_lut_examples.py``: the same synthetic test
frame (sky gradient, skin/foliage/sea colour patches, a neutral gray
ramp), graded through each bundled ``.cube`` at full strength
(10) with :func:`vrgdg_tpu_torch.ops.lut.apply_lut` on the device (the
card unless ``--device cpu``), quantized on the host as the original
does, and written as ``<stem>.jpg`` at quality 88 through
:func:`vrgdg_tpu_torch.runtime.image_io.write_rgb` (cv2's JPEG encoder, so
the bytes are not Pillow's).  ``OUTPUT_DIR`` defaults to
``LUTS/examples``, the folder the catalog pairs the LUTs with.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..api.paths import DEFAULT_LUTS_DIR

WIDTH, HEIGHT = 480, 270
JPEG_QUALITY = 88
STRENGTH = 10.0


def test_frame() -> np.ndarray:
    """A frame exercising hues, skin tones, and the neutral axis."""
    yy = np.linspace(0, 1, HEIGHT, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, WIDTH, dtype=np.float32)[None, :]
    # sky-like vertical gradient
    frame = np.stack([
        0.35 + 0.25 * yy + 0.05 * xx,
        0.55 - 0.15 * yy + 0.05 * xx,
        0.85 - 0.45 * yy + 0.0 * xx,
    ], axis=-1) * np.ones((HEIGHT, WIDTH, 1), np.float32)
    # color patches: skin, foliage, sea, sand, brick
    patches = [
        (0.85, 0.64, 0.52), (0.23, 0.42, 0.18), (0.10, 0.32, 0.45),
        (0.84, 0.74, 0.55), (0.55, 0.23, 0.18), (0.9, 0.85, 0.2),
    ]
    pw = WIDTH // len(patches)
    for i, rgb in enumerate(patches):
        frame[HEIGHT // 2:HEIGHT * 3 // 4, i * pw:(i + 1) * pw] = rgb
    # neutral gray ramp on the bottom row band
    ramp = np.linspace(0, 1, WIDTH, dtype=np.float32)[None, :, None]
    frame[HEIGHT * 3 // 4:] = ramp
    return np.clip(frame, 0.0, 1.0)


def quantize(graded: np.ndarray) -> np.ndarray:
    """[0,1] float RGB -> uint8, truncating as the original tool does."""
    return np.clip(graded * 255.0, 0, 255).astype(np.uint8)


def grade_examples(device="cuda") -> dict[str, np.ndarray]:
    """``{lut file name: the graded (H, W, 3) float32 frame}`` for every
    bundled ``.cube``, each graded on ``device``."""
    import torch

    from ..core.cube import GLOBAL_LUT_CACHE, list_lut_files
    from ..ops.lut import apply_lut
    from ..runtime.batch_stream import resolve_device

    device = resolve_device(device)
    frame = torch.from_numpy(test_frame()[None]).to(device)
    graded = {}
    for name in list_lut_files(DEFAULT_LUTS_DIR):
        lut = GLOBAL_LUT_CACHE.load(os.path.join(DEFAULT_LUTS_DIR, name))
        graded[name] = apply_lut(frame, lut, strength=STRENGTH)[0].cpu().numpy()
    return graded


def write_examples(graded: dict[str, np.ndarray], output_dir: str) -> list[str]:
    """Write each graded frame as ``<stem>.jpg``; the paths written."""
    from ..runtime.image_io import write_rgb

    os.makedirs(output_dir, exist_ok=True)
    return [write_rgb(os.path.join(output_dir,
                                   f"{os.path.splitext(name)[0]}.jpg"),
                      quantize(frame), quality=JPEG_QUALITY)
            for name, frame in graded.items()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vrgdg_tpu_torch.tools.generate_lut_examples",
        description="example JPEGs for every bundled LUT")
    parser.add_argument("output_dir", nargs="?",
                        default=os.path.join(DEFAULT_LUTS_DIR, "examples"),
                        help="folder for the JPEGs (default LUTS/examples)")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the grade (default cuda)")
    args = parser.parse_args(argv)
    try:
        graded = grade_examples(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))
    for path in write_examples(graded, args.output_dir):
        print(f"wrote {path}")
    print(f"{len(graded)} examples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
