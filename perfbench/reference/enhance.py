"""Plain reference of the Standalone Video Enhancer's frame path
(``VRGDG_StandaloneVideoEnhancerNodes.py:142-294``): "fake upscale" to the
target's long edge, Lanczos-4 resampling, clip to [0, 1], unsharp mask
(zero border when the accelerator is used), seeded film grain.

Lanczos-4 as OpenCV defines it: output sample ``i`` sits at source
position ``(i + 0.5) * src / dst - 0.5``; the eight taps around it are
weighted ``sinc(d) * sinc(d / 4)`` and normalised to sum 1; taps past the
border read the edge sample.  The weights are worked out here in float64,
and the resampling runs as two products, height then width.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import common

_LONG_EDGE = {"2k": 2560, "3k": 3072, "4k": 3840}


def output_size(width: int, height: int, resolution: str) -> tuple[int, int]:
    """Width and height after scaling the long edge up to the target,
    each rounded to an even number; never down."""
    target = _LONG_EDGE.get(str(resolution).strip().lower(), 0)
    if target <= max(width, height):
        return width, height
    scale = target / max(width, height)
    return (max(2, int(round(width * scale / 2.0)) * 2),
            max(2, int(round(height * scale / 2.0)) * 2))


def lanczos4_matrix(src: int, dst: int) -> np.ndarray:
    """``(dst, src)`` float64 weights of one axis."""
    centre = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    taps = np.floor(centre)[:, None] + np.arange(-3, 5)[None, :]
    distance = centre[:, None] - taps
    weights = np.where(np.abs(distance) < 4.0,
                       np.sinc(distance) * np.sinc(distance / 4.0), 0.0)
    weights /= weights.sum(axis=1, keepdims=True)
    out = np.zeros((dst, src))
    rows = np.repeat(np.arange(dst), taps.shape[1])
    np.add.at(out, (rows, np.clip(taps, 0, src - 1).astype(np.int64).ravel()),
              weights.ravel())
    return out


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as the tensor cores round their inputs."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _tf32_products():
    flags = torch.backends.cuda.matmul
    try:
        name, saved, value = "allow_tf32", flags.allow_tf32, True
    except RuntimeError:
        name, saved, value = "fp32_precision", flags.fp32_precision, "tf32"
    setattr(flags, name, value)
    try:
        yield
    finally:
        setattr(flags, name, saved)


class Reference:
    """The expected uint8 frames of one run's clips: in float64, or as the
    ``control`` spec of the configuration says (its ``dtype``, and
    ``matmul: "tf32"`` for the two products in TF32: on a card by
    cuBLAS's TF32 path, on the CPU with TF32-rounded operands)."""

    def __init__(self, config: dict, inputs, root: str, device,
                 control: dict | None = None):
        control = control or {"dtype": "float64"}
        self.settings = config["settings"]
        self.device = torch.device(device)
        self.dtype = getattr(torch, control["dtype"])
        self.matmul = control.get("matmul", "ieee")
        height, width = inputs.pool.shape[1:3]
        self.out_w, self.out_h = output_size(
            width, height, self.settings["upscale_resolution"])
        self.rows = torch.from_numpy(lanczos4_matrix(height, self.out_h)).to(
            device=device, dtype=self.dtype)
        self.cols_t = torch.from_numpy(lanczos4_matrix(width, self.out_w).T
                                       .copy()).to(device=device, dtype=self.dtype)

    def _product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul != "tf32":
            return a @ b
        if self.device.type == "cuda":
            with _tf32_products():
                return a @ b
        return _tf32(a) @ _tf32(b)

    def frame(self, clip, index: int, frame_u8: np.ndarray) -> np.ndarray:
        s = self.settings
        x = common.dequantize(frame_u8, self.device, self.dtype)
        height, width = x.shape[0], x.shape[1]
        x = self._product(self.rows, x.reshape(height, width * 3))
        x = x.reshape(self.out_h, width, 3).permute(0, 2, 1).reshape(
            self.out_h * 3, width)
        x = self._product(x, self.cols_t)
        x = x.reshape(self.out_h, 3, self.out_w).permute(0, 2, 1)
        x = torch.clamp(x, 0.0, 1.0)
        if s.get("sharpen_enabled", True) and float(s["sharpen_strength"]) > 0:
            if not s.get("use_accelerator", True):
                raise NotImplementedError("the reference sharpens with a "
                                          "zero border only")
            x = common.unsharp_zero(x, float(s["sharpen_strength"]))
        if s.get("grain_enabled") and float(s["grain_intensity"]) > 0:
            noise = common.grain(self.out_h, self.out_w, int(s["seed"]),
                                 index, float(s["saturation_mix"]),
                                 self.device, self.dtype)
            x = torch.clamp(x + noise * float(s["grain_intensity"]), 0.0, 1.0)
        return common.quantize(x)
