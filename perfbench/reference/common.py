"""Stages both references share: uint8 in and out, the 3x3 unsharp mask,
sRGB and CIELAB, and film grain keyed by Philox4x32-10.

Every function computes in the dtype of its input tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# uint8 frames
# --------------------------------------------------------------------------


def dequantize(frame_u8: np.ndarray, device, dtype) -> torch.Tensor:
    """``(H, W, 3)`` uint8 -> values / 255 in ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(frame_u8)).to(
        device=device, dtype=dtype) / 255.0


def quantize(frame: torch.Tensor) -> np.ndarray:
    """[0, 1] -> uint8 by truncation of ``x * 255``, as a cast does."""
    scaled = torch.clamp(frame.to(torch.float64) * 255.0, 0.0, 255.0)
    return torch.floor(scaled).to(torch.uint8).cpu().numpy()


# --------------------------------------------------------------------------
# unsharp mask: img + s * (img - mean of the 3x3 window), zero border
# --------------------------------------------------------------------------


def unsharp_zero(frame: torch.Tensor, strength: float) -> torch.Tensor:
    """``(H, W, 3)``; pixels outside the frame count as 0 and the window
    mean always divides by 9."""
    height, width = frame.shape[0], frame.shape[1]
    padded = F.pad(frame.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)
    total = torch.zeros_like(frame)
    for dy in range(3):
        for dx in range(3):
            total = total + padded[dy:dy + height, dx:dx + width]
    return torch.clamp(frame + strength * (frame - total / 9.0), 0.0, 1.0)


# --------------------------------------------------------------------------
# sRGB <-> CIELAB (D65, kornia's truncated constants)
# --------------------------------------------------------------------------

_RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                        [0.212671, 0.715160, 0.072169],
                        [0.019334, 0.119193, 0.950227]])
_XYZ_TO_RGB = np.linalg.inv(_RGB_TO_XYZ)
_WHITE = (0.95047, 1.0, 1.08883)
_EPSILON = 0.008856
_KAPPA = 7.787
_OFFSET = 4.0 / 29.0
_F_CUT = 0.2068966


def _mix3(rgb: torch.Tensor, matrix: np.ndarray) -> torch.Tensor:
    channels = [rgb[..., k] for k in range(3)]
    return torch.stack([sum(float(matrix[row, k]) * channels[k]
                            for k in range(3)) for row in range(3)], dim=-1)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    xyz = _mix3(linear, _RGB_TO_XYZ)
    t = torch.stack([xyz[..., k] / _WHITE[k] for k in range(3)], dim=-1)
    f = torch.where(t > _EPSILON, torch.clamp(t, min=0.0) ** (1.0 / 3.0),
                    _KAPPA * t + _OFFSET)
    return torch.stack([116.0 * f[..., 1] - 16.0,
                        500.0 * (f[..., 0] - f[..., 1]),
                        200.0 * (f[..., 1] - f[..., 2])], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """CIELAB -> sRGB clipped to [0, 1]; Z's f floored at 0 and linear
    RGB at 0 before the gamma, as kornia does."""
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = lab[..., 1] / 500.0 + fy
    fz = torch.clamp(fy - lab[..., 2] / 200.0, min=0.0)
    f = torch.stack([fx, fy, fz], dim=-1)
    t = torch.where(f > _F_CUT, f * f * f, (f - _OFFSET) / _KAPPA)
    xyz = torch.stack([t[..., k] * _WHITE[k] for k in range(3)], dim=-1)
    linear = torch.clamp(_mix3(xyz, _XYZ_TO_RGB), min=0.0)
    rgb = torch.where(linear > 0.0031308,
                      1.055 * linear ** (1.0 / 2.4) - 0.055, 12.92 * linear)
    return torch.clamp(rgb, 0.0, 1.0)


def lab_mean_std(lab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and std (``ddof=1``, plus the pack's 1e-5) over
    the pixels of one ``(H, W, 3)`` LAB image."""
    flat = lab.reshape(-1, 3)
    mean = flat.mean(dim=0)
    var = ((flat - mean) ** 2).sum(dim=0) / (flat.shape[0] - 1)
    return mean, torch.sqrt(var) + 1e-5


# --------------------------------------------------------------------------
# film grain: normal noise from Philox4x32-10 (Salmon et al., SC'11)
# --------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_CHANNEL_SCALE = (2.0, 1.0, 3.0)


def _mulhilo(a: torch.Tensor, multiplier: int):
    """High and low words of ``a * multiplier`` (``a`` < 2**32 in an
    int64 tensor), in 16-bit halves so no product leaves int64."""
    m_hi, m_lo = multiplier >> 16, multiplier & 0xFFFF
    low_part = a * m_lo
    high_part = a * m_hi
    lo = (((high_part & 0xFFFF) << 16) + low_part) & _MASK32
    hi = (high_part + (low_part >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key0: int, key1: int = 0):
    c0, c1, c2, c3 = counter
    k0, k1 = key0, key1
    for round_index in range(10):
        if round_index:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def grain(height: int, width: int, seed: int, frame_index: int,
          saturation_mix: float, device, dtype) -> torch.Tensor:
    """Unit-intensity grain ``(H, W, 3)`` of one frame: key
    ``((seed + frame) & 0x7FFFFFFF, 0)``, counter ``(y * W + x, 0, 0, 0)``;
    uniforms ``((bits >> 8) + 1) / 2**24``; Box-Muller gives R, G, B;
    R and B scaled by 2 and 3, then mixed toward the unscaled G."""
    key = (int(seed) + int(frame_index)) & 0x7FFFFFFF
    pixel = torch.arange(height * width, dtype=torch.int64, device=device)
    zero = torch.zeros_like(pixel)
    bits = philox4x32_10((pixel, zero, zero, zero), key)
    u0, u1, u2, u3 = (((b >> 8) + 1).to(dtype) * 2.0 ** -24 for b in bits)
    r0 = torch.sqrt(-2.0 * torch.log(u0))
    r1 = torch.sqrt(-2.0 * torch.log(u2))
    noise = torch.stack([r0 * torch.cos(2.0 * np.pi * u1),
                         r0 * torch.sin(2.0 * np.pi * u1),
                         r1 * torch.cos(2.0 * np.pi * u3)], dim=-1)
    scale = torch.tensor(_CHANNEL_SCALE, dtype=dtype, device=device)
    mixed = (saturation_mix * noise * scale
             + (1.0 - saturation_mix) * noise[:, 1:2])
    return mixed.reshape(height, width, 3)
