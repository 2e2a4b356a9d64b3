"""Film grain synthesis on one counter-based stream.

Reference math (same as :mod:`vrgdg_tpu.ops.grain`): per-pixel standard
normal noise, red scaled by 2.0 and blue by 3.0, desaturated toward the
unscaled green noise by ``1 - saturation_mix``, then
``clamp(img + grain * intensity, 0, 1)``.

**The stream.**  Every grain in this package, the eager :func:`film_grain`
and the fused phase-2 CUDA kernel (``kernels/csrc/grade.cu``) alike, draws
from Philox4x32-10:

- key ``((seed + absolute_frame_index) & 0x7FFFFFFF, 0)``;
- counter ``(y * W + x, 0, 0, 0)`` for the pixel at row ``y``, column
  ``x`` of a ``W``-wide frame;
- the four 32-bit outputs become uniforms in (0, 1] as
  ``((bits >> 8) + 1) * 2^-24``, so ``log`` never sees 0;
- Box-Muller: ``r0 = sqrt(-2 ln u0)``, ``r1 = sqrt(-2 ln u2)``; the noise
  is ``(r0 cos 2πu1, r0 sin 2πu1, r1 cos 2πu3)`` for R, G, B;
- channel scale ``(2, 1, 3)``, gray = the unscaled green noise,
  ``grain = mix * (noise * scale) + (1 - mix) * gray``.

Noise depends only on the seed, the absolute frame index and the pixel,
so batch boundaries never show: the determinism contract of the reference
(``vrgdg_tpu/ops/grain.py:8-16``).  The counter is the pixel's index in
the whole frame, so a height shard (``row_start``) draws the rows of the
whole frame's noise that it owns, and height boundaries do not show
either.  The eager and fused paths draw the same
numbers, so they agree with grain on.  Against the JAX package the parity
is distributional: threefry and the TPU's hardware PRNG are other streams.

Philox needs the high 32 bits of a 32x32-bit product.  The plain version
here keeps every word in an int64 tensor and splits the multiplier into
16-bit limbs, so no product leaves the signed 64-bit range on the CPU or
the card.
"""

from __future__ import annotations

import torch

SEED_MASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586
_CHANNEL_SCALE = (2.0, 1.0, 3.0)


def _mulhilo(a: torch.Tensor, multiplier: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``a * multiplier`` for int64 ``a`` < 2^32."""
    m_hi, m_lo = multiplier >> 16, multiplier & 0xFFFF
    p_lo = a * m_lo                                  # < 2^48
    p_hi = a * m_hi                                  # < 2^48
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key0, key1=0):
    """Philox4x32-10 on int64 tensors holding uint32 words.

    ``counter`` is four broadcastable tensors, ``key0``/``key1`` tensors or
    ints; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0 = key0
    k1 = key1
    for round_index in range(10):
        if round_index:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8) + 1).to(torch.float32) * 2.0 ** -24


def grain_noise(frame_indices, height: int, width: int, seed: int,
                device, row_start: int = 0) -> torch.Tensor:
    """Unit normal noise ``(B, H, W, 3)`` for absolute frame indices: the
    rows ``[row_start, row_start + height)`` of ``width``-wide frames."""
    index = torch.as_tensor(frame_indices, dtype=torch.int64, device=device)
    keys = ((index + int(seed)) & SEED_MASK).reshape(-1, 1)
    first = int(row_start) * width
    pixel = torch.arange(first, first + height * width, dtype=torch.int64,
                         device=device).reshape(1, -1)
    zero = torch.zeros_like(pixel)
    bits = philox4x32_10((pixel, zero, zero, zero), keys)
    u0, u1, u2, u3 = (_uniform(b) for b in bits)
    r0 = torch.sqrt(-2.0 * torch.log(u0))
    r1 = torch.sqrt(-2.0 * torch.log(u2))
    t0 = _TWO_PI * u1
    noise = torch.stack([r0 * torch.cos(t0), r0 * torch.sin(t0),
                         r1 * torch.cos(_TWO_PI * u3)], dim=-1)
    return noise.reshape(-1, height, width, 3)


def grain_field(frame_indices, height: int, width: int, saturation_mix,
                seed, device, row_start: int = 0) -> torch.Tensor:
    """Channel-scaled, desaturated unit-intensity grain ``(B, H, W, 3)``
    (rows from ``row_start`` on, as :func:`grain_noise`)."""
    noise = grain_noise(frame_indices, height, width, seed, device,
                        row_start)
    scale = torch.tensor(_CHANNEL_SCALE, dtype=torch.float32, device=device)
    gray = noise[..., 1:2]
    return saturation_mix * (noise * scale) + (1.0 - saturation_mix) * gray


def check_rows(row_start: int, height: int, frame_height) -> int:
    """``frame_height`` (``row_start + height`` when ``None``), after
    checking that rows ``[row_start, row_start + height)`` lie in it."""
    row_start = int(row_start)
    frame_height = row_start + height if frame_height is None \
        else int(frame_height)
    if row_start < 0 or row_start + height > frame_height:
        raise ValueError(f"rows [{row_start}, {row_start + height}) do not "
                         f"lie in a frame {frame_height} rows tall")
    return frame_height


def film_grain(frames: torch.Tensor, intensity, saturation_mix, seed,
               frame_start: int = 0, row_start: int = 0,
               frame_height: int | None = None) -> torch.Tensor:
    """Apply seeded film grain to a BHWC [0,1] batch.

    ``frame_start`` is the absolute index of ``frames[0]`` within the clip;
    consecutive chunks with matching ``frame_start`` values give the same
    output as the whole clip at once.  Likewise ``frames`` may be the rows
    ``[row_start, row_start + H)`` of frames ``frame_height`` rows tall (a
    height shard): it then gets those rows of the whole frames' grain."""
    batch, height, width = frames.shape[0], frames.shape[1], frames.shape[2]
    check_rows(row_start, height, frame_height)
    indices = int(frame_start) + torch.arange(batch, dtype=torch.int64)
    grain = grain_field(indices, height, width, saturation_mix, seed,
                        frames.device, row_start)
    if frames.shape[-1] > 3:
        out = frames.clone()
        out[..., :3] = torch.clamp(frames[..., :3] + grain * intensity, 0.0, 1.0)
        return out
    return torch.clamp(frames + grain * intensity, 0.0, 1.0)
