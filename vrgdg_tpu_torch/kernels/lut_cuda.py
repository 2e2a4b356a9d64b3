"""Apply LUT on the card: the ``lut_apply`` CUDA kernel and its wrapper.

``lut_apply`` (``csrc/lut.cu``) replaces no Pallas kernel: it implements
:func:`vrgdg_tpu_torch.ops.lut.apply_lut_bundle`, whose JAX counterpart
(``vrgdg_tpu/ops/lut.py::apply_lut_bundle``) is left to XLA's gather.  Its
plain version is :func:`~vrgdg_tpu_torch.ops.lut.apply_lut_bundle_plain`,
and the two agree bit for bit: the same coordinates, the same bundle row,
the same float64-summed lerps, the same blend factor.
:func:`~vrgdg_tpu_torch.ops.lut.apply_lut_bundle` calls :func:`lut_apply`
for CUDA frames, which launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

ROW = 24     # floats in a corner-bundle row: 8 corners x rgb


def blend_factor(strength) -> float:
    """The strength blend of ``ops/lut.py::_finish``: the strength rounded
    to float32, clamped to [0, 10], divided by 10 in float32."""
    clamped = np.clip(np.float32(float(strength)), np.float32(0.0),
                      np.float32(10.0))
    return float(clamped / np.float32(10.0))


def lut_size(bundle: torch.Tensor) -> int:
    """N of an ``(N^3, 24)`` corner bundle, N >= 2; raises on any other
    shape."""
    if bundle.ndim != 2 or bundle.shape[1] != ROW:
        raise ValueError(f"bundle must be (N^3, {ROW}), got "
                         f"{tuple(bundle.shape)}")
    size = round(bundle.shape[0] ** (1.0 / 3.0))
    if size < 2 or size ** 3 != bundle.shape[0]:
        raise ValueError(f"bundle rows {bundle.shape[0]} are not N^3 with "
                         "N >= 2")
    return size


def _domain(value, device, default: float) -> torch.Tensor:
    """Three float32 values on ``device``; a device tensor is read where
    it lies, so reading it costs the host no synchronise."""
    if value is None:
        return torch.full((3,), default, dtype=torch.float32, device=device)
    if (isinstance(value, torch.Tensor) and value.shape == (3,)
            and value.dtype == torch.float32 and value.device == device
            and value.is_contiguous()):
        return value      # prepare_operands' domain, on every batch
    tensor = torch.as_tensor(value, dtype=torch.float32, device=device)
    return torch.broadcast_to(tensor, (3,)).contiguous()


def lut_apply(frames: torch.Tensor, bundle: torch.Tensor, domain_min=None,
              domain_max=None, strength: float = 10.0) -> torch.Tensor:
    """``apply_lut_bundle`` on a ``(..., C>=3)`` float batch on the card;
    returns a new tensor of the frames' shape and dtype.

    A float32 batch runs as it is (made contiguous first), channels past
    the third copied by the kernel; another float dtype has its rgb cast to
    float32 and the result cast back, as the plain version does."""
    if not frames.is_floating_point():
        raise ValueError(f"frames must be floating point, got {frames.dtype}")
    if frames.ndim < 1 or frames.shape[-1] < 3:
        raise ValueError(f"frames must be (..., C>=3), got "
                         f"{tuple(frames.shape)}")
    size = lut_size(bundle)
    if bundle.dtype != torch.float32:
        raise ValueError(f"bundle must be float32, got {bundle.dtype}")
    if bundle.device != frames.device:
        raise ValueError(f"frames on {frames.device} but bundle on "
                         f"{bundle.device}")
    device = frames.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if frames.dtype != torch.float32:
        mixed = lut_apply(frames[..., :3].to(torch.float32), bundle,
                          domain_min, domain_max, strength).to(frames.dtype)
        if frames.shape[-1] == 3:
            return mixed
        out = frames.clone()
        out[..., :3] = mixed
        return out
    frames = frames.contiguous()
    if not bundle.is_contiguous() or bundle.data_ptr() % 16:
        bundle = bundle.clone(memory_format=torch.contiguous_format)
    dmin = _domain(domain_min, device, 0.0)
    dmax = _domain(domain_max, device, 1.0)
    out = torch.empty_like(frames)
    if out.numel() == 0:
        return out
    channels = frames.shape[-1]
    lib = build.library("lut")
    code = lib.vrgdg_lut_apply(
        device.index, frames.data_ptr(), frames.numel() // channels,
        channels, bundle.data_ptr(), size, dmin.data_ptr(), dmax.data_ptr(),
        blend_factor(strength), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(lib, code, "lut_apply")
    return out
