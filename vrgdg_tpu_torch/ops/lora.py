"""LoRA weight merging over flat parameter mappings.

Counterpart of :mod:`vrgdg_tpu.ops.lora`: each low-rank pair folds into
its target weight as ``W + strength * (alpha / rank) * up @ down``, over a
flat ``{name: tensor}`` mapping, on the weights' device.  The fold
``up @ down`` runs in IEEE float32 whatever the process's TF32 setting
(:func:`vrgdg_tpu_torch.ops.resize._ieee_fp32_matmul`), as the original
runs it at ``Precision.HIGHEST``: TF32 would put about 1e-3 of relative
error into every merged weight.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .resize import _ieee_fp32_matmul

__all__ = ["merge_lora", "apply_lora_plan"]


def _delta(weight: torch.Tensor, down, up, alpha, strength) -> torch.Tensor:
    """``strength * (alpha / rank) * up @ down`` shaped like ``weight``.

    ``down`` is ``(rank, fan_in...)`` flattened to 2-D, ``up`` is
    ``(fan_out..., rank)``; conv-style weights merge through the same
    2-D product reshaped back (the standard safetensors LoRA layout).
    ``alpha=None`` means ``alpha == rank`` (scale 1), the common
    trainer default.
    """
    down2 = torch.as_tensor(down).to(device=weight.device,
                                     dtype=torch.float32)
    up2 = torch.as_tensor(up).to(device=weight.device, dtype=torch.float32)
    rank = down2.shape[0]
    if up2.shape[-1] != rank:
        raise ValueError(
            f"rank mismatch: down rank {rank} vs up rank {up2.shape[-1]}")
    down2 = down2.reshape(rank, -1)
    up2 = up2.reshape(-1, rank)
    scale = float(strength) * (
        1.0 if alpha is None else float(alpha) / float(rank))
    with _ieee_fp32_matmul():
        delta = (up2 @ down2) * scale
    if delta.numel() != weight.numel():
        raise ValueError(
            f"LoRA pair produces {tuple(delta.shape)} for weight "
            f"{tuple(weight.shape)}")
    return delta.reshape(weight.shape)


def merge_lora(params: Mapping[str, torch.Tensor],
               lora: Mapping[str, Mapping],
               strength: float) -> dict:
    """Fold one LoRA into ``params`` at ``strength``.

    ``lora`` maps a parameter name to ``{"down", "up", "alpha"}``;
    names absent from ``params`` raise (a silently dropped pair is the
    classic wrong-key LoRA bug).  ``strength == 0`` returns the input
    mapping unchanged, mirroring the reference loaders' zero-strength
    skip.
    """
    if float(strength) == 0.0 or not lora:
        return dict(params)
    missing = sorted(set(lora) - set(params))
    if missing:
        raise KeyError(f"LoRA targets absent from params: {missing}")
    merged = dict(params)
    for name, pair in lora.items():
        weight = torch.as_tensor(merged[name])
        delta = _delta(weight, pair["down"], pair["up"],
                       pair.get("alpha"), strength)
        merged[name] = (weight.to(torch.float32) + delta).to(weight.dtype)
    return merged


def apply_lora_plan(params: Mapping[str, torch.Tensor],
                    plan: Mapping,
                    load_lora) -> dict:
    """Apply a ``multi_lora_plan`` / ``two_pass_lora_plan`` result to a
    parameter mapping.

    ``load_lora(name)`` resolves a plan entry's LoRA name to its
    ``{param: {down, up, alpha}}`` tensors (file loading stays with the
    caller).  Returns ``{"first_pass", "second_pass"}`` merged mappings; a
    passthrough plan returns the input mapping for both, like the
    reference's unpatched-model fast path.
    """
    if plan.get("passthrough"):
        base = dict(params)
        return {"first_pass": base, "second_pass": dict(params)}
    out = {}
    for key in ("first_pass", "second_pass"):
        merged = dict(params)
        for name, strength in plan[key]:
            merged = merge_lora(merged, load_lora(name), strength)
        out[key] = merged
    return out
