"""LAB mean/std color transfer toward a reference image.

Counterpart of :mod:`vrgdg_tpu.ops.color_match`: both image and reference
go to CIELAB; per-channel spatial mean and unbiased (ddof=1) std with the
reference's 1e-5 floor offset; ``matched = (img - mu) / sigma * sigma_ref
+ mu_ref``, blended by ``match_strength``, back to RGB and clamped.
"""

from __future__ import annotations

import torch

from ..core.colorspace import lab_to_rgb, rgb_to_lab


def _mean_std(lab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mean = torch.mean(lab, dim=(1, 2), keepdim=True)
    var = torch.var(lab, dim=(1, 2), keepdim=True, correction=1)
    return mean, torch.sqrt(var) + 1e-5


def lab_statistics(rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image LAB channel ``(mean, std)`` over the spatial axes of a BHWC
    batch, each ``(B, 1, 1, 3)``; std is ddof=1 plus 1e-5."""
    return _mean_std(rgb_to_lab(rgb[..., :3]))


def transfer_lab_statistics(images: torch.Tensor, ref_mean: torch.Tensor,
                            ref_std: torch.Tensor,
                            match_strength) -> torch.Tensor:
    """Re-target a BHWC batch onto precomputed reference LAB statistics."""
    lab = rgb_to_lab(images[..., :3])
    mean, std = _mean_std(lab)
    matched = (lab - mean) / std * ref_std + ref_mean
    blended = match_strength * matched + (1.0 - match_strength) * lab
    rgb = torch.clamp(lab_to_rgb(blended), 0.0, 1.0).to(images.dtype)
    if images.shape[-1] > 3:
        out = images.clone()
        out[..., :3] = rgb
        return out
    return rgb


def color_match(images: torch.Tensor, reference: torch.Tensor,
                match_strength=1.0) -> torch.Tensor:
    """Match a BHWC batch's color tone to a reference image batch (a
    single-frame reference broadcasts across the batch)."""
    ref_mean, ref_std = lab_statistics(reference)
    return transfer_lab_statistics(images, ref_mean, ref_std, match_strength)
