"""LAB mean/std color transfer toward a reference image.

Counterpart of :mod:`vrgdg_tpu.ops.color_match`: both image and reference
go to CIELAB; per-channel spatial mean and unbiased (ddof=1) std with the
reference's 1e-5 floor offset; ``matched = (img - mu) / sigma * sigma_ref
+ mu_ref``, blended by ``match_strength``, back to RGB and clamped.  For
height-sharded frames the statistics come from float64 partial sums
reduced over the shards (:func:`lab_partials`,
:func:`statistics_from_partials`).
"""

from __future__ import annotations

import torch

from ..core.colorspace import lab_to_rgb, rgb_to_lab


def _mean_std(lab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # Frame by frame: on a card the summation order of a reduction depends
    # on how many outputs it has, so statistics of a batch would move in
    # their last bits with the batch size.  Reduced one frame at a time,
    # a frame's statistics, and so a frame-sharded grade, do not depend on
    # the batch it came in.
    means, stds = [], []
    for frame in lab:
        means.append(torch.mean(frame, dim=(0, 1), keepdim=True))
        var = torch.var(frame, dim=(0, 1), keepdim=True, correction=1)
        stds.append(torch.sqrt(var) + 1e-5)
    return torch.stack(means), torch.stack(stds)


def lab_statistics(rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image LAB channel ``(mean, std)`` over the spatial axes of a BHWC
    batch, each ``(B, 1, 1, 3)``; std is ddof=1 plus 1e-5."""
    return _mean_std(rgb_to_lab(rgb[..., :3]))


def lab_partials(rgb: torch.Tensor) -> torch.Tensor:
    """Per-frame float64 sums and sums of squares of the LAB channels of a
    BHWC batch, ``(B, 2, 3)``: what a height shard contributes to its
    frames' statistics (:func:`statistics_from_partials`)."""
    lab = rgb_to_lab(rgb[..., :3]).to(torch.float64)
    return torch.stack([lab.sum(dim=(1, 2)), (lab * lab).sum(dim=(1, 2))],
                       dim=1)


def statistics_from_partials(partials: torch.Tensor, pixels: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame LAB ``(mean, std)``, each ``(B, 1, 1, 3)`` float32, from
    the :func:`lab_partials` of a frame's ``pixels`` pixels summed over its
    shards; std is ddof=1 plus 1e-5, as :func:`lab_statistics`."""
    total, squares = partials[:, 0], partials[:, 1]
    mean = total / pixels
    var = (squares - total * mean) / (pixels - 1)
    std = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-5
    shape = (-1, 1, 1, 3)
    return (mean.to(torch.float32).reshape(shape),
            std.to(torch.float32).reshape(shape))


def transfer_lab_statistics(images: torch.Tensor, ref_mean: torch.Tensor,
                            ref_std: torch.Tensor,
                            match_strength, stats=None) -> torch.Tensor:
    """Re-target a BHWC batch onto precomputed reference LAB statistics;
    ``stats`` gives the batch's own per-frame ``(mean, std)`` where the
    frames are height shards (else they are taken from ``images``)."""
    lab = rgb_to_lab(images[..., :3])
    mean, std = _mean_std(lab) if stats is None else stats
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
