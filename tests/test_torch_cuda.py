"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither ``jax`` nor ``vrgdg_tpu``, so it also runs on a machine
without JAX, where ``tests/conftest.py`` cannot load:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Bounds, as in chip_smoke.py: nvcc contracts a*b+c into FMAs and its
powf/cbrtf/logf differ from the plain ops' by an ulp or two.
"""

import os

import numpy as np
import pytest
import torch

from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.core.cube import parse_cube
from vrgdg_tpu_torch.kernels import grade_cuda as gc
from vrgdg_tpu_torch.ops.color_match import lab_statistics
from vrgdg_tpu_torch.ops.grade import prepare_operands

LUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "LUTS", "teal_orange.cube")
ADJUST = {"contrast": 12.0, "vignette": 20.0, "saturation": -10.0}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(device):
    reference = torch.rand((1, 32, 32, 3),
                           generator=torch.Generator().manual_seed(1))
    ref_stats = lab_statistics(reference.to(device))
    lut = parse_cube(LUT)
    config = appliers.grade_config(
        lut=lut, lut_strength=8.0, adjust=ADJUST, ref_stats=ref_stats,
        match_strength=0.7, sharpen_strength=1.5, grain_intensity=0.05,
        saturation_mix=0.5, seed=42, fused_mode="fused")
    return config, lut, ref_stats


@pytest.mark.cuda
def test_kernels_match_plain_versions():
    device = _card()
    config, lut, ref_stats = _config(device)
    operands = prepare_operands(config, lut=lut, ref_stats=ref_stats,
                                device=device)
    frames = torch.rand((2, 37, 250, 3),
                        generator=torch.Generator().manual_seed(4)).to(device)
    kw = dict(blend=0.8, match_strength=0.7, sharpen_strength=1.5,
              grain_intensity=0.05, saturation_mix=0.5,
              adjust=config.adjust)
    gc.reset_launch_counts()
    got = gc.fused_post_gather(frames, *operands, 42, **kw)
    want = gc.fused_post_gather_plain(frames, *operands, 42, **kw)
    torch.cuda.synchronize()
    assert gc.LAUNCHES == {"grade_phase1": 1, "grade_phase2": 1}
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_main_path_on_card_matches_cpu():
    """The streamed uint8 main path, fused on the card, against the eager
    chain on the CPU: at most one level apart on at most 0.1% of values."""
    device = _card()
    config, lut, ref_stats = _config(device)
    u8 = np.random.default_rng(5).integers(0, 256, (5, 40, 70, 3), np.uint8)
    batches = [(0, u8[0:2]), (2, u8[2:4]), (4, u8[4:5])]
    fused = appliers.grade_effect(config, device, lut=lut,
                                  ref_stats=ref_stats)
    eager = appliers.grade_effect(
        appliers.grade_config(
            lut=lut, lut_strength=8.0, adjust=ADJUST,
            ref_stats=tuple(t.cpu() for t in ref_stats), match_strength=0.7,
            sharpen_strength=1.5, grain_intensity=0.05, saturation_mix=0.5,
            seed=42),
        "cpu", lut=lut, ref_stats=tuple(t.cpu() for t in ref_stats))
    got = np.concatenate(list(appliers.stream_graded_batches(
        batches, fused, batch_size=2, device=device)))
    want = np.concatenate(list(appliers.stream_graded_batches(
        batches, eager, batch_size=2, device="cpu")))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == u8.shape
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
