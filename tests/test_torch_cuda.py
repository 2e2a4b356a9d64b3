"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither ``jax`` nor ``vrgdg_tpu``, so it also runs on a machine
without JAX, where ``tests/conftest.py`` cannot load:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Bounds, as in chip_smoke.py: nvcc contracts a*b+c into FMAs and its
powf/cbrtf/logf differ from the plain ops' by an ulp or two.  The layouts
compute the same numbers as the flat path, so they are held to the same
bounds against it.
"""

import os

import numpy as np
import pytest
import torch

from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.core.cube import parse_cube
from vrgdg_tpu_torch.kernels import grade_cuda as gc
from vrgdg_tpu_torch.kernels import grain_cuda, probe_cuda
from vrgdg_tpu_torch.ops.color_match import lab_statistics
from vrgdg_tpu_torch.ops.grade import prepare_operands
from vrgdg_tpu_torch.ops.grain import film_grain

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
    assert gc.LAUNCHES == {"grade_phase1": 1, "grade_phase2": 1,
                           "grade_phase1_planes": 0,
                           "grade_phase2_planes": 0, "film_grain": 0,
                           "weighted_row_sum": 0}
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 250, 3), (1, 9, 33, 3)])
def test_planes_kernels_match_plain_versions(shape):
    device = _card()
    config, lut, ref_stats = _config(device)
    bundle, dmin, dmax, ref_mean, ref_std = prepare_operands(
        config, lut=lut, ref_stats=ref_stats, device=device)
    frames = torch.rand(shape, generator=torch.Generator().manual_seed(6)).to(
        device)
    domain = gc.lut_domain(dmin, dmax)
    src_planes = frames.permute(3, 0, 1, 2).contiguous()
    planes = gc.corner_planes(src_planes, bundle, domain)
    size = round(bundle.shape[0] ** (1 / 3))
    gc.reset_launch_counts()
    lab_k, part_k = gc.phase1_planes(src_planes, planes, domain, blend=0.8,
                                     lut_size=size)
    lab_p, part_p = gc.phase1_planes_plain(src_planes, planes, domain,
                                           blend=0.8, lut_size=size)
    lab_f, _ = gc.phase1_plain(frames, bundle, domain, blend=0.8)
    assert float((lab_k - lab_p).abs().max()) <= 5e-4
    assert torch.equal(lab_p, lab_f.permute(0, 3, 1, 2))
    coeff, coeff_k = (gc.stats_barrier(p, shape[1] * shape[2], ref_mean,
                                       ref_std, 0.7) for p in (part_p, part_k))
    assert float((coeff_k - coeff).abs().max()) <= 1e-5
    kw = dict(sharpen_strength=1.5, grain_intensity=0.05, saturation_mix=0.5,
              seed_base=42)
    rgb_k = gc.phase2_planes(lab_p, coeff, **kw)
    rgb_p = gc.phase2_planes_plain(lab_p, coeff, **kw)
    torch.cuda.synchronize()
    assert float((rgb_k - rgb_p).abs().max()) <= 5e-5
    assert gc.LAUNCHES["grade_phase1_planes"] == 1
    assert gc.LAUNCHES["grade_phase2_planes"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("grain", [0.0, 0.05])
def test_layouts_agree_with_flat_on_card(grain):
    device = _card()
    config, lut, ref_stats = _config(device)
    operands = prepare_operands(config, lut=lut, ref_stats=ref_stats,
                                device=device)
    frames = torch.rand((2, 37, 250, 3),
                        generator=torch.Generator().manual_seed(7)).to(device)
    kw = dict(blend=0.8, match_strength=0.7, sharpen_strength=1.5,
              grain_intensity=grain, saturation_mix=0.5)
    flat = gc.fused_post_gather(frames, *operands, 42, **kw)
    bound = 2e-5 if grain == 0.0 else 5e-5
    for layout in ("rowmajor", "plane"):
        got = gc.fused_post_gather(frames, *operands, 42, layout=layout, **kw)
        assert float((got - flat).abs().max()) <= bound, layout
    planes = gc.fused_post_gather(frames, *operands, 42, layout="plane",
                                  emit="planes", **kw)
    assert float((planes - flat.permute(0, 3, 1, 2)).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 250, 3), (2, 16, 20, 4)])
def test_grain_kernel_matches_film_grain(shape):
    device = _card()
    frames = torch.rand(shape, generator=torch.Generator().manual_seed(8)).to(
        device)
    gc.reset_launch_counts()
    got = grain_cuda.film_grain_kernel(frames, 0.05, 0.5, 42, frame_start=5)
    want = film_grain(frames, 0.05, 0.5, 42, frame_start=5)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["film_grain"] == 1
    assert float((got - want).abs().max()) <= 5e-5
    assert torch.equal(got[..., 3:], frames[..., 3:])
    split = torch.cat([
        grain_cuda.film_grain_kernel(frames[:1], 0.05, 0.5, 42, 5),
        grain_cuda.film_grain_kernel(frames[1:], 0.05, 0.5, 42, 6)])
    assert torch.equal(got, split)
    zero = grain_cuda.film_grain_kernel(frames * 1.5, 0.0, 0.5, 42)
    assert torch.equal(zero[..., :3], torch.clamp(frames[..., :3] * 1.5, 0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 1000, 1])
def test_weighted_row_sum_matches_plain(rows):
    device = _card()
    g = torch.rand((rows, 24), generator=torch.Generator().manual_seed(9)).to(
        device) * 2 - 1
    gc.reset_launch_counts()
    got = probe_cuda.weighted_row_sum(g)
    want = probe_cuda.weighted_row_sum_plain(g)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["weighted_row_sum"] == 1
    assert got.shape == (rows,)
    assert float((got - want).abs().max()) <= 1e-4


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
