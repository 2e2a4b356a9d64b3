"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither ``jax`` nor ``vrgdg_tpu``, so it also runs on a machine
without JAX, where ``tests/conftest.py`` cannot load:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Bounds, as in chip_smoke.py: nvcc contracts a*b+c into FMAs and its
powf/cbrtf/logf differ from the plain ops' by an ulp or two.  The layouts
compute the same numbers as the flat path, so they are held to the same
bounds against it.  The colour-match coefficients follow one rule at every
frame size (:func:`_check_coefficients`).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.core.cube import parse_cube
from vrgdg_tpu_torch.core.params import EnhancerSettings
from vrgdg_tpu_torch.jobs import enhancer
from vrgdg_tpu_torch.kernels import grade_cuda as gc
from vrgdg_tpu_torch.kernels import grain_cuda, probe_cuda
from vrgdg_tpu_torch.ops.color_match import lab_statistics
from vrgdg_tpu_torch.ops.grade import prepare_operands
from vrgdg_tpu_torch.ops.grain import film_grain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT = os.path.join(REPO, "LUTS", "teal_orange.cube")
ADJUST = {"contrast": 12.0, "vignette": 20.0, "saturation": -10.0}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _smoke():
    """chip_smoke.py, loaded by path: the phases' checks live there."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _check_partials(lab: torch.Tensor, partials: torch.Tensor) -> None:
    """Each frame's partials are the float64 chunk sums (and sums of
    squares) of the kernel's own BHWC LAB (``chip_smoke.partials_err``)."""
    _smoke().partials_err(lab, partials)


def _check_coefficients(lab_k, lab_p, coeff_k, coeff_p, ref_stats,
                        strength=0.7) -> None:
    """The A/B coefficients within the change the two LABs' statistics
    make in them (``chip_smoke.coefficients_err``)."""
    _smoke().coefficients_err(lab_k, lab_p, coeff_k, coeff_p, ref_stats[1],
                              strength)


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
                           "weighted_row_sum": 0, "lut_apply": 0,
                           "enhance_step": 0}
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1079, 1917), (3, 37, 250), (1, 9, 33),
                                   (1, 1, 5)])
def test_phases_match_plain_versions(shape):
    """Frames whose starts are not 16-byte aligned (H*W*3 % 4 != 0 from
    frame 1 on), and frames smaller than a phase-1 chunk or a phase-2 tile:
    each phase against its plain version at the smoke's bounds."""
    device = _card()
    config, lut, ref_stats = _config(device)
    bundle, dmin, dmax, ref_mean, ref_std = prepare_operands(
        config, lut=lut, ref_stats=ref_stats, device=device)
    domain = gc.lut_domain(dmin, dmax)
    frames = torch.rand((*shape, 3),
                        generator=torch.Generator().manual_seed(14)).to(device)
    gc.reset_launch_counts()
    lab_k, part_k = gc.phase1(frames, bundle, domain, blend=0.8,
                              adjust=config.adjust)
    lab_p, part_p = gc.phase1_plain(frames, bundle, domain, blend=0.8,
                                    adjust=config.adjust)
    assert part_k.shape == part_p.shape
    assert float((lab_k - lab_p).abs().max()) <= 5e-4
    _check_partials(lab_k, part_k)
    pixels = shape[1] * shape[2]
    coeff_k, coeff_p = (gc.stats_barrier(p, pixels, ref_mean, ref_std, 0.7)
                        for p in (part_k, part_p))
    _check_coefficients(lab_k, lab_p, coeff_k, coeff_p, ref_stats)
    for grain, bound in ((0.0, 2e-5), (0.05, 5e-5)):
        kw = dict(sharpen_strength=1.5, grain_intensity=grain,
                  saturation_mix=0.5, seed_base=42)
        rgb_k = gc.phase2(lab_p, coeff_p, **kw)
        rgb_p = gc.phase2_plain(lab_p, coeff_p, **kw)
        torch.cuda.synchronize()
        assert float((rgb_k - rgb_p).abs().max()) <= bound, grain
    assert gc.LAUNCHES["grade_phase1"] == 1
    assert gc.LAUNCHES["grade_phase2"] == 2


@pytest.mark.cuda
def test_phases_batch_split_is_bit_identical_on_card():
    """Frames 1..2 of a batch of 3 against the same frames as a batch of
    their own (a misaligned slice and a contiguous copy): the same LAB,
    partials and phase-2 output bits."""
    device = _card()
    config, lut, ref_stats = _config(device)
    bundle, dmin, dmax, ref_mean, ref_std = prepare_operands(
        config, lut=lut, ref_stats=ref_stats, device=device)
    domain = gc.lut_domain(dmin, dmax)
    frames = torch.rand((3, 1079, 1917, 3),
                        generator=torch.Generator().manual_seed(15)).to(device)
    lab, part = gc.phase1(frames, bundle, domain, blend=0.8,
                          adjust=config.adjust)
    for tail in (frames[1:], frames[1:].contiguous().clone()):
        lab_t, part_t = gc.phase1(tail, bundle, domain, blend=0.8,
                                  adjust=config.adjust)
        assert torch.equal(lab_t, lab[1:]) and torch.equal(part_t, part[1:])
    coeff = gc.stats_barrier(part, 1079 * 1917, ref_mean, ref_std, 0.7)
    kw = dict(sharpen_strength=1.5, grain_intensity=0.05, saturation_mix=0.5)
    whole = gc.phase2(lab, coeff, seed_base=42, **kw)
    tail = gc.phase2(lab[1:], coeff[1:].contiguous(), seed_base=43, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tail, whole[1:])


# the flat phases' shapes (misaligned frame starts, frames smaller than a
# tile) and a frame that ends partway through a second 64-row phase-2 tile
PLANES_SHAPES = [(2, 1079, 1917, 3), (3, 37, 250, 3), (1, 9, 33, 3),
                 (1, 1, 5, 3), (1, 70, 40, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLANES_SHAPES)
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
    _check_partials(lab_k.permute(0, 2, 3, 1), part_k)
    _check_coefficients(lab_k.permute(0, 2, 3, 1), lab_p.permute(0, 2, 3, 1),
                        coeff_k, coeff, ref_stats)
    for grain, bound in ((0.0, 2e-5), (0.05, 5e-5)):
        kw = dict(sharpen_strength=1.5, grain_intensity=grain,
                  saturation_mix=0.5, seed_base=42)
        rgb_k = gc.phase2_planes(lab_p, coeff, **kw)
        rgb_p = gc.phase2_planes_plain(lab_p, coeff, **kw)
        torch.cuda.synchronize()
        assert float((rgb_k - rgb_p).abs().max()) <= bound, grain
    assert gc.LAUNCHES["grade_phase1_planes"] == 1
    assert gc.LAUNCHES["grade_phase2_planes"] == 2


def _phase2_operands(shape, seed):
    """Seeded LAB of phase 1's plain version on ``shape`` frames and the
    stats barrier's coefficients, on the card."""
    device = _card()
    config, lut, ref_stats = _config(device)
    bundle, dmin, dmax, ref_mean, ref_std = prepare_operands(
        config, lut=lut, ref_stats=ref_stats, device=device)
    frames = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    lab, partials = gc.phase1_plain(frames.to(device), bundle,
                                    gc.lut_domain(dmin, dmax), blend=0.8)
    coeff = gc.stats_barrier(partials, shape[1] * shape[2], ref_mean,
                             ref_std, 0.7)
    return lab, coeff


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLANES_SHAPES)
def test_phase2_planes_is_phase2_permuted_bit_for_bit(shape):
    """One phase-2 body for both layouts: grade_phase2_planes gives
    grade_phase2's bits on the same LAB, permuted, grain off and on."""
    lab, coeff = _phase2_operands(shape, 16)
    lab_planes = lab.permute(0, 3, 1, 2).contiguous()
    for grain in (0.0, 0.05):
        kw = dict(sharpen_strength=1.5, grain_intensity=grain,
                  saturation_mix=0.5, seed_base=42)
        planes = gc.phase2_planes(lab_planes, coeff, **kw)
        flat = gc.phase2(lab, coeff, **kw)
        torch.cuda.synchronize()
        assert torch.equal(planes, flat.permute(0, 3, 1, 2)), grain


@pytest.mark.cuda
def test_phase2_planes_batch_split_is_bit_identical_on_card():
    """Frames 1..2 of a batch of 3 as a batch of their own, keyed on
    seed_base + 1: the same phase-2 planes bits."""
    lab, coeff = _phase2_operands((3, 1079, 1917, 3), 17)
    lab_planes = lab.permute(0, 3, 1, 2).contiguous()
    kw = dict(sharpen_strength=1.5, grain_intensity=0.05, saturation_mix=0.5)
    whole = gc.phase2_planes(lab_planes, coeff, seed_base=42, **kw)
    tail = gc.phase2_planes(lab_planes[1:], coeff[1:].contiguous(),
                            seed_base=43, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tail, whole[1:])


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


# --------------------------------------------------------------------------
# the enhancer step: lanczos4 -> unsharp -> the film_grain kernel
# --------------------------------------------------------------------------

ENHANCE = EnhancerSettings.normalize({
    "upscale_resolution": "4k", "sharpen_strength": 1.0,
    "grain_enabled": True, "grain_intensity": 0.05, "seed": 42})


@pytest.mark.cuda
def test_enhance_step_on_card_matches_cpu():
    """uint8 in and out: at most one level apart on at most 0.1% of
    values (cuBLAS and the CPU sum the taps in other orders; the grain
    kernel agrees with the plain grain to ~6e-8)."""
    device = _card()
    u8 = np.random.default_rng(10).integers(0, 256, (3, 40, 70, 3), np.uint8)
    got = enhancer.apply_effects_batch(u8, ENHANCE, 90, 160, 2,
                                       device=device, as_uint8=True)
    want = enhancer.apply_effects_batch(u8, ENHANCE, 90, 160, 2,
                                        device="cpu", as_uint8=True)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape == (3, 90, 160, 3)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.cuda
def test_enhance_batch_split_is_bit_identical_on_card():
    device = _card()
    frames = np.random.default_rng(11).uniform(
        0, 1, (4, 36, 64, 3)).astype(np.float32)
    whole = enhancer.apply_effects_batch(frames, ENHANCE, 72, 128, 0,
                                         device=device)
    split = np.concatenate([
        enhancer.apply_effects_batch(frames[0:1], ENHANCE, 72, 128, 0,
                                     device=device),
        enhancer.apply_effects_batch(frames[1:4], ENHANCE, 72, 128, 1,
                                     device=device)])
    np.testing.assert_array_equal(whole, split)


@pytest.mark.cuda
def test_batch_streams_record_their_spans_on_the_card():
    """Under ``torch.profiler`` (CPU and CUDA) both streams record each
    batch's pinned staging, enqueue and wait, the fused phases and the
    enhance step's parts under the enqueue, and the ``vrgdg.*`` ranges
    land in the trace beside the device's work.  Each batch is staged one
    ahead on native threads, so its ``batch.stage`` is logged from the
    copy's own times with no range in the trace, and the stream's wait
    for it is the range ``vrgdg.batch.stage_wait``.  Both run their tail
    batch at its real length (no pad; the tail's enqueue counts the
    ``short_frames`` it lacks)."""
    from torch.profiler import ProfilerActivity, profile

    from vrgdg_tpu_torch.runtime.profiling import SPANS

    device = _card()
    config, lut, ref_stats = _config(device)
    effect = appliers.grade_effect(config, device, lut=lut,
                                   ref_stats=ref_stats)
    u8 = np.random.default_rng(13).integers(0, 256, (5, 40, 70, 3), np.uint8)
    batches = [(0, u8[0:2]), (2, u8[2:4]), (4, u8[4:5])]
    before = {record.id for record in SPANS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graded = list(appliers.stream_graded_batches(
            batches, effect, batch_size=2, device=device))
        enhancer.enhance_batches(batches, ENHANCE, 90, 160, device=device,
                                 batch_size=2, write=lambda out: None)
    assert sum(g.shape[0] for g in graded) == 5
    records = [r for r in SPANS if r.id not in before]
    streams = sorted({r.stream for r in records if r.name == "batch.enqueue"})
    assert len(streams) == 2
    names = {event.name for event in prof.events()}
    for stream in streams:
        mine = [r for r in records if r.stream == stream]
        by = {}
        for record in mine:
            by.setdefault(record.name, []).append(record)
        for name in ("batch.stage", "batch.stage_wait", "batch.enqueue",
                     "batch.wait"):
            assert [r.batch for r in by[name]] == [0, 1, 2], name
        assert all(r.parent is None for r in by["batch.stage"])
        enqueued = [r.counts for r in by["batch.enqueue"]]
        assert "batch.pad" not in by
        assert enqueued == [{"frames": 2}, {"frames": 2},
                            {"frames": 1, "short_frames": 1}]
        assert sum(c["frames"] for c in enqueued) == 5
        enqueues = {r.id for r in by["batch.enqueue"]}
        # the enhancer's uint8 batches run as one enhance_step launch
        children = (("grade.phase1", "grade.stats", "grade.phase2")
                    if "grade.phase1" in by else ("enhance.step",))
        for name in children:
            assert len(by[name]) == 3 and all(
                r.parent in enqueues for r in by[name]), name
            assert "vrgdg." + name in names
    assert {"vrgdg.batch.stage_wait", "vrgdg.batch.wait"} <= names


@pytest.mark.cuda
@pytest.mark.parametrize("height,width,batch", [(1080, 1920, 8),
                                                (2160, 3840, 2)])
def test_unpadded_tail_batches_match_batch_one_at_full_size(height, width,
                                                            batch):
    """Clips of the benchmark's six lengths (each ends in a 1-frame batch)
    through the fused stack at full size: every frame bit-identical to the
    same clip streamed one frame a batch, and each fused kernel launched
    once a batch."""
    device = _card()
    config, lut, ref_stats = _config(device)
    effect = appliers.grade_effect(config, device, lut=lut,
                                   ref_stats=ref_stats)
    rng = np.random.default_rng(14)
    pool = rng.integers(0, 256, (3 * batch, height, width, 3), np.uint8)
    for count in (33, 49, 81, 97, 121, 241):
        frames = [pool[i % len(pool)] for i in range(count)]
        batches = [(start, np.stack(frames[start:start + batch]))
                   for start in range(0, count, batch)]
        gc.reset_launch_counts()
        got = list(appliers.stream_graded_batches(
            batches, effect, batch_size=batch, device=device))
        launches = {name: gc.LAUNCHES[name]
                    for name in ("grade_phase1", "grade_phase2")}
        assert launches == dict.fromkeys(launches, len(batches)), count
        assert [g.shape[0] for g in got] == [b.shape[0] for _, b in batches]
        got = np.concatenate(got)
        singles = appliers.stream_graded_batches(
            [(i, frame[None]) for i, frame in enumerate(frames)], effect,
            batch_size=1, device=device)
        for i, single in enumerate(singles):
            assert np.array_equal(got[i], single[0]), (count, i)


@pytest.mark.cuda
def test_enhance_stream_launches_film_grain_once_per_batch():
    """The stream's uint8 batches run the whole step as one
    ``enhance_step`` launch a batch, which draws the grain itself:
    ``film_grain`` is not launched."""
    device = _card()
    u8 = np.random.default_rng(12).integers(0, 256, (5, 40, 70, 3), np.uint8)
    batches = [(0, u8[0:2]), (2, u8[2:4]), (4, u8[4:5])]
    written = []
    gc.reset_launch_counts()
    done, smallest = enhancer.enhance_batches(
        batches, ENHANCE, 90, 160, device=device, batch_size=2,
        write=written.append)
    assert gc.LAUNCHES["enhance_step"] == 3
    assert gc.LAUNCHES["film_grain"] == 0
    assert (done, smallest) == (5, 2)
    assert [w.shape for w in written] == [(2, 90, 160, 3), (2, 90, 160, 3),
                                          (1, 90, 160, 3)]


@pytest.mark.cuda
def test_cli_enhance_on_card(tmp_path):
    _card()
    cv2 = pytest.importorskip("cv2")
    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (64, 48))
    rng = np.random.default_rng(13)
    for _ in range(6):
        writer.write(rng.integers(0, 256, (48, 64, 3), np.uint8))
    writer.release()
    done = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "enhance", clip,
         "--settings", '{"upscale_resolution": "2k", "grain_enabled": true}',
         "--device", "cuda", "--output-root", str(tmp_path / "out")],
        capture_output=True, text=True, cwd=REPO, timeout=600, check=False,
        env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0, done.stderr[-2000:]
    final = json.loads(done.stdout)
    assert final["status"] == "complete" and final["device"] == "cuda"
    meta = final["output_metadata"]
    assert (meta["frame_count"], meta["width"], meta["height"]) == (6, 2560, 1920)


# --------------------------------------------------------------------------
# the still-image and compare surface
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_image_lut_and_compare_videos_on_card_match_cpu(tmp_path):
    """``apply_lut_to_image`` and ``compare_videos`` on the card against
    ``device="cpu"``, decoded: at most one level apart on at most 0.1% of
    values.  The clips use the selection modes: the card dequantizes by a
    reciprocal multiply, an ulp from the CPU's division, which the blend
    modes can carry across a level boundary and the lossy encode then
    spreads over a block (``chip_smoke.py`` holds the blend modes to the
    CPU in float32)."""
    _card()
    cv2 = pytest.importorskip("cv2")
    from vrgdg_tpu_torch.api import compare

    rng = np.random.default_rng(18)
    image = str(tmp_path / "frame.png")
    cv2.imwrite(image, rng.integers(0, 256, (270, 480, 3), np.uint8))
    clips = []
    for name, size in (("a.mp4", (96, 64)), ("b.mp4", (96, 64))):
        clips.append(str(tmp_path / name))
        writer = cv2.VideoWriter(clips[-1], cv2.VideoWriter_fourcc(*"mp4v"),
                                 12.0, size)
        for _ in range(10):
            writer.write(rng.integers(0, 256, (size[1], size[0], 3),
                                      np.uint8))
        writer.release()

    def decoded(path):
        capture = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            frames.append(frame)
        capture.release()
        return np.stack(frames).astype(np.int16)

    outputs = {}
    for device in ("cuda", "cpu"):
        outputs[device] = [cv2.imread(appliers.apply_lut_to_image(
            image, "teal_orange.cube", str(tmp_path / f"{device}.png"), 7.0,
            device=device)["output"]).astype(np.int16)]
        for mode in ("side_by_side", "blink"):
            result = compare.compare_videos(
                clips[0], clips[1], mode, str(tmp_path / f"{device}_{mode}.mp4"),
                blink_speed=3.0, batch_size=4, device=device)
            assert result["processed_frames"] == 10
            outputs[device].append(decoded(result["output"]))
    for got, want in zip(outputs["cuda"], outputs["cpu"]):
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.cuda
def test_eager_lut_on_card_is_bit_identical_to_cpu():
    """The lerps are float32 products and float64 sums rounded once, each
    its own torch op: no contraction, so the card gives the CPU's bits."""
    from vrgdg_tpu_torch.ops.lut import apply_lut, apply_lut_bundle
    from vrgdg_tpu_torch.core.cube import corner_bundle

    device = _card()
    lut = parse_cube(LUT)
    frames = torch.from_numpy(np.random.default_rng(5).random(
        (2, 67, 101, 4), np.float32))
    want = apply_lut(frames, lut, strength=7.0)
    assert torch.equal(apply_lut(frames.to(device), lut,
                                 strength=7.0).cpu(), want)
    bundle = torch.as_tensor(corner_bundle(lut.table))
    assert torch.equal(apply_lut_bundle(frames.to(device), bundle.to(device),
                                        lut.domain_min, lut.domain_max,
                                        7.0).cpu(), want)


@pytest.mark.cuda
def test_face_composites_on_card_match_cpu():
    """ellipse_composite (lanczos4, a feather wider than the box),
    radial_face_composite and paste_back on the card against the CPU."""
    import importlib

    pb = importlib.import_module("vrgdg_tpu_torch.ops.paste_back")
    device = _card()
    rng = np.random.default_rng(6)
    frame = torch.from_numpy(rng.random((3, 120, 160, 3), np.float32))
    crop = torch.from_numpy(rng.random((3, 64, 64, 3), np.float32))
    for feather in (6, 40):
        want = pb.ellipse_composite(frame[0], crop[0], (30, 20, 61, 51),
                                    feather)
        got = pb.ellipse_composite(frame[0].to(device), crop[0].to(device),
                                   (30, 20, 61, 51), feather)
        assert float((got.cpu() - want).abs().max()) <= 1e-5
    entries = [{"box": (10, 10, 90, 100), "strength": 1.0}, {"box": None},
               {"box": (50, 0, 160, 90), "strength": 0.5}]
    want = pb.radial_face_composite(crop, frame, entries)
    got = pb.radial_face_composite(crop.to(device), frame.to(device), entries)
    assert got[2] == want[2] == 2
    for a, b in zip(got[:2], want[:2]):
        assert float((a.cpu() - b).abs().max()) <= 1e-4
    data = ((160, 120), (40, 30, 120, 110))
    want = pb.paste_back(frame, crop[:1], data)
    got = pb.paste_back(frame.to(device), crop[:1].to(device), data)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_film_grain_height_shard_draws_the_whole_frames_rows():
    device = _card()
    frames = torch.rand((2, 70, 130, 3),
                        generator=torch.Generator().manual_seed(8)).to(device)
    whole = grain_cuda.film_grain_kernel(frames, 0.05, 0.5, 42,
                                         frame_start=4)
    for a, b in ((0, 33), (33, 70)):
        part = grain_cuda.film_grain_kernel(
            frames[:, a:b].contiguous(), 0.05, 0.5, 42, frame_start=4,
            row_start=a, frame_height=70)
        assert torch.equal(part, whole[:, a:b])
    with pytest.raises(ValueError, match="do not lie"):
        grain_cuda.film_grain_kernel(frames, 0.05, 0.5, 42, row_start=1,
                                     frame_height=70)


@pytest.mark.cuda
def test_grade_on_mesh_on_one_card():
    """Two mesh entries naming the card: the fused grade pads 3 frames to
    4, launches each phase once a shard and equals one device bit for
    bit; the eager stack height-sharded stays within 1e-5."""
    from vrgdg_tpu_torch.core.params import AdjustSettings
    from vrgdg_tpu_torch.ops.grade import grade
    from vrgdg_tpu_torch.parallel import grade_on_mesh, make_mesh

    device = _card()
    config, lut, ref_stats = _config(device)
    frames = torch.rand((3, 64, 96, 3),
                        generator=torch.Generator().manual_seed(9)).to(device)
    mesh = make_mesh(devices=[device] * 2)
    gc.reset_launch_counts()
    sharded = grade_on_mesh(frames, config, mesh, lut=lut,
                            ref_stats=ref_stats, frame_start=2)
    torch.cuda.synchronize()
    assert (gc.LAUNCHES["grade_phase1"], gc.LAUNCHES["grade_phase2"]) == (2, 2)
    assert torch.equal(sharded, grade(frames, config, lut=lut,
                                      ref_stats=ref_stats, frame_start=2))
    eager = dataclasses.replace(
        config, fused_mode="eager",
        adjust=AdjustSettings.normalize({**ADJUST, "clarity": 30,
                                         "sharpen": 10}))
    single = grade(frames, eager, lut=lut, ref_stats=ref_stats)
    spatial = grade_on_mesh(frames, eager,
                            make_mesh(devices=[device] * 2, spatial=2),
                            lut=lut, ref_stats=ref_stats, spatial=True)
    assert float((spatial - single).abs().max()) <= 1e-5
    assert torch.equal(grade_on_mesh(frames, eager, mesh, lut=lut,
                                     ref_stats=ref_stats), single)


@pytest.mark.cuda
def test_bench_runs_small_on_the_card():
    """``vrgdg_tpu_torch.bench.run`` at 2 steps a chain: every config and
    stage measured, the fused configs launching both grade kernels, the
    eager configs with a LUT launching ``lut_apply``, the kernel-grain
    config and the enhance step launching ``film_grain`` (its
    CPU twin is ``tests/test_torch_bench.py``, which needs JAX)."""
    from vrgdg_tpu_torch import bench

    result = bench.run(_card(), steps=2, oracle=False)
    configs = result["configs"]
    assert set(configs) == {name for name, *_ in bench.CONFIGS} | {
        "enhance_step_1080p_to_4k"}
    assert all(c["fps"] > 0 and c["device_ms_per_frame"] > 0
               for c in configs.values())
    for name in ("fused_4k_pallas2", "fused_4k_pallas2_adjust"):
        assert configs[name]["mode"] == bench.FUSED_MODE
        assert configs[name]["launches"]["grade_phase1"] > 0
        assert configs[name]["launches"]["grade_phase2"] > 0
    for name in ("fused_4k_pallas_grain", "enhance_step_1080p_to_4k"):
        assert configs[name]["launches"]["film_grain"] > 0
    for name in ("lut_1080p", "fused_4k", "fused_4k_pallas_grain"):
        assert configs[name]["launches"]["lut_apply"] > 0
        assert "lut_apply" in configs[name]["mode"]
    assert set(result["stage_ms_per_4k_frame"]) == set(bench.STAGES)
    assert result["device"]["name"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_lut_stream_on_card_matches_cpu_and_times_its_lut_stage():
    """Apply LUT's stream (``_lut_effect`` through ``stream_graded_batches``
    at batch 8, depth 2) on a 17-frame 1080p clip: from the card's
    dequantized frames the CPU gives the card's bits (the eager LUT's
    lerps are float64 sums rounded once, each its own op), and the CPU's
    own stream is within a level of it.  Under a profiler each batch's
    ``grade.lut`` span counts its frames and the lattice's 33 and carries
    CUDA events whose time is positive and no longer than its batch's
    upload-to-download events."""
    from torch.profiler import ProfilerActivity, profile

    from vrgdg_tpu_torch.runtime import video_io
    from vrgdg_tpu_torch.runtime.profiling import SPANS, device_ms

    device = _card()
    luts = os.path.join(REPO, "LUTS")
    clip = np.random.default_rng(19).integers(0, 256, (17, 1080, 1920, 3),
                                              np.uint8)
    batches = [(start, clip[start:start + 8]) for start in range(0, 17, 8)]

    def stream(on, parts, stats=None):
        effect, _ = appliers._lut_effect("teal_orange.cube", 10.0, luts, on)
        return np.concatenate(list(appliers.stream_graded_batches(
            parts, effect, batch_size=8, device=on, dispatch_depth=2,
            stats=stats)))

    want = stream(torch.device("cpu"), batches)
    got = stream(device, batches)
    # dequantize divides by 255 on the CPU, while the card multiplies by
    # the float32 reciprocal (PyTorch's CUDA division by a scalar), which
    # moves 126 of the 256 levels by an ulp; from the same floats the LUT
    # and quantize give the CPU's bits
    cpu = torch.device("cpu")
    effect, _ = appliers._lut_effect("teal_orange.cube", 10.0, luts, cpu)
    floats = video_io.dequantize_on_device(torch.from_numpy(clip).to(device))
    exact = np.concatenate([video_io.quantize_on_device(effect(
        floats[start:start + 8].cpu(), start)).numpy()
        for start, _ in batches])
    assert np.array_equal(got, exact)
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    seen = {record.id for record in SPANS}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for start, batch in batches:
            stats: dict = {}
            alone = stream(device, [(start, batch)], stats)
            assert np.array_equal(alone, got[start:start + len(batch)])
            records = [r for r in SPANS
                       if r.id not in seen and r.name == "grade.lut"]
            seen |= {record.id for record in SPANS}
            assert len(records) == 1
            assert records[0].counts == {"frames": len(batch), "lut_size": 33}
            assert records[0].events is not None
            assert 0.0 < device_ms(records[0]) <= stats["device_ms"]


# --------------------------------------------------------------------------
# Apply LUT's kernel, bit for bit against its plain version on the CPU
# --------------------------------------------------------------------------

def _lut_case(size: int, seed: int, shape):
    """A seeded (size^3, 24) bundle of a lattice with values a little
    outside [0, 1], and frames from -0.25 to 1.25."""
    from vrgdg_tpu_torch.core.cube import corner_bundle

    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 1.1, (size, size, size, 3)).astype(np.float32)
    frames = rng.uniform(-0.25, 1.25, shape).astype(np.float32)
    return (torch.from_numpy(corner_bundle(table)),
            torch.from_numpy(frames))


def _lut_kernel_and_plain(device, frames, bundle, dmin=None, dmax=None,
                          strength=10.0):
    """``apply_lut_bundle`` on the card (one ``lut_apply`` launch) and on
    the CPU."""
    from vrgdg_tpu_torch.ops.lut import apply_lut_bundle

    gc.reset_launch_counts()
    got = apply_lut_bundle(frames.to(device), bundle.to(device), dmin, dmax,
                           strength)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["lut_apply"] == 1
    return got.cpu(), apply_lut_bundle(frames, bundle, dmin, dmax, strength)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", (3, 4))
@pytest.mark.parametrize("strength", (0.0, 3.7, 10.0, 12.5, -1.0))
@pytest.mark.parametrize("size", (2, 17, 33, 65))
def test_lut_kernel_is_the_plain_version_bit_for_bit(size, strength,
                                                     channels):
    """Lattices of 2 to 65 (a 65^3 bundle is 26 MB), strengths in and out
    of 0-10, values below 0 and above 1; alpha comes back unchanged."""
    device = _card()
    bundle, frames = _lut_case(size, size, (2, 67, 101, channels))
    got, want = _lut_kernel_and_plain(device, frames, bundle,
                                      strength=strength)
    assert torch.equal(got, want)
    assert torch.equal(got[..., 3:], frames[..., 3:])


@pytest.mark.cuda
@pytest.mark.parametrize("dmin,dmax", [
    ((0.1, 0.1, 0.1), (0.9, 0.9, 0.9)),
    ((0.1, 0.5, 0.0), (0.9, 0.5 + 5e-7, 1.0)),   # green span floored to 1e-6
])
def test_lut_kernel_domains_are_the_plain_version_bit_for_bit(dmin, dmax):
    """The domain from the host and, as ``prepare_operands`` hands it over,
    as tensors on the card."""
    from vrgdg_tpu_torch.ops.lut import apply_lut_bundle

    device = _card()
    bundle, frames = _lut_case(33, 21, (2, 67, 101, 4))
    dmin, dmax = np.asarray(dmin, np.float32), np.asarray(dmax, np.float32)
    got, want = _lut_kernel_and_plain(device, frames, bundle, dmin, dmax,
                                      7.0)
    assert torch.equal(got, want)
    on_card = apply_lut_bundle(frames.to(device), bundle.to(device),
                               torch.from_numpy(dmin).to(device),
                               torch.from_numpy(dmax).to(device), 7.0)
    assert torch.equal(on_card.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1, 3), (2, 67, 101, 4),
                                   (8, 1080, 1920, 3), (1, 1080, 1920, 3)])
def test_lut_kernel_on_the_flagship_lut_at_its_shapes(shape):
    """``teal_orange.cube`` at its own domain on uint8 levels, the stream's
    batches and a tail frame."""
    from vrgdg_tpu_torch.core.cube import corner_bundle

    device = _card()
    lut = parse_cube(LUT)
    bundle = torch.from_numpy(corner_bundle(lut.table))
    rng = np.random.default_rng(22)
    frames = torch.from_numpy(
        rng.integers(0, 256, shape).astype(np.float32) / 255.0)
    got, want = _lut_kernel_and_plain(device, frames, bundle, lut.domain_min,
                                      lut.domain_max, 10.0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lut_kernel_takes_views_and_other_float_dtypes():
    """A non-contiguous view is made contiguous, and float64 and float16
    batches have their rgb cast to float32 and back, alpha untouched, as
    the plain version does."""
    device = _card()
    bundle, base = _lut_case(17, 23, (2, 40, 30, 4))
    view = base.transpose(1, 2)[:, 1::2, :, :3]
    assert not view.is_contiguous()
    got, want = _lut_kernel_and_plain(device, view, bundle, strength=8.0)
    assert torch.equal(got, want)
    for dtype in (torch.float64, torch.float16):
        frames = base.to(dtype)
        got, want = _lut_kernel_and_plain(device, frames, bundle,
                                          strength=8.0)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(got[..., 3], frames[..., 3])


@pytest.mark.cuda
def test_lut_stream_launches_lut_apply_once_per_batch():
    """Apply LUT's stream at the cell's batch 8: a 17-frame clip is three
    batches, each one ``lut_apply`` launch."""
    device = _card()
    clip = np.random.default_rng(24).integers(0, 256, (17, 1080, 1920, 3),
                                              np.uint8)
    batches = [(start, clip[start:start + 8]) for start in range(0, 17, 8)]
    effect, _ = appliers._lut_effect("teal_orange.cube", 10.0,
                                     os.path.join(REPO, "LUTS"), device)
    gc.reset_launch_counts()
    got = list(appliers.stream_graded_batches(
        batches, effect, batch_size=8, device=device, dispatch_depth=2))
    assert gc.LAUNCHES["lut_apply"] == 3
    assert [g.shape[0] for g in got] == [8, 8, 1]
