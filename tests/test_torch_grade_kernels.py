"""The fused grade's kernel module (vrgdg_tpu_torch.kernels.grade_cuda)
against vrgdg_tpu.kernels.grade_pallas.fused_post_gather.

On the CPU the wrappers run their plain PyTorch versions, and the JAX
side runs its Pallas kernels in interpret mode, as tests/test_grade_pallas.py
does.  The interpreter stubs the TPU's random bits to zeros, so every
comparison here runs with grain off; the grain stream is held in
tests/test_torch_ops.py.  Bounds: RGB 2e-5 (the JAX suite's own
Pallas-vs-XLA bound: identical formulas, other reduction order), the
per-frame affine gain A 1e-5 and offset B 1e-3 (LAB units).  The kernels
themselves are held against these plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core.cube import build_palette_lut
from vrgdg_tpu.core.params import AdjustSettings as JaxAdjust
from vrgdg_tpu.core.params import (ColorMatchParams, GrainParams, LUTParams,
                                   SharpenParams)
from vrgdg_tpu.kernels.grade_pallas import fused_post_gather
from vrgdg_tpu.ops.color_match import lab_statistics
from vrgdg_tpu.ops.grade import GradeConfig, prepare_operands
from vrgdg_tpu_torch.core.params import AdjustSettings
from vrgdg_tpu_torch.kernels import grade_cuda as gc

tgrade = importlib.import_module("vrgdg_tpu_torch.ops.grade")

RGB_TOL = 2e-5
ADJUST = dict(temperature=22.0, tint=-9.0, saturation=18.0, exposure=-12.0,
              contrast=15.0, highlights=25.0, shadows=-30.0, whites=10.0,
              blacks=-8.0, fade=12.0, vignette=35.0)


@pytest.fixture(scope="module")
def stack():
    lut = build_palette_lut("#0b1d51, #1f6aa5, #f3d27a", 17)
    rng = np.random.default_rng(3)
    reference = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    ref_mean, ref_std = (np.array(a) for a in
                         lab_statistics(jnp.asarray(reference)))
    config = GradeConfig(lut=LUTParams.normalize(8.0),
                         color_match=ColorMatchParams.normalize(0.7),
                         sharpen=SharpenParams.normalize(1.5, border="zero"),
                         fused_mode="pallas")
    bundle = np.array(prepare_operands(config, lut=lut,
                                       ref_stats=(ref_mean, ref_std))[0])
    return lut, bundle, ref_mean, ref_std


def _both(stack, frames, *, blend=0.8, match=0.7, sharpen=1.5, adjust=None):
    _, bundle, ref_mean, ref_std = stack
    dmin, dmax = np.zeros(3, np.float32), np.ones(3, np.float32)
    want = fused_post_gather(
        jnp.asarray(frames), jnp.asarray(bundle), jnp.asarray(dmin),
        jnp.asarray(dmax), jnp.asarray(ref_mean), jnp.asarray(ref_std),
        jnp.zeros(1, jnp.int32), blend=blend, match_strength=match,
        sharpen_strength=sharpen, grain_intensity=0.0, saturation_mix=0.5,
        interpret=True,
        adjust=None if adjust is None else JaxAdjust.normalize(adjust))
    t = torch.from_numpy
    got = gc.fused_post_gather_plain(
        t(frames), t(bundle), t(dmin), t(dmax), t(ref_mean), t(ref_std), 0,
        blend=blend, match_strength=match, sharpen_strength=sharpen,
        grain_intensity=0.0, saturation_mix=0.5,
        adjust=None if adjust is None else AdjustSettings.normalize(adjust))
    return got, np.asarray(want)


@pytest.mark.parametrize("with_adjust", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 256, 3), (1, 30, 200, 3),
                                   (2, 27, 129, 3), (1, 16, 127, 3)])
def test_fused_plain_matches_pallas_interpret(stack, shape, with_adjust):
    frames = np.random.default_rng(8).uniform(0, 1, shape).astype(np.float32)
    got, want = _both(stack, frames, adjust=ADJUST if with_adjust else None)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err < RGB_TOL, (shape, with_adjust, err)


def test_fused_plain_partial_strengths(stack):
    frames = np.random.default_rng(9).uniform(
        0, 1, (2, 32, 256, 3)).astype(np.float32)
    got, want = _both(stack, frames, blend=0.35, match=0.25, sharpen=6.0)
    assert float(np.max(np.abs(got.numpy() - want))) < RGB_TOL


def test_phase1_and_barrier_match_jax_statistics(stack):
    """Phase-1 LAB and the barrier's per-frame A/B against the JAX eager
    statistics of the same graded frames (LUT blend + adjust -> LAB, mean
    and ddof=1 std + 1e-5)."""
    from vrgdg_tpu.core.colorspace import rgb_to_lab
    from vrgdg_tpu.ops.adjust import apply_adjust
    from vrgdg_tpu.ops.lut import apply_lut_bundle

    _, bundle, ref_mean, ref_std = stack
    frames = np.random.default_rng(10).uniform(
        0, 1, (3, 27, 129, 3)).astype(np.float32)
    graded = apply_adjust(apply_lut_bundle(jnp.asarray(frames),
                                           jnp.asarray(bundle), strength=6.0),
                          JaxAdjust.normalize(ADJUST))
    lab = np.asarray(rgb_to_lab(graded), np.float64)
    mean = lab.mean(axis=(1, 2))
    std = lab.std(axis=(1, 2), ddof=1) + 1e-5
    gain = ref_std.reshape(-1, 3) / std
    want_a = 0.7 * gain + 0.3
    want_b = 0.7 * (ref_mean.reshape(-1, 3) - mean * gain)

    domain = torch.tensor([[0.0] * 3, [1.0] * 3])
    lab_t, partials = gc.phase1_plain(
        torch.from_numpy(frames), torch.from_numpy(bundle), domain,
        blend=0.6, adjust=AdjustSettings.normalize(ADJUST))
    assert partials.shape == (3, -(-27 * 129 // gc.PHASE1_BLOCK), 6)
    assert partials.dtype == torch.float64
    assert float(np.max(np.abs(lab_t.numpy() - lab))) <= 1e-3
    coeff = gc.stats_barrier(partials, 27 * 129, torch.from_numpy(ref_mean),
                             torch.from_numpy(ref_std), 0.7)
    assert coeff.shape == (3, 6) and coeff.dtype == torch.float32
    assert float(np.max(np.abs(coeff[:, :3].numpy() - want_a))) <= 1e-5
    assert float(np.max(np.abs(coeff[:, 3:].numpy() - want_b))) <= 1e-3


def _phase1_of(stack, frames):
    _, bundle, _, _ = stack
    domain = torch.tensor([[0.0] * 3, [1.0] * 3])
    return gc.phase1_plain(torch.from_numpy(frames), torch.from_numpy(bundle),
                           domain, blend=0.8,
                           adjust=AdjustSettings.normalize(ADJUST))


def test_phase1_partials_are_one_row_per_chunk(stack):
    """One partials row per PHASE1_BLOCK consecutive pixels of a frame,
    the last one shorter: the float64 sums of its L, a, b and squares."""
    frames = np.random.default_rng(11).uniform(
        0, 1, (2, 100, 130, 3)).astype(np.float32)
    lab, partials = _phase1_of(stack, frames)
    assert gc.PHASE1_BLOCK == 8192
    assert partials.shape == (2, 2, 6) and partials.dtype == torch.float64
    flat = lab.reshape(2, -1, 3).double()
    for b in range(2):
        for row, (lo, hi) in enumerate(((0, 8192), (8192, 13000))):
            chunk = flat[b, lo:hi]
            want = torch.cat([chunk.sum(0), (chunk * chunk).sum(0)])
            torch.testing.assert_close(partials[b, row], want, rtol=1e-12,
                                       atol=0.0)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_phase1_partials_of_a_frame_do_not_depend_on_the_batch(stack, b):
    """The chunks follow H x W alone: frame b's rows are the same bits in
    a batch of 3 and alone."""
    frames = np.random.default_rng(12).uniform(
        0, 1, (3, 90, 100, 3)).astype(np.float32)
    lab, whole = _phase1_of(stack, frames)
    lab_alone, alone = _phase1_of(stack, frames[b:b + 1])
    assert whole.shape == (3, 2, 6)
    assert torch.equal(alone[0], whole[b])
    assert torch.equal(lab_alone[0], lab[b])


def test_frame_statistics_match_float64_whole_frame(stack):
    """The barrier's per-frame mean and ddof=1 std (+1e-5) from the chunk
    partials equal the float64 statistics of the whole frame's LAB."""
    frames = np.random.default_rng(13).uniform(
        0, 1, (2, 100, 130, 3)).astype(np.float32)
    lab, partials = _phase1_of(stack, frames)
    mean, std = gc.frame_statistics(partials, 100 * 130)
    flat = lab.numpy().reshape(2, -1, 3).astype(np.float64)
    want_mean = flat.mean(axis=1)
    want_std = flat.std(axis=1, ddof=1) + 1e-5
    assert mean.dtype == std.dtype == torch.float64
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-9, atol=0.0)


def test_wrappers_run_plain_versions_on_cpu(stack):
    """CPU tensors go to the plain versions and launch nothing."""
    _, bundle, ref_mean, ref_std = stack
    frames = torch.rand((2, 9, 11, 3), generator=torch.Generator().manual_seed(1))
    domain = torch.tensor([[0.0] * 3, [1.0] * 3])
    gc.reset_launch_counts()
    lab, partials = gc.phase1(frames, torch.from_numpy(bundle), domain,
                              blend=0.8)
    lab_p, partials_p = gc.phase1_plain(frames, torch.from_numpy(bundle),
                                        domain, blend=0.8)
    assert torch.equal(lab, lab_p) and torch.equal(partials, partials_p)
    coeff = gc.stats_barrier(partials, 99, torch.from_numpy(ref_mean),
                             torch.from_numpy(ref_std), 0.7)
    kw = dict(sharpen_strength=1.5, grain_intensity=0.05,
              saturation_mix=0.5, seed_base=42)
    assert torch.equal(gc.phase2(lab, coeff, **kw),
                       gc.phase2_plain(lab, coeff, **kw))
    assert gc.LAUNCHES == dict.fromkeys(
        ("grade_phase1", "grade_phase2", "grade_phase1_planes",
         "grade_phase2_planes", "film_grain", "weighted_row_sum",
         "lut_apply"), 0)


def test_phase2_grain_is_the_eager_stream(stack):
    """Phase 2's grain is ops.grain's Philox field: with sharpen 0 and a
    neutral transfer, phase 2 = film_grain(lab_to_rgb(lab))."""
    from vrgdg_tpu_torch.core.colorspace import lab_to_rgb, rgb_to_lab
    from vrgdg_tpu_torch.ops.grain import film_grain

    rgb = torch.rand((3, 8, 10, 3), generator=torch.Generator().manual_seed(2))
    lab = rgb_to_lab(rgb)
    coeff = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0]] * 3)
    got = gc.phase2_plain(lab, coeff, sharpen_strength=0.0,
                          grain_intensity=0.05, saturation_mix=0.3,
                          seed_base=42 + 5)
    want = film_grain(lab_to_rgb(lab), 0.05, 0.3, 42, frame_start=5)
    assert torch.equal(got, want)


def test_plain_rejects_spatial_adjust_and_bad_shapes(stack):
    _, bundle, _, _ = stack
    domain = torch.tensor([[0.0] * 3, [1.0] * 3])
    frames = torch.zeros((1, 4, 4, 3))
    for sliders in (dict(clarity=20.0), dict(sharpen=15.0)):
        with pytest.raises(ValueError, match="clarity and sharpen"):
            gc.phase1(frames, torch.from_numpy(bundle), domain, blend=1.0,
                      adjust=AdjustSettings.normalize(sliders))
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        gc.phase1(torch.zeros((1, 4, 4, 4)), torch.from_numpy(bundle),
                  domain, blend=1.0)
    with pytest.raises(ValueError, match="corner bundle"):
        gc.phase1(frames, torch.zeros((10, 24)), domain, blend=1.0)


def test_adjust_args_fold_like_eager():
    flags, params = gc._adjust_args(AdjustSettings.normalize(ADJUST))
    assert flags == 2047     # every elementwise slider plus the on bit
    assert params.exposure == pytest.approx(2.0 ** -0.12, rel=1e-7)
    assert params.fade_scale == pytest.approx(1 - 0.12 * 0.35, rel=1e-7)
    assert gc._adjust_args(None)[0] == 0
    flags, _ = gc._adjust_args(AdjustSettings.normalize({"fade": 0.0,
                                                         "contrast": 5}))
    assert flags == 1024 | 4


@pytest.mark.parametrize("mode,port_mode", [("xla", "eager"),
                                            ("pallas", "fused")])
def test_from_reference_round_trip(stack, mode, port_mode):
    """A JAX config and its operands carried across give the same grade
    as the port's own prepare_operands on the same LUT, for the bundle
    operand and for a raw (N, N, N, 3) table."""
    from vrgdg_tpu_torch.core.cube import LutData

    lut, bundle, ref_mean, ref_std = stack
    config = GradeConfig(lut=LUTParams.normalize(7.0),
                         adjust=JaxAdjust.normalize({"contrast": 10.0}),
                         color_match=ColorMatchParams.normalize(0.5),
                         sharpen=SharpenParams.normalize(2.0, border="zero"),
                         grain=GrainParams.normalize(0.04, 0.3, 9),
                         fused_mode=mode)
    dmin, dmax = np.zeros(3, np.float32), np.ones(3, np.float32)
    port, operands = tgrade.from_reference(
        config, lut_table=bundle, domain_min=dmin, domain_max=dmax,
        ref_mean=ref_mean, ref_std=ref_std, device="cpu")
    assert port.fused_mode == port_mode and port.lut_mode == "bundle"
    assert port.lut.strength == 7.0 and port.grain.seed == 9
    assert port.adjust.contrast == 10.0 and port.sharpen.border == "zero"
    _, raw_operands = tgrade.from_reference(
        config, lut_table=lut.table, domain_min=dmin, domain_max=dmax,
        ref_mean=ref_mean, ref_std=ref_std, device="cpu")
    assert torch.equal(operands[0], raw_operands[0])

    frames = torch.rand((2, 12, 20, 3), generator=torch.Generator().manual_seed(3))
    got = tgrade.grade_prepared(frames, port, *operands, frame_start=4)
    own = tgrade.grade(frames, port, lut=LutData(lut.size, lut.table),
                       ref_stats=(torch.from_numpy(ref_mean),
                                  torch.from_numpy(ref_std)), frame_start=4)
    assert torch.equal(got, own)
