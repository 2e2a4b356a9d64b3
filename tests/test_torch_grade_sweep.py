"""The port's grade surface against vrgdg_tpu across its parameter space:
each fusable adjust slider at both ends, eager and fused, the sharpen kinds
and borders, LUT sizes and domains, and tail batches; plus a CPU mirror of
``csrc/grade.cu``'s adjust body, fed by ``grade_cuda._adjust_args``, held
to ``ops.adjust.apply_adjust`` for every slider.

The JAX side runs ``vrgdg_tpu.ops.grade.grade`` (``"xla"``, and
``"pallas"`` in interpret mode on the CPU); the port runs
``grade_prepared`` on CPU tensors (the eager chain, or the fused kernels'
plain versions).  Frames are seeded uniform [0,1].  Bounds: 2e-5 with
colour match off, the JAX suite's own Pallas-vs-XLA bound; 5e-5 with it
on, where the per-frame transfer divides by each frame's LAB std and so
scales the float32 rounding of both sides (tint +100 differs by 2.88e-5;
:func:`report` prints every case's error).  The kernel mirror
runs the kernel's formulas in float32 on the values ``_adjust_args``
packs, so it is held to ``apply_adjust`` at 1e-6, a few ulps.

Two inputs lie outside those bounds by the reference's math, not the
port's: under colour match, saturation -100 leaves a and b flat and
contrast -100 the whole frame, and a flat frame's std is rounding noise
floored at 1e-5, which the transfer multiplies by ``ref_std / 1e-5``.
:func:`test_flat_frame_colour_match_is_ill_conditioned` holds them.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core import cube as jcube
from vrgdg_tpu.core import params as jparams
from vrgdg_tpu.ops.color_match import lab_statistics as jax_lab_statistics
from vrgdg_tpu.ops.grade import GradeConfig as JaxConfig
from vrgdg_tpu.ops.grade import grade as jax_grade
from vrgdg_tpu.ops.grade import prepare_operands as jax_prepare
from vrgdg_tpu_torch.core.params import AdjustSettings
from vrgdg_tpu_torch.kernels import grade_cuda as gc
from vrgdg_tpu_torch.ops.adjust import apply_adjust

tgrade = importlib.import_module("vrgdg_tpu_torch.ops.grade")

LUTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "LUTS")
SHAPE = (2, 19, 37, 3)
EAGER_TOL = 2e-5        # colour match off
MATCH_TOL = 5e-5        # colour match on
MIRROR_TOL = 1e-6
# the eleven sliders phase 1 fuses, and two values each: both ends of the
# bipolar ones, 100 and 37 of the intensity-only ones (0..100)
BIPOLAR = ("temperature", "tint", "exposure", "contrast", "saturation",
           "highlights", "shadows", "whites", "blacks")
INTENSITY = ("vignette", "fade")
SLIDER_CASES = ([(name, value) for name in BIPOLAR for value in (-100, 100)]
                + [(name, value) for name in INTENSITY for value in (37, 100)])
# under colour match these leave a channel, or the whole frame, flat
FLAT_CASES = (("saturation", -100), ("contrast", -100))


def _frames(shape=SHAPE, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _flagship():
    lut = jcube.parse_cube(os.path.join(LUTS, "teal_orange.cube"))
    reference = np.random.default_rng(1).uniform(
        0, 1, (1, 24, 24, 3)).astype(np.float32)
    ref_stats = tuple(np.array(a) for a in
                      jax_lab_statistics(jnp.asarray(reference)))
    return lut, ref_stats


@pytest.fixture(scope="module")
def flagship():
    return _flagship()


def _config(mode, *, adjust=None, match=None, sharpen=None, grain=None,
            lut_strength=7.0):
    return JaxConfig(
        lut=jparams.LUTParams.normalize(lut_strength),
        adjust=None if adjust is None else jparams.AdjustSettings.normalize(
            adjust),
        color_match=None if match is None
        else jparams.ColorMatchParams.normalize(match),
        sharpen=sharpen, grain=grain, fused_mode=mode)


def _fused(mode, adjust=None, grain=None):
    """The fusable stack: LUT 7, colour match 0.6, unsharp 3 zero border."""
    return _config(mode, adjust=adjust, match=0.6, grain=grain,
                   sharpen=jparams.SharpenParams.normalize(3.0,
                                                           border="zero"))


def _port_grade(config, lut, ref_stats, frames, frame_start=0):
    """``config`` carried across to the port and graded on the CPU."""
    operands = [np.array(a) for a in
                jax_prepare(config, lut=lut, ref_stats=ref_stats)]
    port, operands = tgrade.from_reference(
        config, lut_table=operands[0], domain_min=operands[1],
        domain_max=operands[2], ref_mean=operands[3], ref_std=operands[4],
        device="cpu")
    return tgrade.grade_prepared(torch.from_numpy(frames), port, *operands,
                                 frame_start=frame_start).numpy()


def _jax_grade(config, lut, ref_stats, frames, frame_start=0):
    return np.asarray(jax_grade(jnp.asarray(frames), config, lut=lut,
                                ref_stats=ref_stats, frame_start=frame_start))


def _both(config, lut, ref_stats, frames, frame_start=0):
    got = _port_grade(config, lut, ref_stats, frames, frame_start)
    want = _jax_grade(config, lut, ref_stats, frames, frame_start)
    assert got.shape == want.shape == frames.shape
    return got, want


def _err(a, b) -> float:
    return float(np.max(np.abs(a.astype(np.float64) - b)))


# --------------------------------------------------------------------------
# each slider alone, eager and fused
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slider,value", SLIDER_CASES)
def test_slider_eager_matches_jax(flagship, slider, value):
    """LUT 7 and the slider, through the eager chain."""
    lut, ref_stats = flagship
    got, want = _both(_config("xla", adjust={slider: value}), lut,
                      ref_stats, _frames())
    assert _err(got, want) <= EAGER_TOL


@pytest.mark.parametrize("slider,value", [
    case for case in SLIDER_CASES if case not in FLAT_CASES])
def test_slider_fused_matches_jax(flagship, slider, value):
    """The slider inside phase 1's plain version, with colour match and the
    zero-border unsharp after it, against JAX's interpreted Pallas stack."""
    lut, ref_stats = flagship
    got, want = _both(_fused("pallas", {slider: value}), lut, ref_stats,
                      _frames())
    assert _err(got, want) <= MATCH_TOL


def test_all_sliders_fused_matches_jax(flagship):
    """The eleven sliders at once, each drawn within +-80 (the intensity
    ones within 0..80)."""
    lut, ref_stats = flagship
    rng = np.random.default_rng(11)
    adjust = {name: float(rng.uniform(-80, 80)) for name in BIPOLAR}
    adjust.update({name: float(rng.uniform(0, 80)) for name in INTENSITY})
    for mode in ("pallas", "xla"):
        got, want = _both(_fused(mode, adjust), lut, ref_stats, _frames())
        assert _err(got, want) <= MATCH_TOL, mode


# --------------------------------------------------------------------------
# sharpen kinds and borders, LUT sizes and domains, tail batches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("border", ["edge", "zero"])
@pytest.mark.parametrize("kind,strength", [("unsharp", 3.0),
                                           ("laplacian", 1.2),
                                           ("sobel", 0.8)])
def test_sharpen_kind_and_border_match_jax(flagship, kind, strength, border):
    lut, ref_stats = flagship
    config = _config("xla", sharpen=jparams.SharpenParams.normalize(
        strength, border=border, kind=kind))
    got, want = _both(config, lut, ref_stats, _frames(seed=3))
    assert _err(got, want) <= EAGER_TOL


def _random_lut(size: int, domain) -> jcube.LutData:
    table = np.random.default_rng(size).uniform(
        0, 1, (size, size, size, 3)).astype(np.float32)
    return jcube.LutData(size=size, table=table,
                         domain_min=np.full(3, domain[0], np.float32),
                         domain_max=np.full(3, domain[1], np.float32))


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("domain", [(0.0, 1.0), (-0.1, 1.2)])
@pytest.mark.parametrize("size", [2, 17, 33, 65])
def test_lut_size_and_domain_match_jax(flagship, size, domain, mode):
    """A seeded random table of each size, over [0,1] and a domain wider
    than the frames, in the fused stack (its LUT runs inside phase 1 in
    the fused mode)."""
    _, ref_stats = flagship
    got, want = _both(_fused(mode), _random_lut(size, domain), ref_stats,
                      _frames(seed=4))
    assert _err(got, want) <= MATCH_TOL


@pytest.mark.parametrize("frame_start", [0, 5])
@pytest.mark.parametrize("batch", [1, 3])
def test_tail_batches_match_jax(flagship, batch, frame_start):
    """Short batches at both frame starts: against JAX with grain off (the
    interpreter stubs the TPU's random bits, and JAX's eager grain is
    another stream); with grain on, each frame of the fused batch is its
    own grade at its absolute index, and the eager mode agrees.  Not bit
    for bit on the CPU: torch's vectorized ``pow`` and its scalar tail
    round some elements an ulp apart, and which elements fall in the tail
    depends on the batch (the kernels' splits are bit-identical on the
    card, chip_smoke.py phase 4)."""
    lut, ref_stats = flagship
    frames = _frames((batch, 19, 37, 3), seed=5)
    for mode in ("xla", "pallas"):
        got, want = _both(_fused(mode, {"contrast": 12, "vignette": 20}),
                          lut, ref_stats, frames, frame_start)
        assert _err(got, want) <= MATCH_TOL, mode
    grain = jparams.GrainParams.normalize(0.05, 0.5, 42)
    fused = _port_grade(_fused("pallas", grain=grain), lut, ref_stats,
                        frames, frame_start)
    single = np.concatenate([
        _port_grade(_fused("pallas", grain=grain), lut, ref_stats,
                    frames[i:i + 1], frame_start + i) for i in range(batch)])
    assert _err(fused, single) <= EAGER_TOL
    eager = _port_grade(_fused("xla", grain=grain), lut, ref_stats, frames,
                        frame_start)
    assert _err(fused, eager) <= EAGER_TOL


# --------------------------------------------------------------------------
# the kernel's adjust body on the CPU
# --------------------------------------------------------------------------

def _linspace_pm1(steps: int) -> torch.Tensor:
    """``linspace_pm1`` of csrc/grade.cu for i in [0, steps)."""
    if steps == 1:
        return torch.tensor([-1.0])
    step = torch.tensor(2.0 / (steps - 1), dtype=torch.float32)
    i = torch.arange(steps, dtype=torch.float32)
    return torch.where(i < steps // 2, -1.0 + step * i,
                       1.0 - step * (steps - 1 - i))


def _kernel_adjust(color: torch.Tensor, flags: int, s) -> torch.Tensor:
    """``apply_adjust`` of csrc/grade.cu (its lines 262-322), formula by
    formula in float32, on a BHWC batch, from the mask and
    ``AdjustParams`` that ``grade_cuda._adjust_args`` packs."""
    def luma(c):
        return c[..., 0:1] * 0.2126 + c[..., 1:2] * 0.7152 + c[..., 2:3] * 0.0722

    c = torch.clamp(color, 0.0, 1.0)
    if flags & gc._TEMP_TINT:
        c = c + torch.tensor(list(s.offset), dtype=torch.float32)
    if flags & gc._EXPOSURE:
        c = c * s.exposure
    if flags & gc._CONTRAST:
        c = (c - 0.5) * s.contrast + 0.5
    if flags & gc._SATURATION:
        gray = luma(c)
        c = gray + (c - gray) * s.saturation
    if flags & (gc._HIGHLIGHTS | gc._SHADOWS | gc._WHITES | gc._BLACKS):
        lum = luma(c)
        for bit, value, pivot, span, rising in (
                (gc._HIGHLIGHTS, s.highlights, 0.55, 0.45, True),
                (gc._SHADOWS, s.shadows, 0.45, 0.45, False),
                (gc._WHITES, s.whites, 0.75, 0.25, True),
                (gc._BLACKS, s.blacks, 0.25, 0.25, False)):
            if flags & bit:
                t = (lum - pivot) / span if rising else (pivot - lum) / span
                c = c + torch.clamp(t, 0.0, 1.0) * value
    if flags & gc._FADE:
        c = c * s.fade_scale + s.fade_lift
    if flags & gc._VIGNETTE:
        yy = _linspace_pm1(c.shape[1]).reshape(1, -1, 1, 1)
        xx = _linspace_pm1(c.shape[2]).reshape(1, 1, -1, 1)
        distance = torch.sqrt(xx * xx + yy * yy)
        c = c * (1.0 - torch.clamp((distance - 0.35) / 1.05, 0.0, 1.0)
                 * s.vignette * 0.75)
    return torch.clamp(c, 0.0, 1.0)


_SLIDER_BITS = {"temperature": gc._TEMP_TINT, "tint": gc._TEMP_TINT,
                "exposure": gc._EXPOSURE, "contrast": gc._CONTRAST,
                "saturation": gc._SATURATION, "highlights": gc._HIGHLIGHTS,
                "shadows": gc._SHADOWS, "whites": gc._WHITES,
                "blacks": gc._BLACKS, "fade": gc._FADE,
                "vignette": gc._VIGNETTE}


@pytest.mark.parametrize("slider,value",
                         SLIDER_CASES + [(name, 23.0) for name in BIPOLAR])
def test_kernel_adjust_mirror_matches_apply_adjust(slider, value):
    """Each slider sets its own bit and nothing else, and the kernel's
    formulas on the packed values give ``apply_adjust``'s output.  The
    frames reach past [0,1] (phase 1's blend can), so the first clamp
    counts too."""
    settings = AdjustSettings.normalize({slider: value})
    flags, params = gc._adjust_args(settings)
    assert flags == gc._ADJUST_ON | _SLIDER_BITS[slider]
    frames = torch.from_numpy(_frames((2, 19, 37, 3), seed=6)) * 1.2 - 0.1
    got = _kernel_adjust(frames, flags, params)
    want = apply_adjust(frames, settings)
    assert float((got - want).abs().max()) <= MIRROR_TOL


def test_kernel_adjust_mirror_all_sliders_and_off():
    """All eleven at once, from a seeded draw within +-80, on odd and even
    frame sizes (the vignette's two linspace halves); no adjust packs an
    empty mask."""
    rng = np.random.default_rng(12)
    settings = AdjustSettings.normalize(
        {name: float(rng.uniform(-80, 80)) for name in BIPOLAR}
        | {name: float(rng.uniform(0, 80)) for name in INTENSITY})
    flags, params = gc._adjust_args(settings)
    assert flags == gc._ADJUST_ON | sum(set(_SLIDER_BITS.values()))
    for shape in ((2, 19, 37, 3), (1, 20, 36, 3), (1, 1, 5, 3)):
        frames = torch.from_numpy(_frames(shape, seed=7))
        got = _kernel_adjust(frames, flags, params)
        assert float((got - apply_adjust(frames, settings)).abs().max()) \
            <= MIRROR_TOL, shape
    assert gc._adjust_args(None)[0] == 0


# --------------------------------------------------------------------------
# the ill-conditioned inputs of colour match
# --------------------------------------------------------------------------

def test_flat_frame_colour_match_is_ill_conditioned(flagship):
    """A frame that colour match sees as flat, but not black: its std is
    float32 rounding noise floored at 1e-5, and the transfer multiplies the
    rounding of its mean by ``ref_std / 1e-5``.  The reference's own eager
    and fused modes then disagree by more than 1e-2; the port's output is
    still deterministic (not flat: one-ulp differences between pixels are
    amplified too).  A black frame's LAB is exactly zero, so it stays
    within the bound."""
    lut, ref_stats = flagship
    grey = np.full(SHAPE, 0.5, np.float32)
    cases = ((grey, None), (_frames(), {"contrast": -100}),
             (_frames(), {"saturation": -100}))
    for frames, adjust in cases:
        jax_eager = _jax_grade(_fused("xla", adjust), lut, ref_stats, frames)
        jax_fused = _jax_grade(_fused("pallas", adjust), lut, ref_stats,
                               frames)
        assert _err(jax_eager, jax_fused) > 1e-2, adjust
        for mode in ("xla", "pallas"):
            config = _fused(mode, adjust)
            first = _port_grade(config, lut, ref_stats, frames)
            assert np.isfinite(first).all()
            np.testing.assert_array_equal(
                first, _port_grade(config, lut, ref_stats, frames))
    black = np.zeros(SHAPE, np.float32)
    for mode in ("xla", "pallas"):
        got, want = _both(_fused(mode), lut, ref_stats, black)
        assert _err(got, want) <= EAGER_TOL, mode


# --------------------------------------------------------------------------
# chip_smoke.py phase 22's cases and checks, on the CPU
# --------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(LUTS), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_sweep_covers_every_fused_slider():
    """Each slider with a bit in ``_adjust_args`` alone (the bipolar ones
    at -100, 37 and 100, vignette and fade at 37 and 100), then all eleven
    within +-80; the two flat cases are among them."""
    smoke = _chip_smoke()
    cases = smoke.sweep_cases()
    assert len(cases) == 32 and cases[-1][0] == "all"
    singles = cases[:-1]
    for slider, adjust in singles:
        assert list(adjust) == [slider]
    values = {name: sorted(a[name] for s, a in singles if s == name)
              for name in _SLIDER_BITS}
    assert values == {name: [-100.0, 37.0, 100.0] if name in BIPOLAR
                      else [37.0, 100.0] for name in _SLIDER_BITS}
    drawn = cases[-1][1]
    assert set(drawn) == set(_SLIDER_BITS)
    assert all(-80 <= v <= 80 for v in drawn.values())
    assert all(drawn[name] >= 0 for name in INTENSITY)
    flags, _ = gc._adjust_args(AdjustSettings.normalize(drawn))
    assert flags == gc._ADJUST_ON | sum(set(_SLIDER_BITS.values()))
    assert set(smoke.SWEEP_FLAT) == set(FLAT_CASES)
    assert all({name: value} in [a for _, a in singles]
               for name, value in smoke.SWEEP_FLAT)


def test_smoke_sweep_checks_catch_a_wrong_partial_and_coefficient():
    """Phase 22's partials and A/B rules (tests/test_torch_cuda.py's) pass
    the plain version against itself and refuse a changed value."""
    smoke = _chip_smoke()
    frames = torch.from_numpy(_frames((2, 19, 37, 3), seed=8))
    bundle = torch.from_numpy(jcube.corner_bundle(_random_lut(5, (0, 1))))
    domain = torch.tensor([[0.0] * 3, [1.0] * 3])
    lab, partials = gc.phase1_plain(frames, bundle, domain, blend=0.8,
                                    adjust=AdjustSettings.normalize(
                                        {"tint": 40}))
    assert smoke.partials_err(lab, partials) <= 1e-9
    wrong = partials.clone()
    wrong[1, 0, 4] += 1e-3
    with pytest.raises(AssertionError, match="partials"):
        smoke.partials_err(lab, wrong)
    ref_mean, ref_std = torch.tensor([[50.0, 5.0, -5.0]]), torch.tensor(
        [[20.0, 15.0, 25.0]])
    coeff = gc.stats_barrier(partials, 19 * 37, ref_mean, ref_std, 0.7)
    assert smoke.coefficients_err(lab, lab, coeff, coeff, ref_std,
                                   0.7) == 0.0
    moved = coeff.clone()
    moved[0, 1] += 1e-4
    with pytest.raises(AssertionError, match="coefficients"):
        smoke.coefficients_err(lab, lab, moved, coeff, ref_std, 0.7)


# --------------------------------------------------------------------------
# the measured errors behind the bounds above
# --------------------------------------------------------------------------

def report() -> None:
    """Print each slider case's error against JAX (eager and fused, the
    flat ones included) and the kernel mirror's against ``apply_adjust``,
    then the flat and black frames' differences:

        JAX_PLATFORMS=cpu python tests/test_torch_grade_sweep.py
    """
    lut, ref_stats = _flagship()
    frames = _frames()
    for slider, value in SLIDER_CASES:
        eager = _err(*_both(_config("xla", adjust={slider: value}), lut,
                            ref_stats, frames))
        fused = _err(*_both(_fused("pallas", {slider: value}), lut,
                            ref_stats, frames))
        settings = AdjustSettings.normalize({slider: value})
        flags, params = gc._adjust_args(settings)
        wide = torch.from_numpy(_frames((2, 19, 37, 3), seed=6)) * 1.2 - 0.1
        mirror = float((_kernel_adjust(wide, flags, params)
                        - apply_adjust(wide, settings)).abs().max())
        print(f"{slider}={value:g} eager {eager:.3g} fused {fused:.3g} "
              f"mirror {mirror:.3g}")
    cases = (("grey 0.5", np.full(SHAPE, 0.5, np.float32), None),
             ("contrast -100", frames, {"contrast": -100}),
             ("saturation -100", frames, {"saturation": -100}),
             ("black", np.zeros(SHAPE, np.float32), None))
    for label, data, adjust in cases:
        jax_eager = _jax_grade(_fused("xla", adjust), lut, ref_stats, data)
        jax_fused = _jax_grade(_fused("pallas", adjust), lut, ref_stats,
                               data)
        port_eager = _port_grade(_fused("xla", adjust), lut, ref_stats, data)
        port_fused = _port_grade(_fused("pallas", adjust), lut, ref_stats,
                                 data)
        print(f"{label}: jax eager vs fused {_err(jax_eager, jax_fused):.3g}"
              f"; port vs jax eager {_err(port_eager, jax_eager):.3g}, "
              f"fused {_err(port_fused, jax_fused):.3g}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    report()
