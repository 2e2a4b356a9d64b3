"""The port's torch ops (vrgdg_tpu_torch.ops, core.colorspace) against their
JAX twins in vrgdg_tpu, on the same seeded numpy inputs.

Tolerances: RGB-domain ops <= 1e-5 absolute (float32 ops in another
association or with another pow/cbrt implementation differ by a few ulp);
LAB values <= 1e-3 absolute (L reaches 100, where an ulp is 7.6e-6, and
cbrt/pow differences grow by the 116/500/200 LAB scales).  Grain draws
from Philox here and threefry there, so it is held by statistics, by its
known-answer vectors, by determinism and by batch-split identity.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core import colorspace as jcs
from vrgdg_tpu.core.cube import build_palette_lut as jax_palette
from vrgdg_tpu.core.cube import corner_bundle as jax_corner_bundle
from vrgdg_tpu.core.params import AdjustSettings as JaxAdjust
from vrgdg_tpu.ops import adjust as jadjust
from vrgdg_tpu.ops import grain as jgrain
from vrgdg_tpu.ops import lut as jlut
from vrgdg_tpu.ops import sharpen as jsharpen
from vrgdg_tpu_torch.core import colorspace as tcs
from vrgdg_tpu_torch.core.cube import LutData
from vrgdg_tpu_torch.core.params import AdjustSettings
from vrgdg_tpu_torch.ops import adjust as tadjust
from vrgdg_tpu_torch.ops import grain as tgrain
from vrgdg_tpu_torch.ops import lut as tlut
from vrgdg_tpu_torch.ops import sharpen as tsharpen

# the packages export a function named like this module
jcm = importlib.import_module("vrgdg_tpu.ops.color_match")
tcm = importlib.import_module("vrgdg_tpu_torch.ops.color_match")

RGB_TOL = 1e-5
LAB_TOL = 1e-3


def _rgb(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.numpy().astype(np.float64)
                               - np.asarray(want, np.float64))))


# --------------------------------------------------------------------------
# colorspace
# --------------------------------------------------------------------------

def test_rgb_to_lab_matches_jax():
    rgb = _rgb((2, 9, 11, 3), 1)
    rgb[0, 0, :4] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.5, 0.0031308],
                     [1e-4, 0.2, 0.9]]
    got = tcs.rgb_to_lab(torch.from_numpy(rgb))
    assert _err(got, jcs.rgb_to_lab(jnp.asarray(rgb))) <= LAB_TOL


def test_lab_to_rgb_matches_jax():
    lab = np.stack([np.random.default_rng(2).uniform(0, 100, (64,)),
                    np.random.default_rng(3).uniform(-100, 100, (64,)),
                    np.random.default_rng(4).uniform(-100, 100, (64,))],
                   axis=-1).astype(np.float32)
    for clip in (True, False):
        got = tcs.lab_to_rgb(torch.from_numpy(lab), clip=clip)
        want = jcs.lab_to_rgb(jnp.asarray(lab), clip=clip)
        assert _err(got, want) <= RGB_TOL * max(1.0, float(np.max(np.abs(want))))


def test_lab_round_trip_and_transfer_functions():
    rgb = _rgb((4, 5, 3), 5)
    back = tcs.lab_to_rgb(tcs.rgb_to_lab(torch.from_numpy(rgb)))
    assert _err(back, rgb) <= 1e-5
    lin = tcs.srgb_to_linear(torch.from_numpy(rgb))
    assert _err(lin, jcs.srgb_to_linear(jnp.asarray(rgb))) <= 1e-6
    assert _err(tcs.linear_to_srgb(lin),
                jcs.linear_to_srgb(jnp.asarray(lin.numpy()))) <= 1e-6
    assert _err(tcs.rec709_luma(torch.from_numpy(rgb)),
                jcs.rec709_luma(jnp.asarray(rgb))) <= 1e-7


# --------------------------------------------------------------------------
# LUT
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def palette():
    return jax_palette("#0b1d51, #1f6aa5, #f3d27a", 17)


@pytest.mark.parametrize("strength", [10.0, 8.0, 3.5, 0.0])
def test_apply_lut_raw_and_bundle_match_jax(palette, strength):
    frames = _rgb((2, 7, 13, 3), 6)
    frames[0, 0, :2] = [[0, 0, 0], [1, 1, 1]]
    table = torch.from_numpy(palette.table)
    raw = tlut.apply_lut(torch.from_numpy(frames), table, strength=strength)
    bundle = tlut.apply_lut_bundle(
        torch.from_numpy(frames),
        torch.from_numpy(jax_corner_bundle(palette.table)),
        strength=strength)
    want = jlut.apply_lut(jnp.asarray(frames), palette, strength=strength)
    assert _err(raw, want) <= RGB_TOL
    # the reference's two paths are bit-identical, and so are the port's
    assert torch.equal(raw, bundle)
    want_bundle = jlut.apply_lut_bundle(
        jnp.asarray(frames), jnp.asarray(jax_corner_bundle(palette.table)),
        strength=strength)
    assert _err(bundle, want_bundle) <= RGB_TOL


def test_apply_lut_domain_and_alpha(palette):
    frames = _rgb((1, 5, 6, 4), 7)
    lut = LutData(size=palette.size, table=palette.table,
                  domain_min=np.array([0.1, 0.0, 0.05], np.float32),
                  domain_max=np.array([0.9, 1.0, 0.8], np.float32))
    got = tlut.apply_lut(torch.from_numpy(frames), lut, strength=7.0)
    want = jlut.apply_lut(jnp.asarray(frames), palette,
                          domain_min=lut.domain_min,
                          domain_max=lut.domain_max, strength=7.0)
    assert _err(got, want) <= RGB_TOL
    assert torch.equal(got[..., 3], torch.from_numpy(frames[..., 3]))


# --------------------------------------------------------------------------
# adjust
# --------------------------------------------------------------------------

_SLIDERS = {"temperature": 35.0, "tint": -22.0, "saturation": 40.0,
            "exposure": -18.0, "contrast": 25.0, "highlights": 30.0,
            "shadows": -45.0, "whites": 20.0, "blacks": -15.0,
            "sharpen": 60.0, "clarity": -35.0, "vignette": 50.0, "fade": 25.0}


def _adjust_pair(settings: dict, shape, seed):
    frames = _rgb(shape, seed)
    got = tadjust.apply_adjust(torch.from_numpy(frames),
                               AdjustSettings.normalize(settings))
    want = jadjust.apply_adjust(jnp.asarray(frames),
                                JaxAdjust.normalize(settings))
    return got, want


@pytest.mark.parametrize("slider", sorted(_SLIDERS))
def test_adjust_each_slider_matches_jax(slider):
    got, want = _adjust_pair({slider: _SLIDERS[slider]}, (2, 12, 17, 3), 8)
    assert _err(got, want) <= RGB_TOL


@pytest.mark.parametrize("shape", [(2, 12, 17, 3), (1, 7, 5, 3),
                                   (1, 4, 6, 3), (1, 2, 2, 3)])
def test_adjust_all_sliders_and_clarity_shrink(shape):
    """Odd small frames take the clarity kernel shrink (9 -> 5 -> 3) and
    skip clarity below a 3-tap kernel."""
    got, want = _adjust_pair(_SLIDERS, shape, 9)
    assert _err(got, want) <= RGB_TOL


def test_adjust_disabled_and_identity_only_clamp():
    frames = _rgb((1, 4, 4, 3), 10) * 1.4 - 0.2
    for settings in (AdjustSettings.normalize({"enabled": False,
                                                "contrast": 50}),
                     AdjustSettings.normalize({})):
        got = tadjust.apply_adjust(torch.from_numpy(frames), settings)
        assert torch.equal(got, torch.clamp(torch.from_numpy(frames), 0, 1))


# --------------------------------------------------------------------------
# color match
# --------------------------------------------------------------------------

def test_lab_statistics_match_jax():
    rgb = _rgb((2, 16, 20, 3), 11)
    mean, std = tcm.lab_statistics(torch.from_numpy(rgb))
    jmean, jstd = jcm.lab_statistics(jnp.asarray(rgb))
    assert mean.shape == (2, 1, 1, 3) and std.shape == (2, 1, 1, 3)
    assert _err(mean, jmean) <= LAB_TOL and _err(std, jstd) <= LAB_TOL


@pytest.mark.parametrize("strength", [1.0, 0.7, 0.25])
def test_color_match_matches_jax(strength):
    images = _rgb((2, 16, 20, 3), 12)
    reference = _rgb((1, 24, 24, 3), 13) * 0.6 + 0.3
    got = tcm.color_match(torch.from_numpy(images),
                          torch.from_numpy(reference), strength)
    want = jcm.color_match(jnp.asarray(images), jnp.asarray(reference),
                           strength)
    assert _err(got, want) <= RGB_TOL


# --------------------------------------------------------------------------
# sharpen
# --------------------------------------------------------------------------

@pytest.mark.parametrize("border", ["zero", "edge"])
@pytest.mark.parametrize("kind,strength", [("unsharp", 1.5),
                                           ("laplacian", 0.8),
                                           ("sobel", 0.6)])
def test_sharpen_kinds_and_borders_match_jax(kind, strength, border):
    fns = {"unsharp": (tsharpen.unsharp, jsharpen.unsharp),
           "laplacian": (tsharpen.laplacian_sharpen,
                         jsharpen.laplacian_sharpen),
           "sobel": (tsharpen.sobel_sharpen, jsharpen.sobel_sharpen)}
    port, ref = fns[kind]
    frames = _rgb((2, 9, 14, 3), 14)
    got = port(torch.from_numpy(frames), strength, border)
    want = ref(jnp.asarray(frames), strength, border)
    assert _err(got, want) <= RGB_TOL


def test_box_blur_matches_jax():
    frames = _rgb((1, 6, 7, 3), 15)
    for border in ("zero", "edge"):
        got = tsharpen.box_blur_3x3(torch.from_numpy(frames), border)
        assert _err(got, jsharpen.box_blur_3x3(jnp.asarray(frames),
                                               border)) <= RGB_TOL


# --------------------------------------------------------------------------
# grain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's Philox4x32-10 known-answer vectors: the 16-bit-limb
    multiply keeps every word exact in int64."""
    words = [torch.tensor([c], dtype=torch.int64) for c in counter]
    got = tgrain.philox4x32_10(words, key[0], key[1])
    assert tuple(int(w) for w in got) == want


def test_grain_statistics():
    """Unit normal noise; at saturation_mix=1 the channel stds are in the
    ratio 2:1:3; at 0 every channel is the green noise."""
    noise = tgrain.grain_noise([0, 1], 128, 128, seed=5, device="cpu")
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 1.0) < 0.02
    field = tgrain.grain_field([3], 128, 128, 1.0, 9, "cpu")
    std = field.reshape(-1, 3).std(dim=0)
    assert abs(float(std[0] / std[1]) - 2.0) < 0.06
    assert abs(float(std[2] / std[1]) - 3.0) < 0.09
    mono = tgrain.grain_field([3], 16, 16, 0.0, 9, "cpu")
    assert torch.equal(mono[..., 0], mono[..., 1])
    assert torch.equal(mono[..., 2], mono[..., 1])


def test_grain_distribution_matches_jax():
    """Different streams, same distribution: per-channel std within 5%."""
    ours = tgrain.grain_field([0, 1], 96, 96, 0.5, 42, "cpu")
    theirs = np.asarray(jgrain.grain_field(jnp.arange(2), 96, 96, 0.5, 42))
    for c in range(3):
        a = float(ours[..., c].std())
        b = float(theirs[..., c].std())
        assert abs(a / b - 1.0) < 0.05, (c, a, b)


def test_film_grain_determinism_and_batch_split():
    frames = torch.from_numpy(_rgb((6, 10, 12, 3), 16))
    whole = tgrain.film_grain(frames, 0.05, 0.5, 42, frame_start=4)
    again = tgrain.film_grain(frames, 0.05, 0.5, 42, frame_start=4)
    split = torch.cat([tgrain.film_grain(frames[:2], 0.05, 0.5, 42, 4),
                       tgrain.film_grain(frames[2:], 0.05, 0.5, 42, 6)])
    assert torch.equal(whole, again) and torch.equal(whole, split)
    assert float(whole.min()) >= 0.0 and float(whole.max()) <= 1.0
    # frame i depends only on seed + i: a shifted start shifts the field
    shifted = tgrain.film_grain(frames[1:], 0.05, 0.5, 43, frame_start=4)
    assert torch.equal(shifted, whole[1:])


def test_film_grain_alpha_passthrough():
    frames = torch.from_numpy(_rgb((1, 4, 5, 4), 17))
    out = tgrain.film_grain(frames, 0.1, 0.5, 1)
    assert torch.equal(out[..., 3], frames[..., 3])
    assert not torch.equal(out[..., :3], frames[..., :3])
