"""The port's paste-back and face composites (vrgdg_tpu_torch.ops.paste_back)
against vrgdg_tpu.ops.paste_back on the CPU, on the same seeded inputs.

Tolerances: masks, the mean shift and the blends <= 1e-5; composites whose
crop is resampled within the resampler's budget (bicubic and bilinear
<= 2e-5, lanczos4 <= 1e-5, as tests/test_torch_resize.py holds them).
The Gaussian feather is held with kernels that reach past the box, where
reflect-101 reflects again and again.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the packages' __init__ export a function named paste_back
jpb = importlib.import_module("vrgdg_tpu.ops.paste_back")
tpb = importlib.import_module("vrgdg_tpu_torch.ops.paste_back")

EXACT = 1e-5
BICUBIC = 2e-5
LANCZOS = 1e-5


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, err


def _rand(seed, shape, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", ["ellipse", "rect"])
@pytest.mark.parametrize("size,inset,feather", [
    ((40, 56), 8, 24), ((17, 9), 3, 5), ((64, 64), 0, 0), ((5, 80), 40, 2.5),
    ((1, 1), 0, 4)])
def test_soft_blend_mask(shape, size, inset, feather):
    _close(tpb.soft_blend_mask(*size, inset, feather, shape),
           jpb.soft_blend_mask(*size, inset, feather, shape), EXACT)


@pytest.mark.parametrize("strength,threshold,alpha_ndim", [
    (0.65, 0.25, 3), (1.0, 0.35, 2), (0.0, 0.25, 3), (0.5, 0.999, 2)])
def test_mean_shift_color_match(strength, threshold, alpha_ndim):
    source, target = _rand(1, (30, 44, 3)), _rand(2, (30, 44, 3))
    alpha = _rand(3, (30, 44, 1) if alpha_ndim == 3 else (30, 44))
    got = tpb.mean_shift_color_match(torch.from_numpy(source),
                                     torch.from_numpy(target),
                                     torch.from_numpy(alpha), strength,
                                     threshold)
    want = jpb.mean_shift_color_match(jnp.asarray(source),
                                      jnp.asarray(target), jnp.asarray(alpha),
                                      strength, threshold)
    _close(got, want, EXACT)


@pytest.mark.parametrize("box", [(20, 10, 70, 50), (60, 30, 140, 110),
                                 (200, 200, 240, 230)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_paste_back(box, with_mask):
    originals = _rand(4, (2, 90, 120, 3))
    crop = _rand(5, (1, 64, 64, 3))
    mask = _rand(6, (2, 16, 16)) if with_mask else None
    crop_data = ((120, 90), box)
    got = tpb.paste_back(torch.from_numpy(originals), torch.from_numpy(crop),
                         crop_data, inset_padding=4, feather_strength=10,
                         blend_shape="rect" if with_mask else "ellipse",
                         mask=None if mask is None else torch.from_numpy(mask))
    want = jpb.paste_back(jnp.asarray(originals), jnp.asarray(crop),
                          crop_data, inset_padding=4, feather_strength=10,
                          blend_shape="rect" if with_mask else "ellipse",
                          mask=None if mask is None else jnp.asarray(mask))
    _close(got[0], want[0], BICUBIC)
    _close(got[1], want[1], BICUBIC if with_mask else EXACT)


def test_paste_back_refuses_bad_crop_data():
    frame = torch.zeros((1, 8, 8, 3))
    for bad in (None, ((8, 8), (4, 4, 4, 6)), ((8, 8), "x")):
        with pytest.raises(ValueError):
            tpb.paste_back(frame, frame, bad)


def _entries():
    return [{"box": (10, 12, 74, 60), "strength": 1.0},
            {"box": None, "strength": 1.0},
            {"box": (30, 5, 90, 85), "strength": 0.65},
            {"box": (30, 5, 90, 85), "strength": 0.0},
            {"box": (0, 0, 37, 41), "strength": 0.3}]


@pytest.mark.parametrize("faces_short_by", [0, 2])
@pytest.mark.parametrize("feather,color_match", [(18, 0.65), (2, 0.0),
                                                  (60, 1.0)])
def test_radial_face_composite(faces_short_by, feather, color_match):
    originals = _rand(7, (5, 96, 128, 3))
    faces = _rand(8, (5 - faces_short_by, 64, 64, 3), 0.2, 0.9)
    got = tpb.radial_face_composite(torch.from_numpy(faces),
                                    torch.from_numpy(originals), _entries(),
                                    feather, color_match)
    want = jpb.radial_face_composite(jnp.asarray(faces),
                                     jnp.asarray(originals), _entries(),
                                     feather, color_match)
    _close(got[0], want[0], BICUBIC)
    _close(got[1], want[1], EXACT)
    assert got[2] == want[2]
    # the input frames are not written
    np.testing.assert_array_equal(originals, _rand(7, (5, 96, 128, 3)))


def test_radial_face_composite_refuses_a_large_drift():
    with pytest.raises(ValueError, match="returned 2 frames for 10"):
        tpb.radial_face_composite(torch.zeros((2, 8, 8, 3)),
                                  torch.zeros((10, 8, 8, 3)),
                                  [{"box": None}] * 10)


@pytest.mark.parametrize("length,kernel,sigma", [
    (40, 9, 2.0), (40, 73, 18.0), (12, 73, 18.0), (5, 1025, 256.0),
    (1, 25, 6.0), (33, 4, 1.0)])
def test_gaussian_blur_past_the_axis(length, kernel, sigma):
    """Kernels up to finalize's 1,025 taps (feather 256) on axes down to
    one pixel: the half-width reaches past the axis many times."""
    image = _rand(9, (length, length + 7))
    _close(tpb.gaussian_blur(torch.from_numpy(image), kernel, sigma),
           jpb.gaussian_blur(jnp.asarray(image), kernel, sigma), EXACT)


@pytest.mark.parametrize("size", [(48, 40), (100, 100), (9, 31), (3, 3)])
@pytest.mark.parametrize("feather", [0, 6, 18, 256])
def test_soft_ellipse_mask(size, feather):
    _close(tpb.soft_ellipse_mask(*size, feather),
           jpb.soft_ellipse_mask(*size, feather), EXACT)


@pytest.mark.parametrize("box,feather,strength", [
    ((20, 16, 84, 80), 18, 1.0), ((50, 30, 90, 70), 6, 0.65),
    ((0, 0, 128, 96), 256, 0.3), ((100, 60, 128, 96), 0, 1.7)])
def test_ellipse_composite(box, feather, strength):
    original = _rand(10, (96, 128, 3))
    enhanced = _rand(11, (64, 64, 3), 0.3, 1.0)
    got = tpb.ellipse_composite(torch.from_numpy(original),
                                torch.from_numpy(enhanced), box, feather,
                                0.65, strength)
    want = jpb.ellipse_composite(jnp.asarray(original), jnp.asarray(enhanced),
                                 box, feather, 0.65, strength)
    _close(got, want, LANCZOS)


def test_ellipse_composite_refuses_an_empty_box():
    frame = torch.zeros((8, 8, 3))
    with pytest.raises(ValueError, match="Invalid crop box"):
        tpb.ellipse_composite(frame, frame, (4, 4, 4, 6))
