"""The port's resampling (vrgdg_tpu_torch.ops.resize) against vrgdg_tpu's on
the same seeded inputs.

Bounds: the tap-gather methods (nearest, nearest-exact, bilinear, bicubic,
area) <= 2e-5, the JAX suite's torch-parity budget; lanczos4 <= 1e-5
against JAX's exact float32 products on the CPU (the two dense products
sum the same eight nonzero taps per output, in another order) and
<= 1e-3 against cv2's INTER_LANCZOS4, the JAX suite's cv2 budget; the fit
modes and their inverses <= 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.ops import resize as jrz
from vrgdg_tpu_torch.ops import resize as trz

TAP_METHODS = ["nearest", "nearest-exact", "bilinear", "bicubic", "area"]
# down, up, mixed, one axis only
SIZES = [(12, 16), (48, 64), (17, 40), (24, 50)]


def _imgs(seed=0, shape=(2, 24, 32, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _both(fn_name, imgs, *args):
    want = np.asarray(getattr(jrz, fn_name)(jnp.asarray(imgs), *args))
    got = getattr(trz, fn_name)(torch.from_numpy(np.array(imgs)),
                                *args).numpy()
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("method", TAP_METHODS + ["lanczos4"])
@pytest.mark.parametrize("out_hw", SIZES)
def test_resample_matches_jax(method, out_hw):
    got, want = _both("resample", _imgs(), out_hw[0], out_hw[1], method)
    bound = 1e-5 if method == "lanczos4" else 2e-5
    assert np.max(np.abs(got - want)) <= bound, (method, out_hw)


@pytest.mark.parametrize("out_hw", [(12, 16), (48, 64), (30, 40)])
def test_lanczos4_cv2_parity(out_hw):
    cv2 = pytest.importorskip("cv2")
    imgs = _imgs(seed=1, shape=(1, 24, 32, 3))
    got = trz.resample(torch.from_numpy(imgs), out_hw[0], out_hw[1],
                       "lanczos4").numpy()
    want = cv2.resize(imgs[0], (out_hw[1], out_hw[0]),
                      interpolation=cv2.INTER_LANCZOS4)
    assert np.max(np.abs(got[0] - want)) <= 1e-3, out_hw


@pytest.mark.parametrize("fit", ["stretch", "crop", "letterbox"])
@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos4"])
def test_resize_and_restore_batch_match_jax(fit, method):
    imgs = _imgs(seed=2, shape=(2, 20, 40, 4))
    got, want = _both("resize_batch", imgs, 30, 26, fit, method)
    assert got.shape == (2, 26, 30, 3)
    assert np.max(np.abs(got - want)) <= 2e-5
    back, back_want = _both("restore_batch", want, 40, 20, fit, method)
    assert back.shape == (2, 20, 40, 3)
    assert np.max(np.abs(back - back_want)) <= 2e-5


@pytest.mark.parametrize("args", [(24, 32, "bilinear"), (32, 24, "bicubic"),
                                  (7, 19, "lanczos4"), (19, 7, "area"),
                                  (10, 10, "nearest"), (10, 10, "area"),
                                  (9, 4, "nearest-exact")])
def test_weight_tables_copy(args):
    np.testing.assert_array_equal(jrz.resample_matrix(*args),
                                  trz.resample_matrix(*args))
    for a, b in zip(jrz._tap_plan(*args), trz._tap_plan(*args)):
        np.testing.assert_array_equal(a, b)


def test_name_tables_copy():
    assert jrz._FIT_ALIASES == trz._FIT_ALIASES
    assert jrz._METHOD_ALIASES == trz._METHOD_ALIASES
    for name in ("Fit with letterbox (preserve all)", "crop", "bogus"):
        outcomes = []
        for module in (jrz, trz):
            try:
                outcomes.append(module.canonical_fit_mode(name))
            except ValueError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        trz.resample(torch.zeros(1, 8, 8, 3), 12, 12, "bogus")


def test_lanczos4_batch_split_is_bit_identical():
    """Each frame runs alone through the same products, so a frame's bits
    do not depend on its batch."""
    frames = torch.from_numpy(_imgs(seed=3, shape=(4, 18, 30, 3)))
    whole = trz.resample(frames, 40, 64, "lanczos4")
    split = torch.cat([trz.resample(frames[0:1], 40, 64, "lanczos4"),
                       trz.resample(frames[1:4], 40, 64, "lanczos4")])
    assert torch.equal(whole, split)


def test_ieee_fp32_matmul_restores_the_process_setting():
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    try:
        for setting in (True, False):
            flags.allow_tf32 = setting
            with trz._ieee_fp32_matmul():
                assert flags.allow_tf32 is False
            assert flags.allow_tf32 is setting
        flags.allow_tf32 = True
        frames = torch.from_numpy(_imgs(seed=4, shape=(1, 12, 16, 3)))
        with_tf32 = trz.resample(frames, 30, 40, "lanczos4")
        flags.allow_tf32 = False
        assert torch.equal(with_tf32, trz.resample(frames, 30, 40, "lanczos4"))
    finally:
        flags.allow_tf32 = saved


def test_letterbox_pads_with_zeros_centered():
    out = trz.resize_batch(torch.ones(1, 10, 40, 3), 40, 40, "letterbox",
                           "bilinear").numpy()
    assert np.allclose(out[0, :15], 0.0) and np.allclose(out[0, 25:], 0.0)
    assert np.allclose(out[0, 15:25], 1.0, atol=1e-5)


def test_equal_size_is_identity_and_keeps_dtype():
    frames = torch.from_numpy(_imgs(seed=5, shape=(1, 8, 8, 3)))
    assert trz.resample(frames, 8, 8, "lanczos4") is frames
    half = frames.to(torch.float64)
    assert trz.resample(half, 16, 16, "bicubic").dtype == torch.float64
