"""The standalone grain kernel's module (vrgdg_tpu_torch.kernels.grain_cuda)
and the grade's ``grain_mode`` against vrgdg_tpu.

On the CPU the wrapper runs its plain version, the port's ``film_grain``.
The JAX side runs ``film_grain_pallas`` in interpret mode, whose stubbed
random bits give zero noise (tests/test_grain_pallas.py:3-9).  So the
plumbing (padding, crop, alpha, clamping, intensity 0) is held exactly by
feeding the port zero noise too, and the noise itself by its statistics:
the bounds of tests/test_grain_pallas.py:84-87 (std ratios 2 and 3 within
5%, std 1 within 5%, mean 0 within 0.02 over 196,608 values per channel).
The kernel is held against this plain version value for value on the card
by chip_smoke.py and tests/test_torch_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core import params as jparams
from vrgdg_tpu.kernels.grain_pallas import film_grain_pallas
from vrgdg_tpu.ops.grade import GradeConfig as JaxConfig
from vrgdg_tpu_torch.core import params as tparams
from vrgdg_tpu_torch.kernels import build, grain_cuda
from vrgdg_tpu_torch.ops import grain as tgrain

tgrade = importlib.import_module("vrgdg_tpu_torch.ops.grade")


def _zero_noise(frame_indices, height, width, seed, device, row_start=0):
    batch = len(torch.as_tensor(frame_indices).reshape(-1))
    return torch.zeros((batch, height, width, 3), device=device)


def _frames(shape, seed=0, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(
        low, high, shape).astype(np.float32)


@pytest.mark.parametrize("shape,intensity", [
    ((2, 30, 50, 3), 0.1),          # pads to 16 rows / 128 px on the TPU
    ((1, 16, 128, 3), 0.0),         # intensity 0: clip(x)
    ((1, 17, 129, 4), 0.2),         # alpha passes through
    ((1, 16, 128, 3), 1.0),         # clamping
])
def test_plumbing_matches_pallas_interpret(monkeypatch, shape, intensity):
    frames = _frames(shape, low=-0.2, high=1.2)
    want = np.asarray(film_grain_pallas(jnp.asarray(frames), intensity, 0.5,
                                        seed=11, frame_start=3))
    monkeypatch.setattr(tgrain, "grain_noise", _zero_noise)
    got = grain_cuda.film_grain_kernel(torch.from_numpy(frames), intensity,
                                       0.5, 11, frame_start=3)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_real_noise_stays_in_range_and_keeps_alpha():
    frames = _frames((1, 16, 128, 4), seed=1)
    frames[..., :3] = 0.99
    got = grain_cuda.film_grain_kernel(torch.from_numpy(frames), 1.0, 1.0,
                                       seed=2).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert np.array_equal(got[..., 3], frames[..., 3])
    assert not np.array_equal(got[..., :3], np.clip(frames[..., :3], 0, 1))


def test_noise_statistics():
    """tests/test_grain_pallas.py:79-87, on the port's plain version."""
    frames = torch.full((4, 128, 128, 3), 0.5)
    out = grain_cuda.film_grain_kernel(frames, 0.01, 1.0, seed=3)
    noise = ((out - 0.5) / 0.01).numpy()
    stds = noise.reshape(-1, 3).std(axis=0)
    np.testing.assert_allclose(stds[0] / stds[1], 2.0, rtol=0.05)
    np.testing.assert_allclose(stds[2] / stds[1], 3.0, rtol=0.05)
    np.testing.assert_allclose(stds[1], 1.0, rtol=0.05)
    np.testing.assert_allclose(noise.mean(), 0.0, atol=0.02)


@pytest.mark.parametrize("cut", [1, 2, 5])
def test_batch_split_is_bit_identical(cut):
    frames = torch.from_numpy(_frames((6, 12, 20, 3), seed=4))
    whole = grain_cuda.film_grain_kernel(frames, 0.08, 0.5, 123, 7)
    parts = torch.cat([
        grain_cuda.film_grain_kernel(frames[:cut], 0.08, 0.5, 123, 7),
        grain_cuda.film_grain_kernel(frames[cut:], 0.08, 0.5, 123, 7 + cut)])
    assert torch.equal(whole, parts)


def test_wrapper_runs_the_plain_version_on_cpu():
    frames = torch.from_numpy(_frames((2, 9, 11, 3), seed=5))
    build.reset_launch_counts()
    got = grain_cuda.film_grain_kernel(frames, 0.05, 0.3, 42, frame_start=5)
    assert torch.equal(got, tgrain.film_grain(frames, 0.05, 0.3, 42, 5))
    assert build.LAUNCHES["film_grain"] == 0
    with pytest.raises(ValueError, match="C>=3"):
        grain_cuda.film_grain_kernel(torch.zeros((1, 4, 4, 2)), 0.05, 0.5, 1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        grain_cuda.film_grain_kernel(torch.zeros((1, 4, 4, 3), device="meta"),
                                     0.05, 0.5, 1)


def _grain_configs(mode):
    common = dict(sharpen=tparams.SharpenParams.normalize(1.0),
                  grain=tparams.GrainParams.normalize(0.1, 0.5, seed=3))
    return tgrade.GradeConfig(grain_mode=mode, **common)


@pytest.mark.parametrize("frame_start", [0, 9])
def test_grade_grain_mode_kernel_equals_eager_on_cpu(frame_start):
    frames = torch.from_numpy(_frames((2, 16, 40, 3), seed=6))
    eager = tgrade.grade(frames, _grain_configs("eager"),
                         frame_start=frame_start)
    kernel = tgrade.grade(frames, _grain_configs("kernel"),
                          frame_start=frame_start)
    assert torch.equal(eager, kernel)
    with pytest.raises(ValueError, match="Unknown grain_mode"):
        tgrade.grade(frames, _grain_configs("pallas"))


@pytest.mark.parametrize("jax_mode,port_mode", [("threefry", "eager"),
                                                ("pallas", "kernel")])
def test_from_reference_carries_grain_mode(jax_mode, port_mode):
    """A JAX config with ``grain_mode="pallas"`` used to come across with
    the port's default grain and no error; it now maps to ``"kernel"``."""
    config = JaxConfig(sharpen=jparams.SharpenParams.normalize(1.0),
                       grain=jparams.GrainParams.normalize(0.1, 0.5, seed=3),
                       grain_mode=jax_mode)
    zeros, ones = np.zeros(3, np.float32), np.ones(3, np.float32)
    port, operands = tgrade.from_reference(
        config, lut_table=np.zeros((2, 2, 2, 3), np.float32),
        domain_min=zeros, domain_max=ones, ref_mean=zeros, ref_std=ones,
        device="cpu")
    assert port.grain_mode == port_mode
    frames = torch.from_numpy(_frames((1, 16, 40, 3), seed=7))
    got = tgrade.grade_prepared(frames, port, *operands, frame_start=2)
    assert torch.equal(got, tgrade.grade(frames, _grain_configs(port_mode),
                                         frame_start=2))
