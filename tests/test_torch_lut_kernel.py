"""Apply LUT's kernel route on the CPU: the ``lut_apply`` wrapper's checks,
and ``apply_lut_bundle``'s plain version, which CPU tensors keep.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` holds
it to the plain version bit for bit).  Here nothing may reach nvcc:
``build.load_libraries`` is replaced by a stub that fails the test.  The
plain version is held bit for bit to a frozen copy of the torch code it
had before the kernel existed, and to ``vrgdg_tpu.ops.lut.apply_lut_bundle``
within one float32 ulp at 1 (XLA's CPU fusions round a third of the lerps
to the other neighbour; ``tests/test_torch_ops.py`` holds the two to 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core.cube import corner_bundle as jax_corner_bundle
from vrgdg_tpu.ops import lut as jlut
from vrgdg_tpu_torch.core.cube import corner_bundle
from vrgdg_tpu_torch.kernels import build, lut_cuda
from vrgdg_tpu_torch.ops import lut as tlut

SIZES = (2, 17, 33)
STRENGTHS = (0.0, 3.7, 7.0, 10.0, 12.5, -1.0)
# unit; (0.1, 0.9); a green span under 1e-6, floored to 1e-6
DOMAINS = {"unit": (None, None),
           "narrow": ((0.1, 0.1, 0.1), (0.9, 0.9, 0.9)),
           "flat_green": ((0.1, 0.5, 0.0), (0.9, 0.5 + 5e-7, 1.0))}
ULP_AT_ONE = 2.0 ** -23


# -- the plain version as it was before the kernel, frozen -----------------

def _frozen_as_tensor(value, device, default):
    if value is None:
        return torch.full((3,), default, dtype=torch.float32, device=device)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def _frozen_coords(source, dmin, dmax, max_index):
    span = torch.clamp(dmax - dmin, min=1e-6)
    coords = torch.clamp((source - dmin) / span, 0.0, 1.0) * max_index
    lo = torch.floor(coords)
    frac = coords - lo
    return lo.to(torch.int64), frac


def _frozen_lerp(a, b, f):
    tail = (b * f).to(torch.float64)
    return (a.to(torch.float64) * (1.0 - f).to(torch.float64)
            + tail).to(torch.float32)


def _frozen_trilerp(corners, frac):
    fr, fg, fb = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    c00 = _frozen_lerp(corners[0], corners[1], fb)
    c01 = _frozen_lerp(corners[2], corners[3], fb)
    c10 = _frozen_lerp(corners[4], corners[5], fb)
    c11 = _frozen_lerp(corners[6], corners[7], fb)
    c0 = _frozen_lerp(c00, c01, fg)
    c1 = _frozen_lerp(c10, c11, fg)
    return torch.clamp(_frozen_lerp(c0, c1, fr), 0.0, 1.0)


def _frozen_finish(frames, source, graded, strength):
    blend = torch.clamp(torch.tensor(float(strength), dtype=torch.float32,
                                     device=frames.device), 0.0, 10.0) / 10.0
    mixed = _frozen_lerp(source, graded, blend).to(frames.dtype)
    if frames.shape[-1] > 3:
        out = frames.clone()
        out[..., :3] = mixed
        return out
    return mixed


def _frozen_apply_lut_bundle(frames, bundle, domain_min=None,
                             domain_max=None, strength=10.0):
    device = frames.device
    size = round(bundle.shape[0] ** (1.0 / 3.0))
    dmin = _frozen_as_tensor(domain_min, device, 0.0)
    dmax = _frozen_as_tensor(domain_max, device, 1.0)
    source = frames[..., :3].to(torch.float32)
    lo, frac = _frozen_coords(source, dmin, dmax, size - 1)
    cell = (lo[..., 2] * size + lo[..., 1]) * size + lo[..., 0]
    rows = bundle.to(torch.float32)[cell]
    corners = [rows[..., 3 * k:3 * k + 3] for k in range(8)]
    return _frozen_finish(frames, source, _frozen_trilerp(corners, frac),
                          strength)


# -- helpers ---------------------------------------------------------------

@pytest.fixture()
def no_build(monkeypatch):
    """Any reach for a kernel library fails the test."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("the kernel libraries were asked for")

    monkeypatch.setattr(build, "load_libraries", refuse)
    monkeypatch.setattr(build, "library", refuse)


def _table(size: int, seed: int) -> np.ndarray:
    """A seeded lattice with values a little outside [0, 1]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.1, 1.1, (size, size, size, 3)).astype(np.float32)


def _frames(shape, seed: int) -> np.ndarray:
    """Seeded values from -0.25 to 1.25, and the unit cube's corners."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-0.25, 1.25, shape).astype(np.float32)
    frames.reshape(-1, shape[-1])[:2, :3] = [[0, 0, 0], [1, 1, 1]]
    return frames


def _domain(name):
    lo, hi = DOMAINS[name]
    if lo is None:
        return None, None
    return np.asarray(lo, np.float32), np.asarray(hi, np.float32)


# -- the wrapper's checks --------------------------------------------------

def _cpu_bundle(size=3):
    return torch.from_numpy(corner_bundle(_table(size, 1)))


@pytest.mark.parametrize("frames,bundle,match", [
    (torch.rand(1, 2, 2, 3), torch.zeros(27, 3), r"\(N\^3, 24\)"),
    (torch.rand(1, 2, 2, 3), torch.zeros(26, 24), "not N\\^3"),
    (torch.rand(1, 2, 2, 3), torch.zeros(1, 24), "N >= 2"),
    (torch.rand(1, 2, 2, 3), torch.zeros(2, 27, 24), r"\(N\^3, 24\)"),
    (torch.zeros(1, 2, 2, 3, dtype=torch.uint8), None, "floating point"),
    (torch.zeros(1, 2, 2, 3, dtype=torch.int32), None, "floating point"),
    (torch.rand(1, 2, 2, 2), None, "C>=3"),
    (torch.rand(1, 2, 2, 3), "float64", "float32"),
    (torch.rand(1, 2, 2, 3), "meta", "bundle on meta"),
    (torch.rand(1, 2, 2, 3), None, "no kernel for device cpu"),
])
def test_wrapper_refuses_before_any_build(no_build, frames, bundle, match):
    if bundle is None:
        bundle = _cpu_bundle()
    elif isinstance(bundle, str):
        bundle = (_cpu_bundle().double() if bundle == "float64"
                  else _cpu_bundle().to(bundle))
    with pytest.raises(ValueError, match=match):
        lut_cuda.lut_apply(frames, bundle, strength=7.0)


def test_wrapper_refuses_frames_on_another_device_than_the_bundle(no_build):
    frames = torch.rand(1, 2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="frames on meta but bundle on cpu"):
        lut_cuda.lut_apply(frames, _cpu_bundle())


@pytest.mark.parametrize("size", (2, 3, 17, 33, 65))
def test_lut_size_reads_n_from_the_bundle_rows(size):
    assert lut_cuda.lut_size(torch.zeros(size ** 3, 24)) == size


@pytest.mark.parametrize("strength", (*STRENGTHS, 0.1, 9.999, 1e30, -0.0,
                                      np.float32(7.3), 3))
def test_blend_factor_is_finish_s_float32_blend(strength):
    """The kernel's blend argument equals the 0-d float32 tensor that the
    plain version's ``_finish`` builds."""
    want = torch.clamp(torch.tensor(float(strength), dtype=torch.float32),
                       0.0, 10.0) / 10.0
    got = lut_cuda.blend_factor(strength)
    assert np.float32(got) == got
    assert torch.equal(torch.tensor(got, dtype=torch.float32), want)


# -- the plain version on the CPU ------------------------------------------

@pytest.mark.parametrize("domain", sorted(DOMAINS))
@pytest.mark.parametrize("strength", STRENGTHS)
@pytest.mark.parametrize("size", SIZES)
def test_cpu_frames_run_the_plain_version_unchanged(no_build, monkeypatch,
                                                    size, strength, domain):
    """On the CPU ``apply_lut_bundle`` never calls the kernel's wrapper, and
    gives the frozen torch code's bits and, within an ulp at 1, JAX's."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("lut_apply was called for CPU frames")

    monkeypatch.setattr(lut_cuda, "lut_apply", refuse)
    table = _table(size, size)
    frames = _frames((2, 9, 11, 4), size + 1)
    dmin, dmax = _domain(domain)
    bundle = torch.from_numpy(corner_bundle(table))
    got = tlut.apply_lut_bundle(torch.from_numpy(frames), bundle, dmin, dmax,
                                strength)
    want = _frozen_apply_lut_bundle(torch.from_numpy(frames), bundle, dmin,
                                    dmax, strength)
    assert torch.equal(got, want)
    assert torch.equal(got, tlut.apply_lut_bundle_plain(
        torch.from_numpy(frames), bundle, dmin, dmax, strength))
    assert torch.equal(got[..., 3], torch.from_numpy(frames[..., 3]))
    jax_out = np.asarray(jlut.apply_lut_bundle(
        jnp.asarray(frames), jnp.asarray(jax_corner_bundle(table)), dmin,
        dmax, strength))
    assert np.abs(got.numpy() - jax_out).max() <= ULP_AT_ONE


@pytest.mark.parametrize("dtype", (torch.float64, torch.float16,
                                   torch.bfloat16))
def test_cpu_plain_version_casts_other_floats_as_before(no_build, dtype):
    frames = torch.from_numpy(_frames((1, 5, 7, 4), 3)).to(dtype)
    bundle = torch.from_numpy(corner_bundle(_table(5, 4)))
    got = tlut.apply_lut_bundle(frames, bundle, strength=6.0)
    assert got.dtype == dtype
    assert torch.equal(got, _frozen_apply_lut_bundle(frames, bundle,
                                                     strength=6.0))
    assert torch.equal(got[..., 3], frames[..., 3])


def test_cpu_plain_version_takes_views_as_before(no_build):
    base = torch.from_numpy(_frames((2, 12, 10, 4), 8))
    view = base.transpose(1, 2)[:, 1::2, :, :3]
    assert not view.is_contiguous()
    bundle = torch.from_numpy(corner_bundle(_table(17, 9)))
    got = tlut.apply_lut_bundle(view, bundle, strength=10.0)
    assert torch.equal(got, _frozen_apply_lut_bundle(view, bundle,
                                                     strength=10.0))
    assert torch.equal(got, tlut.apply_lut_bundle(view.contiguous(), bundle,
                                                  strength=10.0))
