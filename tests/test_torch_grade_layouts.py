"""The layouts of the port's fused grade (``fused_post_gather(layout=...,
emit=...)`` in vrgdg_tpu_torch.kernels.grade_cuda) against
vrgdg_tpu.kernels.grade_pallas.fused_post_gather.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, with grain off because the interpreter
stubs the TPU's random bits (tests/test_grade_pallas.py:3-9).  Bound: RGB
2e-5, the JAX suite's own Pallas-vs-XLA bound (identical formulas, other
reduction order of the colour-match statistics).  The port's plain
layouts run one set of formulas on the same BHWC tensors, so they agree
with one another exactly, grain on or off.  The kernels are held against
these plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core.cube import build_palette_lut
from vrgdg_tpu.core.params import AdjustSettings as JaxAdjust
from vrgdg_tpu.kernels.grade_pallas import fused_post_gather
from vrgdg_tpu.ops.color_match import lab_statistics
from vrgdg_tpu.ops.grade import _bundle_for
from vrgdg_tpu_torch.core.params import AdjustSettings
from vrgdg_tpu_torch.kernels import build
from vrgdg_tpu_torch.kernels import grade_cuda as gc

RGB_TOL = 2e-5
LAYOUTS = ("flat", "rowmajor", "plane")
KW = dict(blend=0.8, match_strength=0.7, sharpen_strength=1.5,
          saturation_mix=0.5)


@pytest.fixture(scope="module")
def operands():
    lut = build_palette_lut("#0b1d51, #1f6aa5, #f3d27a", 17)
    reference = np.random.default_rng(3).uniform(
        0, 1, (1, 32, 32, 3)).astype(np.float32)
    ref_mean, ref_std = (np.array(a) for a in
                         lab_statistics(jnp.asarray(reference)))
    return (np.array(_bundle_for(lut)), np.zeros(3, np.float32),
            np.ones(3, np.float32), ref_mean, ref_std)


def _jax(operands, frames, **kw):
    return np.asarray(fused_post_gather(
        jnp.asarray(frames), *(jnp.asarray(a) for a in operands),
        jnp.zeros(1, jnp.int32), grain_intensity=0.0, interpret=True,
        **KW, **kw))


def _port(operands, frames, seed=0, grain=0.0, **kw):
    t = torch.from_numpy
    return gc.fused_post_gather_plain(
        t(frames), *(t(a) for a in operands), seed, grain_intensity=grain,
        **KW, **kw)


def _frames(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 32, 256, 3), (1, 27, 129, 3)])
def test_layout_plain_matches_pallas_interpret(operands, shape, layout):
    frames = _frames(shape, 21)
    want = _jax(operands, frames, layout=layout)
    got = _port(operands, frames, layout=layout)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err < RGB_TOL, (shape, layout, err)


@pytest.mark.parametrize("shape", [(2, 32, 256, 3), (1, 27, 129, 3)])
def test_emit_planes_matches_pallas_interpret(operands, shape):
    frames = _frames(shape, 22)
    want = _jax(operands, frames, layout="flat", emit="planes")
    got = _port(operands, frames, layout="flat", emit="planes")
    assert got.shape == want.shape == (shape[0], 3, shape[1], shape[2])
    assert float(np.max(np.abs(got.numpy() - want))) < RGB_TOL
    # off the flat layout the TPU package ignores emit; the port's planes
    # layouts return their own planes, the same numbers
    for layout in ("rowmajor", "plane"):
        planes = _port(operands, frames, layout=layout, emit="planes")
        assert torch.equal(planes, got), layout


def test_rowmajor_adjust_matches_pallas_interpret(operands):
    adjust = dict(temperature=22.0, exposure=-12.0, contrast=15.0,
                  vignette=35.0)
    frames = _frames((1, 27, 129, 3), 23)
    want = _jax(operands, frames, layout="rowmajor",
                adjust=JaxAdjust.normalize(adjust))
    got = _port(operands, frames, layout="rowmajor",
                adjust=AdjustSettings.normalize(adjust))
    assert float(np.max(np.abs(got.numpy() - want))) < RGB_TOL


def test_plane_layout_rejects_adjust_in_both_packages(operands):
    frames = _frames((1, 16, 128, 3), 24)
    with pytest.raises(ValueError, match="adjust requires layout"):
        _jax(operands, frames, layout="plane",
             adjust=JaxAdjust.normalize({"contrast": 10.0}))
    with pytest.raises(ValueError, match="adjust requires layout"):
        _port(operands, frames, layout="plane",
              adjust=AdjustSettings.normalize({"contrast": 10.0}))
    for package in (_jax, _port):
        with pytest.raises(ValueError, match="Unknown layout"):
            package(operands, frames, layout="tiled")
    with pytest.raises(ValueError, match="Unknown emit"):
        _port(operands, frames, emit="bchw")


@pytest.mark.parametrize("grain", [0.0, 0.05])
@pytest.mark.parametrize("shape", [(3, 20, 33, 3), (1, 9, 130, 3)])
def test_port_layouts_agree_with_one_another(operands, shape, grain):
    frames = _frames(shape, 25)
    flat = _port(operands, frames, seed=47, grain=grain)
    for layout in ("rowmajor", "plane"):
        got = _port(operands, frames, seed=47, grain=grain, layout=layout)
        assert torch.equal(got, flat), layout


def test_corner_planes_and_planes_phases_on_cpu(operands):
    """The corner gather holds the bundle rows corner-major; the planes
    wrappers run their plain versions on the CPU and launch nothing."""
    bundle = torch.from_numpy(operands[0])
    frames = torch.from_numpy(_frames((2, 5, 7, 3), 26))
    domain = torch.tensor([[0.0] * 3, [1.0] * 3])
    src_planes = frames.permute(3, 0, 1, 2).contiguous()
    planes = gc.corner_planes(src_planes, bundle, domain)
    assert planes.shape == (24, 2, 5, 7) and planes.is_contiguous()
    cell, _ = gc._lattice(frames, domain, 17)
    assert torch.equal(planes.permute(1, 2, 3, 0), bundle[cell])
    build.reset_launch_counts()
    lab, partials = gc.phase1_planes(src_planes, planes, domain, blend=0.8,
                                     lut_size=17)
    lab_flat, partials_flat = gc.phase1_plain(frames, bundle, domain,
                                              blend=0.8)
    assert torch.equal(lab, lab_flat.permute(0, 3, 1, 2))
    assert torch.equal(partials, partials_flat)
    coeff = torch.tensor([[1.0, 1.1, 0.9, 0.5, -1.0, 2.0]] * 2)
    kw = dict(sharpen_strength=1.5, grain_intensity=0.05, saturation_mix=0.5,
              seed_base=42)
    assert torch.equal(gc.phase2_planes(lab, coeff, **kw),
                       gc.phase2_plain(lab_flat, coeff, **kw)
                       .permute(0, 3, 1, 2))
    assert all(count == 0 for count in build.LAUNCHES.values())
    with pytest.raises(ValueError, match=r"\(24, B, H, W\)"):
        gc.phase1_planes(src_planes, planes[:8], domain, blend=0.8,
                         lut_size=17)
    with pytest.raises(ValueError, match=r"\(B, 3, H, W\)"):
        gc.phase2_planes(lab.permute(0, 2, 3, 1), coeff, **kw)
