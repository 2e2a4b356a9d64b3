"""The port's mesh sharding (vrgdg_tpu_torch.parallel) on CPU devices,
against one device and against vrgdg_tpu.parallel on the JAX suite's 8
virtual CPU devices (tests/conftest.py).

The port's meshes name ``torch.device("cpu")`` eight times: the shard
arithmetic (padding, per-shard ``frame_start``, halos, the statistics
reduction, the gather and the trim) runs as on eight cards.

Bounds: frame-axis sharding (eager and fused) is bit-identical to one
device, grain on; height sharding is within 1e-5 of one device (the
colour-match statistics are float64 partial sums reduced in another
order); against the JAX package with grain off (the grain streams differ
by design), 1e-5 for the exact stages and 1e-3 with colour match, the
tolerances of ROADMAP.md's north star.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core import cube as jcube
from vrgdg_tpu.core import params as jparams
from vrgdg_tpu.ops.color_match import lab_statistics as jax_lab_statistics
from vrgdg_tpu.ops.grade import GradeConfig as JaxConfig
from vrgdg_tpu.ops.grade import prepare_operands as jax_prepare
from vrgdg_tpu.parallel import grade_on_mesh as jax_grade_on_mesh
from vrgdg_tpu.parallel import make_mesh as jax_make_mesh
from vrgdg_tpu.parallel import pad_to_multiple as jax_pad
from vrgdg_tpu_torch.core import cube as tcube
from vrgdg_tpu_torch.core.params import (AdjustSettings, ColorMatchParams,
                                         GrainParams, LUTParams,
                                         SharpenParams)
from vrgdg_tpu_torch.ops.grade import GradeConfig, from_reference, grade
from vrgdg_tpu_torch.parallel import (DATA_AXIS, SPACE_AXIS, grade_on_mesh,
                                      make_mesh, pad_to_multiple,
                                      replicated, shard_clip)
from vrgdg_tpu_torch.parallel import distributed as tdist
from vrgdg_tpu_torch.parallel.spatial import HeightShards

CPU = torch.device("cpu")
PALETTE = "#0b1d51, #f3d27a"
LUT = tcube.build_palette_lut(PALETTE, 17)
CFG = GradeConfig(lut=LUTParams.normalize(7.0),
                  sharpen=SharpenParams.normalize(1.5),
                  grain=GrainParams.normalize(0.06, 0.5, seed=9))


def _imgs(seed=0, shape=(8, 16, 16, 3)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))


def _mesh(n=8, spatial=1):
    return make_mesh(n, spatial=spatial, devices=[CPU] * n)


# --------------------------------------------------------------------------
# meshes, padding, placement
# --------------------------------------------------------------------------

def test_mesh_shapes():
    mesh = _mesh(8, spatial=2)
    assert mesh.shape == {DATA_AXIS: 4, SPACE_AXIS: 2}
    assert mesh.size == 8 and len(mesh.devices) == 4
    assert mesh.axis_names == ("data", "space")
    with pytest.raises(ValueError, match="spatial groups of 4"):
        make_mesh(6, spatial=4, devices=[CPU] * 8)


def test_oversize_mesh_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="9 devices.*only 8"):
        make_mesh(9, devices=[CPU] * 8)
    monkeypatch.delenv(tdist.ENV_LOCAL_DEVICE_IDS, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="3 devices.*only 2 cards"):
        make_mesh(3)
    mesh = make_mesh(2)
    assert mesh.devices == ((torch.device("cuda", 0),),
                            (torch.device("cuda", 1),))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no card is visible"):
        make_mesh()


def test_default_mesh_names_each_card_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv(tdist.ENV_LOCAL_DEVICE_IDS, "2,3")
    assert make_mesh(spatial=2).devices == (
        (torch.device("cuda", 2), torch.device("cuda", 3)),)
    monkeypatch.setenv(tdist.ENV_LOCAL_DEVICE_IDS, "1,1")
    with pytest.raises(ValueError, match="distinct"):
        make_mesh()
    monkeypatch.setenv(tdist.ENV_LOCAL_DEVICE_IDS, "4")
    with pytest.raises(ValueError, match="among the 4 visible"):
        make_mesh()


@pytest.mark.parametrize("count,multiple", [(5, 8), (5, 5), (11, 8)])
def test_pad_to_multiple_matches_jax(count, multiple):
    imgs = _imgs(4, (count, 4, 4, 3))
    padded, length = pad_to_multiple(imgs, multiple)
    want, want_length = jax_pad(jnp.asarray(imgs.numpy()), multiple)
    assert length == want_length == count
    np.testing.assert_array_equal(padded.numpy(), np.asarray(want))


def test_shard_clip_places_on_mesh():
    shards, count = shard_clip(_imgs(5, (11, 8, 8, 3)), _mesh(8))
    assert count == 11 and len(shards) == 8
    assert all(s.shape == (2, 8, 8, 3) for s in shards)
    torch.testing.assert_close(shards[-1][1], shards[-1][0], rtol=0, atol=0)
    spatial, _ = shard_clip(_imgs(5, (8, 8, 8, 3)), _mesh(8, 4),
                            spatial=True)
    assert all(isinstance(s, HeightShards) for s in spatial)
    assert spatial[0].starts == [0, 2, 4, 6, 8]
    with pytest.raises(ValueError, match="must divide the spatial"):
        shard_clip(_imgs(5, (8, 6, 8, 3)), _mesh(8, 4), spatial=True)
    assert replicated(_mesh(8)) == [CPU]


# --------------------------------------------------------------------------
# frame-axis data parallelism: bit-identical to one device
# --------------------------------------------------------------------------

@pytest.mark.parametrize("count", [8, 11])
def test_frame_sharded_grade_bit_identical(count):
    imgs = _imgs(1, (count, 16, 16, 3))
    single = grade(imgs, CFG, lut=LUT, frame_start=5)
    sharded = grade_on_mesh(imgs, CFG, _mesh(8), lut=LUT, frame_start=5)
    assert sharded.shape == single.shape
    assert torch.equal(sharded, single)


def test_fused_mode_on_the_plain_kernels_bit_identical():
    reference = _imgs(3, (1, 16, 16, 3))
    config = GradeConfig(
        lut=LUTParams.normalize(8.0),
        adjust=AdjustSettings.normalize({"contrast": 12, "vignette": 20}),
        color_match=ColorMatchParams.normalize(0.7),
        sharpen=SharpenParams.normalize(1.5, border="zero"),
        grain=GrainParams.normalize(0.05, 0.5, seed=42), fused_mode="fused")
    imgs = _imgs(2, (7, 16, 24, 3))
    single = grade(imgs, config, lut=LUT, reference=reference, frame_start=2)
    sharded = grade_on_mesh(imgs, config, _mesh(4), lut=LUT,
                            reference=reference, frame_start=2)
    assert torch.equal(sharded, single)


# --------------------------------------------------------------------------
# against vrgdg_tpu.parallel.grade_on_mesh (grain off)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("stages,bound", [
    ("exact", 1e-5),
    ("color_match", 1e-3),
])
def test_matches_jax_grade_on_mesh(stages, bound, spatial):
    rng = np.random.default_rng(6)
    frames = rng.uniform(0, 1, (6, 32, 16, 3)).astype(np.float32)
    reference = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    jconfig = JaxConfig(
        lut=jparams.LUTParams.normalize(7.0),
        adjust=jparams.AdjustSettings.normalize({"clarity": 30,
                                                 "sharpen": 10,
                                                 "vignette": 20}),
        color_match=(jparams.ColorMatchParams.normalize(0.8)
                     if stages == "color_match" else None),
        sharpen=jparams.SharpenParams.normalize(2.0))
    jlut = jcube.build_palette_lut(PALETTE, 17)
    ref_stats = tuple(np.array(a) for a in
                      jax_lab_statistics(jnp.asarray(reference)))
    want = np.asarray(jax_grade_on_mesh(
        jnp.asarray(frames), jconfig, jax_make_mesh(8, spatial=4),
        lut=jlut, ref_stats=ref_stats, spatial=spatial))
    operands = [np.array(a) for a in
                jax_prepare(jconfig, lut=jlut, ref_stats=ref_stats)]
    config, _ = from_reference(
        jconfig, lut_table=operands[0], domain_min=operands[1],
        domain_max=operands[2], ref_mean=operands[3], ref_std=operands[4],
        device="cpu")
    got = grade_on_mesh(torch.from_numpy(frames), config, _mesh(8, 4),
                        lut=LUT, ref_stats=ref_stats, spatial=spatial)
    assert float(np.abs(got.numpy() - want).max()) <= bound


# --------------------------------------------------------------------------
# height sharding: within 1e-5 of one device, term by term
# --------------------------------------------------------------------------

SPATIAL_TERMS = {
    # (a) clarity: 9 taps (a 4-row halo, as tall as a shard here), reflect
    # padding at the true frame edges only, the kernel sized from the frame
    "a_clarity": (dict(adjust={"clarity": 30}), (3, 16, 24)),
    # (a) the kernel shrinks with the whole frame's width (7 taps)
    "a_clarity_narrow": (dict(adjust={"clarity": -40}), (3, 32, 7)),
    # (b) the sharpen slider (edge border), then each final stencil
    "b_sharpen_unsharp_zero": (dict(adjust={"sharpen": 10},
                                    sharpen=("unsharp", "zero")), (3, 16, 16)),
    "b_unsharp_edge": (dict(sharpen=("unsharp", "edge")), (3, 16, 16)),
    "b_laplacian_zero": (dict(sharpen=("laplacian", "zero")), (3, 16, 16)),
    "b_sobel_edge": (dict(sharpen=("sobel", "edge")), (3, 16, 16)),
    # (c) the vignette's distance from the whole frame's centre
    "c_vignette": (dict(adjust={"vignette": 60, "fade": 10}), (3, 16, 16)),
    # (d) grain keyed on each pixel's row in the whole frame
    "d_grain": (dict(grain=True), (5, 16, 16)),
    # (e) colour match: per-frame statistics over the whole frame
    "e_color_match": (dict(color_match=True), (3, 32, 16)),
}


def _spatial_config(adjust=None, sharpen=None, grain=False,
                    color_match=False):
    return GradeConfig(
        lut=LUTParams.normalize(6.0),
        adjust=None if adjust is None else AdjustSettings.normalize(adjust),
        color_match=ColorMatchParams.normalize(0.8) if color_match else None,
        sharpen=(None if sharpen is None else SharpenParams.normalize(
            1.2, border=sharpen[1], kind=sharpen[0])),
        grain=GrainParams.normalize(0.07, 0.4, seed=3) if grain else None)


@pytest.mark.parametrize("term", sorted(SPATIAL_TERMS))
def test_spatial_term_within_1e5(term):
    options, (count, height, width) = SPATIAL_TERMS[term]
    config = _spatial_config(**options)
    imgs = _imgs(7, (count, height, width, 3))
    reference = _imgs(8, (1, 16, 16, 3))
    single = grade(imgs, config, lut=LUT, reference=reference, frame_start=4)
    sharded = grade_on_mesh(imgs, config, _mesh(8, 4), lut=LUT,
                            reference=reference, frame_start=4, spatial=True)
    assert sharded.shape == single.shape
    assert float((sharded - single).abs().max()) <= 1e-5


def test_spatial_whole_stack_within_1e5():
    config = dataclasses.replace(
        _spatial_config(adjust={"clarity": 30, "sharpen": 10,
                                "contrast": 12, "vignette": 20},
                        sharpen=("unsharp", "zero"), grain=True,
                        color_match=True))
    imgs = _imgs(9, (5, 32, 24, 3))
    reference = _imgs(8, (1, 16, 16, 3))
    single = grade(imgs, config, lut=LUT, reference=reference)
    for mesh in (_mesh(8, 8), _mesh(2, 2)):
        sharded = grade_on_mesh(imgs, config, mesh, lut=LUT,
                                reference=reference, spatial=True)
        assert float((sharded - single).abs().max()) <= 1e-5


# --------------------------------------------------------------------------
# what the mesh refuses
# --------------------------------------------------------------------------

def test_fused_mode_refuses_spatial():
    config = dataclasses.replace(CFG, fused_mode="fused")
    with pytest.raises(ValueError, match="frame-axis"):
        grade_on_mesh(_imgs(), config, _mesh(8, 2), lut=LUT, spatial=True)


def test_grain_kernel_mode_is_refused_on_a_mesh():
    config = GradeConfig(grain=GrainParams.normalize(0.05),
                         grain_mode="kernel")
    with pytest.raises(ValueError, match="grain_mode='kernel'"):
        grade_on_mesh(_imgs(), config, _mesh(8))


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

def test_entry_on_the_cpu():
    from vrgdg_tpu_torch import entry

    forward, (frames,) = entry.entry("cpu")
    config, lut = entry._flagship_config("fused")
    assert config.fused_mode == "fused" and frames.shape == (4, 256, 256, 3)
    out = forward(frames)
    assert out.shape == frames.shape
    assert bool(torch.isfinite(out).all())


def test_dryrun_multichip_on_cpu_devices(monkeypatch):
    from vrgdg_tpu_torch.entry import dryrun_multichip

    # the scheduler's workers decode on a cv2 thread beside torch's
    # OpenMP pool; one thread keeps a tiny segment fast
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = dryrun_multichip(4, [CPU] * 4)
    finally:
        torch.set_num_threads(threads)
    assert result["mesh"] == {"data": 2, "space": 2}
    assert result["spatial_max_abs_err"] <= 1e-5
    assert (result["dp"], result["enhancer_dp"], result["fused_dp"],
            result["scheduler"]) == ("bit-identical",) * 3 + (
                "byte-identical",)
