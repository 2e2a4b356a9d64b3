"""The port's fused grade stack as a whole (vrgdg_tpu_torch.ops.grade, the
appliers and the CLI) against vrgdg_tpu, plus the port's import hygiene
and the copied JAX-free modules against their originals.

Bounds: float output <= 2e-5 against JAX's grade (``xla`` and interpreted
``pallas``) with grain off, the JAX suite's own Pallas-vs-XLA bound; the
uint8 chain (dequantize -> grade -> quantize) may differ from JAX's by one
level on at most 0.1% of the values (a ~1e-6 float difference flips the
truncation of the few values sitting on a level boundary).
"""

import glob
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.api import paths as jpaths
from vrgdg_tpu.core import cube as jcube
from vrgdg_tpu.core import params as jparams
from vrgdg_tpu.ops.color_match import lab_statistics as jax_lab_statistics
from vrgdg_tpu.ops.grade import GradeConfig as JaxConfig
from vrgdg_tpu.ops.grade import grade as jax_grade
from vrgdg_tpu.ops.grade import prepare_operands as jax_prepare
from vrgdg_tpu.runtime import video_io as jvideo_io
from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.api import paths as tpaths
from vrgdg_tpu_torch.core import cube as tcube
from vrgdg_tpu_torch.core import params as tparams
from vrgdg_tpu_torch.runtime import profiling, video_io

tgrade = importlib.import_module("vrgdg_tpu_torch.ops.grade")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUTS = os.path.join(REPO, "LUTS")
ADJUST = {"contrast": 12.0, "vignette": 20.0, "saturation": -10.0}


@pytest.fixture(scope="module")
def flagship():
    """The flagship stack on a real 33^3 LUT, carried across to the port."""
    lut = jcube.parse_cube(os.path.join(LUTS, "teal_orange.cube"))
    reference = np.random.default_rng(1).uniform(
        0, 1, (1, 24, 24, 3)).astype(np.float32)
    ref_stats = tuple(np.array(a) for a in
                      jax_lab_statistics(jnp.asarray(reference)))
    return lut, ref_stats


def _configs(mode, adjust=None, grain=None):
    return JaxConfig(
        lut=jparams.LUTParams.normalize(8.0),
        adjust=None if adjust is None else jparams.AdjustSettings.normalize(adjust),
        color_match=jparams.ColorMatchParams.normalize(0.7),
        sharpen=jparams.SharpenParams.normalize(1.5, border="zero"),
        grain=grain, fused_mode=mode)


def _port(config, lut, ref_stats):
    operands = [np.array(a) for a in
                jax_prepare(config, lut=lut, ref_stats=ref_stats)]
    return tgrade.from_reference(
        config, lut_table=operands[0], domain_min=operands[1],
        domain_max=operands[2], ref_mean=operands[3], ref_std=operands[4],
        device="cpu")


@pytest.mark.parametrize("adjust", [None, ADJUST])
@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_grade_matches_jax(flagship, mode, adjust):
    lut, ref_stats = flagship
    frames = np.random.default_rng(2).uniform(
        0, 1, (2, 27, 129, 3)).astype(np.float32)
    config = _configs(mode, adjust)
    want = np.asarray(jax_grade(jnp.asarray(frames), config, lut=lut,
                                ref_stats=ref_stats, frame_start=5))
    port, operands = _port(config, lut, ref_stats)
    got = tgrade.grade_prepared(torch.from_numpy(frames), port, *operands,
                                frame_start=5)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got.numpy() - want))) <= 2e-5


def test_eager_and_fused_agree_with_grain(flagship):
    """One Philox stream feeds both modes, so they agree with grain on."""
    lut, ref_stats = flagship
    grain = jparams.GrainParams.normalize(0.05, 0.5, 42)
    frames = torch.rand((3, 20, 33, 3),
                        generator=torch.Generator().manual_seed(3))
    eager, operands = _port(_configs("xla", ADJUST, grain), lut, ref_stats)
    fused, _ = _port(_configs("pallas", ADJUST, grain), lut, ref_stats)
    a = tgrade.grade_prepared(frames, eager, *operands, frame_start=7)
    b = tgrade.grade_prepared(frames, fused, *operands, frame_start=7)
    assert float((a - b).abs().max()) <= 2e-5
    again = tgrade.grade_prepared(frames, fused, *operands, frame_start=7)
    assert torch.equal(b, again)


def test_uint8_chain_matches_jax(flagship):
    lut, ref_stats = flagship
    u8 = np.random.default_rng(4).integers(0, 256, (2, 36, 64, 3), np.uint8)
    for mode in ("xla", "pallas"):
        config = _configs(mode, ADJUST)
        want = np.asarray(jvideo_io.quantize_on_device(jax_grade(
            jvideo_io.dequantize_on_device(jnp.asarray(u8)), config,
            lut=lut, ref_stats=ref_stats)))
        port, operands = _port(config, lut, ref_stats)
        got = video_io.quantize_on_device(tgrade.grade_prepared(
            video_io.dequantize_on_device(torch.from_numpy(u8)), port,
            *operands)).numpy()
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, mode


def test_fused_rules(flagship):
    lut, ref_stats = flagship
    port, operands = _port(_configs("pallas"), lut, ref_stats)
    # no 16-frame cap: the per-block partials hold any batch
    big = torch.rand((17, 4, 5, 3), generator=torch.Generator().manual_seed(5))
    assert tgrade.grade_prepared(big, port, *operands).shape == big.shape
    no_match = tgrade.GradeConfig(lut=port.lut, sharpen=port.sharpen,
                                  fused_mode="fused")
    with pytest.raises(ValueError, match="color-match"):
        tgrade.grade_prepared(big, no_match, *operands)
    edge = tgrade.GradeConfig(
        lut=port.lut, color_match=port.color_match,
        sharpen=tparams.SharpenParams.normalize(1.5), fused_mode="fused")
    with pytest.raises(ValueError, match="border"):
        tgrade.grade_prepared(big, edge, *operands)
    spatial = tgrade.GradeConfig(
        lut=port.lut, color_match=port.color_match, sharpen=port.sharpen,
        adjust=tparams.AdjustSettings.normalize({"clarity": 20}),
        fused_mode="fused")
    with pytest.raises(ValueError, match="spatial sliders"):
        tgrade.grade_prepared(big, spatial, *operands)
    with pytest.raises(ValueError, match="Unknown fused_mode"):
        tgrade.grade_prepared(big, tgrade.GradeConfig(
            lut=port.lut, fused_mode="pallas"), *operands)


def test_stream_pads_tail_batches_exactly(flagship):
    """The applier loop runs a short tail batch at its real length, with no
    pad frames; every frame equals its single-frame grade, at either
    dispatch depth."""
    _, ref_stats = flagship
    lut = tcube.parse_cube(os.path.join(LUTS, "teal_orange.cube"))
    ref_stats = tuple(torch.from_numpy(a) for a in ref_stats)
    config = appliers.grade_config(
        lut=lut, lut_strength=8.0, adjust=ADJUST, ref_stats=ref_stats,
        match_strength=0.7, sharpen_strength=1.5, grain_intensity=0.05,
        seed=42, fused_mode="fused")
    effect = appliers.grade_effect(config, "cpu", lut=lut,
                                   ref_stats=ref_stats)
    u8 = np.random.default_rng(6).integers(0, 256, (7, 12, 16, 3), np.uint8)
    batches = [(0, u8[0:3]), (3, u8[3:6]), (6, u8[6:7])]
    stats = {}
    outs = [appliers.stream_graded_batches(batches, effect, batch_size=3,
                                           device="cpu", dispatch_depth=d,
                                           stats=stats if d == 2 else None)
            for d in (1, 2)]
    shallow, deep = (np.concatenate(list(o)) for o in outs)
    assert deep.shape == (7, 12, 16, 3) and np.array_equal(deep, shallow)
    assert stats == {"frames": 7, "batches": 3}
    single = np.concatenate(list(appliers.stream_graded_batches(
        [(i, u8[i:i + 1]) for i in range(7)], effect, batch_size=1,
        device="cpu")))
    assert np.array_equal(deep, single)


def _clip(path, frames=10, size=(64, 36)):
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12.0,
                             size)
    rng = np.random.default_rng(7)
    for _ in range(frames):
        writer.write(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
    writer.release()
    return path


@pytest.mark.parametrize("mode", ["eager", "fused"])
def test_grade_video_on_a_clip(tmp_path, mode):
    clip = _clip(str(tmp_path / "clip.mp4"))
    result = appliers.grade_video(
        clip, str(tmp_path / "out.mp4"), lut_name="teal_orange.cube",
        lut_strength=8.0, adjust=ADJUST,
        reference_image=np.random.default_rng(8).uniform(
            0, 1, (16, 16, 3)).astype(np.float32),
        match_strength=0.7, sharpen_strength=1.5, grain_intensity=0.05,
        seed=42, batch_size=4, fused_mode=mode, device="cpu")
    assert result["processed_frames"] == 10 and result["device"] == "cpu"
    assert (result["width"], result["height"]) == (64, 36)
    assert result["fused_mode"] == mode
    assert result["stages"] == ["lut", "adjust", "color_match", "sharpen",
                                "grain"]
    probe = video_io.probe_video(result["output"])
    assert (probe["frame_count"], probe["width"], probe["height"]) == (10, 64, 36)


def test_other_appliers_on_a_clip(tmp_path):
    clip = _clip(str(tmp_path / "clip.mp4"), frames=5)
    for result in (
            appliers.apply_lut_to_video(clip, "teal_orange.cube",
                                        str(tmp_path / "l.mp4"),
                                        batch_size=2, device="cpu"),
            appliers.apply_film_grain_to_video(clip, str(tmp_path / "g.mp4"),
                                               seed=3, batch_size=2,
                                               device="cpu"),
            appliers.apply_adjust_to_video(clip, str(tmp_path / "a.mp4"),
                                           ADJUST, batch_size=2,
                                           device="cpu")):
        assert result["processed_frames"] == 5
        assert video_io.probe_video(result["output"])["frame_count"] == 5


def _run_cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "vrgdg_tpu_torch.cli", *args],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300, check=False)


def test_cli_grade_on_cpu_and_cuda_without_card(tmp_path):
    clip = _clip(str(tmp_path / "clip.mp4"), frames=6)
    out = str(tmp_path / "graded.mp4")
    done = _run_cli(["grade", clip, "-o", out, "--lut", "teal_orange.cube",
                     "--lut-strength", "8", "--sharpen", "1.5", "--grain",
                     "0.05", "--seed", "42", "--batch-size", "4",
                     "--fused-mode", "eager", "--device", "cpu"], tmp_path)
    assert done.returncode == 0, done.stderr[-2000:]
    assert '"processed_frames": 6' in done.stdout
    assert video_io.probe_video(out)["frame_count"] == 6
    if torch.cuda.is_available():
        return
    refused = _run_cli(["grade", clip, "--device", "cuda"], tmp_path)
    assert refused.returncode != 0
    assert "no CUDA device is available" in refused.stderr


def test_resolve_device_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        appliers.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        appliers.grade_video("missing.mp4", device="cuda")
    assert appliers.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import vrgdg_tpu_torch, vrgdg_tpu_torch.api.appliers, "
            "vrgdg_tpu_torch.cli, vrgdg_tpu_torch.kernels.grade_cuda, "
            "vrgdg_tpu_torch.kernels.grain_cuda, "
            "vrgdg_tpu_torch.kernels.probe_cuda, "
            "vrgdg_tpu_torch.tools.probe_transpose, "
            "vrgdg_tpu_torch.jobs, "
            "vrgdg_tpu_torch.jobs.enhancer, vrgdg_tpu_torch.jobs.manifest, "
            "vrgdg_tpu_torch.jobs.prepare_restore, "
            "vrgdg_tpu_torch.ops.resize, vrgdg_tpu_torch.native, "
            "vrgdg_tpu_torch.api, vrgdg_tpu_torch.api.compare, "
            "vrgdg_tpu_torch.ops.compare, vrgdg_tpu_torch.runtime.image_io, "
            "vrgdg_tpu_torch.runtime.media_loaders, "
            "vrgdg_tpu_torch.jobs.face_fix, "
            "vrgdg_tpu_torch.jobs.face_fix_pipeline, "
            "vrgdg_tpu_torch.jobs.face_repair, vrgdg_tpu_torch.ops.face, "
            "vrgdg_tpu_torch.ops.paste_back, vrgdg_tpu_torch.ops.schedules, "
            "vrgdg_tpu_torch.ops.reference_images, vrgdg_tpu_torch.ops.grid, "
            "vrgdg_tpu_torch.ops.image_switch, vrgdg_tpu_torch.ops.lora, "
            "vrgdg_tpu_torch.server, vrgdg_tpu_torch.server.routes, "
            "vrgdg_tpu_torch.release_notes, vrgdg_tpu_torch.runtime.audio, "
            "vrgdg_tpu_torch.runtime.audio_toolkit, "
            "vrgdg_tpu_torch.runtime.beats\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'vrgdg_tpu' or "
            "m.startswith('vrgdg_tpu.') or m.split('.')[0] == 'PIL']\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and "clean" in done.stdout, done.stderr


def test_maybe_trace_is_a_noop_unless_asked(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.TRACE_ENV, raising=False)
    with profiling.maybe_trace("x") as target:
        assert target is None
    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path))
    with profiling.maybe_trace("run") as target:
        torch.ones(4).sum()
    assert os.path.isfile(os.path.join(target, "trace.json"))


# --------------------------------------------------------------------------
# the copied JAX-free modules agree with their originals
# --------------------------------------------------------------------------

_PARAM_INPUTS = [None, {}, {"contrast": 150, "vignette": -5, "enabled": False},
                 {"temperature": "12.5", "fade": float("nan"), "tint": None},
                 {"sharpen": 101, "clarity": -100.0, "exposure": "x"}]


@pytest.mark.parametrize("settings", _PARAM_INPUTS)
def test_adjust_settings_normalize_copy(settings):
    a = jparams.AdjustSettings.normalize(settings)
    b = tparams.AdjustSettings.normalize(settings)
    assert a.to_dict() == b.to_dict() and a.is_identity == b.is_identity


@pytest.mark.parametrize("args", [(), (0.5,), (20.0, 2.0, -3), ("x", None, 7.6),
                                  (float("nan"), 0.3, 2 ** 40)])
def test_params_normalize_copy(args):
    for name in ("GrainParams", "LUTParams", "ColorMatchParams",
                 "SharpenParams"):
        n = {"GrainParams": 3, "LUTParams": 1, "ColorMatchParams": 1,
             "SharpenParams": 1}[name]
        a = getattr(jparams, name).normalize(*args[:n])
        b = getattr(tparams, name).normalize(*args[:n])
        assert a.__dict__ == b.__dict__, name
    for kind, border in (("sobel", "zero"), ("bogus", "bogus")):
        assert (jparams.SharpenParams.normalize(3.0, border, kind).__dict__
                == tparams.SharpenParams.normalize(3.0, border, kind).__dict__)


def test_enhancer_settings_and_helpers_copy():
    payload = {"upscale_resolution": "4K", "grain_enabled": 1, "seed": -4,
               "encode_preset": "bogus", "batch_size": 500}
    assert (jparams.EnhancerSettings.normalize(payload).to_dict()
            == tparams.EnhancerSettings.normalize(payload).to_dict())
    for w, h in ((1920, 1080), (3840, 2160), (640, 480), (1, 1)):
        assert jparams.auto_batch_size(w, h) == tparams.auto_batch_size(w, h)
        for up in ("original", "2k", "4k"):
            assert (jparams.output_dimensions(w, h, up)
                    == tparams.output_dimensions(w, h, up))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(LUTS, "*.cube"))))
def test_parse_cube_and_bundle_copy(path):
    a, b = jcube.parse_cube(path), tcube.parse_cube(path)
    assert (a.size, a.title) == (b.size, b.title)
    for field in ("table", "domain_min", "domain_max"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    assert np.array_equal(jcube.corner_bundle(a), tcube.corner_bundle(b))


def test_lut_builders_and_cache_copy(tmp_path):
    colors = "#0b1d51, teal, #f3d27a"
    assert np.array_equal(jcube.build_palette_lut(colors, 9).table,
                          tcube.build_palette_lut(colors, 9).table)
    assert np.array_equal(jcube.identity_lut(5).table,
                          tcube.identity_lut(5).table)
    assert jcube.list_lut_files(LUTS) == tcube.list_lut_files(LUTS)
    path = tcube.write_cube(tcube.identity_lut(3), str(tmp_path / "id.cube"))
    cache = tcube.LutCache(capacity=1)
    assert cache.load(path) is cache.load(path)
    assert np.array_equal(cache.load(path).table, jcube.parse_cube(path).table)


@pytest.mark.parametrize("name", ["teal_orange.cube", "../LUTS/teal_orange.cube",
                                  "missing.cube", "teal_orange.png", "", None])
def test_safe_lut_path_copy(name):
    def outcome(fn):
        try:
            return fn(name, LUTS)
        except (ValueError, FileNotFoundError) as exc:
            return type(exc).__name__, str(exc)

    assert outcome(jpaths.safe_lut_path) == outcome(tpaths.safe_lut_path)
    assert jpaths.SUPPORTED_VIDEO_EXTENSIONS == tpaths.SUPPORTED_VIDEO_EXTENSIONS
    assert jpaths.SUPPORTED_IMAGE_EXTENSIONS == tpaths.SUPPORTED_IMAGE_EXTENSIONS
    assert os.path.abspath(jpaths.DEFAULT_LUTS_DIR) == os.path.abspath(
        tpaths.DEFAULT_LUTS_DIR)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_smooth_frame_is_a_gradient():
    """The smooth frame chip_smoke.py and paired_grade.py time phase 1 on:
    a ramp per channel plus +-2 levels of noise, in [0, 1]."""
    smoke = _chip_smoke()
    frames = smoke._smooth_frames((2, 9, 17), 120, "cpu")
    assert frames.shape == (2, 9, 17, 3) and frames.is_contiguous()
    assert float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0
    step = float((frames[:, :, 1:] - frames[:, :, :-1]).abs().max())
    assert step <= 1 / 16 + 4 / 255 + 1e-6


def test_smoke_sass_count_prices_float_instructions_by_class():
    """The operations term of chip_smoke.py's bounds: floating-point SASS
    instructions only (FFMA and DFMA as two), by instruction class, up to the
    first unpredicated EXIT, skipping a forward-branched loop (sinf's
    large-argument reduction) and functions that are not probes.  Beside
    the bound, every instruction on that path (integer, branch included)
    at the card's issue rate: 132 SMs x 4 warp instructions x 32 threads a
    clock."""
    smoke = _chip_smoke()
    sass = """
        Function : probe_x
        /*0000*/                   MUFU.EX2 R2, R3 ;
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   FADD R2, R3, R4 ;
        /*0030*/               @P0 BRA 0x70 ;
        /*0040*/                   FMUL R2, R3, R4 ;
        /*0050*/                   IADD3 R2, R3, R4, RZ ;
        /*0060*/               @P1 BRA 0x40 ;
        /*0070*/                   DFMA R2, R4, R6, R8 ;
        /*0080*/                   F2F.F64.F32 R4, R2 ;
        /*0090*/                   IMAD R2, R3, R4, R5 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   FFMA R2, R3, R4, R5 ;
        Function : _ZN_grade_phase1_kernel
        /*0000*/                   FFMA R2, R3, R4, R5 ;
"""
    # MUFU, FFMA, FADD, BRA, DFMA, F2F, IMAD: the loop and EXIT left out
    assert smoke._sass_counts(sass) == {
        "x": {"fp32": 3, "xu": 2, "fp64": 2, "instructions": 7}}
    clock = 1.98e9
    bounds = smoke.kernel_bounds(
        (2, 2160, 3840), 33 ** 3 * 96,
        {name: {"fp32": 400, "xu": 200, "fp64": 0, "instructions": 600}
         for name in ("grade_phase1", "grade_phase1_planes",
                      "grade_phase2", "film_grain")}, clock)
    pixels = 2 * 2160 * 3840
    issue_ms = 600 * pixels / (132 * 4 * 32 * clock) * 1e3
    assert bounds["grade_phase2"] == (
        pytest.approx(200 * pixels / smoke.XU_OPS_PER_S * 1e3), "operations",
        pytest.approx(issue_ms))
    assert bounds["grade_phase2_planes"] == bounds["grade_phase2"]
    assert bounds["film_grain"][2] == pytest.approx(issue_ms)
    assert bounds["weighted_row_sum"] == (
        pytest.approx(100 * pixels / smoke.HBM_BYTES_PER_S * 1e3), "bytes",
        None)
