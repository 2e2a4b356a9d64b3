"""The port's enhancer (vrgdg_tpu_torch.jobs.enhancer), its copied host
modules (jobs/manifest.py, the video_io additions, native/mp4concat.cpp)
and the ``enhance`` command, against vrgdg_tpu on the CPU.

Bounds: the enhance step with grain off <= 1e-5 against JAX's
``_enhance_step`` (the same lanczos4 weights, unsharp and clamps; float32
sums in another order); the uint8 step (dequantize -> step -> quantize)
at most one level apart on at most 0.1% of values (a ~1e-7 difference
flips the truncation of a value on a level boundary).  With grain on the
streams differ by design (the port's Philox against JAX's threefry), so
the grain is held to its determinism contract and its statistics: std
ratios R/G 2 and B/G 3 within 5%, G std 1 within 5%, mean 0 within 0.02,
for both packages.  The jobs run on 64x48 clips; their outputs are
compared byte for byte (resume, OOM fallbacks) or by frame count and size.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu.core import params as jparams
from vrgdg_tpu.jobs import enhancer as jenh
from vrgdg_tpu.jobs import manifest as jmf
from vrgdg_tpu.runtime import video_io as jvio
from vrgdg_tpu_torch.core.params import EnhancerSettings
from vrgdg_tpu_torch.jobs import enhancer as tenh
from vrgdg_tpu_torch.jobs import manifest as tmf
from vrgdg_tpu_torch.parallel import distributed as tdist
from vrgdg_tpu_torch.parallel import make_mesh
from vrgdg_tpu_torch.runtime import video_io as tvio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAIN = {"sharpen_strength": 1.0, "grain_enabled": True,
         "grain_intensity": 0.05, "seed": 9, "preserve_audio": False}


def _write_clip(path, frames, fps=10.0, size=(64, 48), seed=0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, size)
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (size[1], size[0], 3), np.uint8))
    writer.release()
    return str(path)


def _decode(path):
    capture = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return np.stack(frames)


def _wait(registry, job_id, statuses, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = registry.snapshot(job_id)
        if snap.get("status") in statuses:
            return snap
        time.sleep(0.05)
    raise TimeoutError(f"job stuck: {registry.snapshot(job_id)}")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The jobs decode on a cv2 thread while torch runs the step on the
    CPU; torch's spinning OpenMP workers can then slow a 64x48 segment
    from 0.1 s to several seconds, so this file runs torch on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def source_video(tmp_path_factory):
    # 60 frames at 10 fps: with segment_seconds 5, segments of 50 + 10
    return _write_clip(tmp_path_factory.mktemp("src") / "clip.mp4", 60)


# --------------------------------------------------------------------------
# the device step against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("payload,in_hw,out_hw", [
    ({"sharpen_strength": 1.0}, (24, 32), (48, 64)),
    ({"sharpen_strength": 2.5, "use_accelerator": False}, (24, 32), (41, 70)),
    ({"sharpen_enabled": False}, (30, 20), (60, 40)),
    ({"sharpen_strength": 1.0}, (24, 32), (24, 32)),
])
def test_enhance_step_matches_jax_grain_off(payload, in_hw, out_hw):
    frames = np.random.default_rng(1).uniform(
        0, 1, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jenh._enhance_step(
        jnp.asarray(frames), jparams.EnhancerSettings.normalize(payload),
        out_hw[0], out_hw[1], jnp.asarray(0, jnp.uint32)))
    got = tenh._enhance_step(torch.from_numpy(frames),
                             EnhancerSettings.normalize(payload),
                             out_hw[0], out_hw[1], 0).numpy()
    assert got.shape == want.shape == (2, *out_hw, 3)
    assert np.max(np.abs(got - want)) <= 1e-5


def test_uint8_batch_matches_jax_grain_off():
    u8 = np.random.default_rng(2).integers(0, 256, (3, 24, 32, 3), np.uint8)
    payload = {"sharpen_strength": 1.5}
    want = np.asarray(jenh.apply_effects_batch(
        u8, jparams.EnhancerSettings.normalize(payload), 48, 64,
        as_uint8=True))
    got = tenh.apply_effects_batch(u8, EnhancerSettings.normalize(payload),
                                   48, 64, device="cpu", as_uint8=True)
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 48, 64, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_effects_batch_boundary_determinism():
    """The reference's core enhancer numeric property: grain keyed on the
    absolute frame index, so batch boundaries do not show."""
    settings = EnhancerSettings.normalize({
        "sharpen_strength": 1.2, "grain_enabled": True,
        "grain_intensity": 0.08, "seed": 99, "upscale_resolution": "4k"})
    frames = np.random.default_rng(3).uniform(
        0, 1, (8, 12, 16, 3)).astype(np.float32)
    whole = tenh.apply_effects_batch(frames, settings, 24, 32, 0,
                                     device="cpu")
    parts = np.concatenate([
        tenh.apply_effects_batch(frames[:5], settings, 24, 32, 0,
                                 device="cpu"),
        tenh.apply_effects_batch(frames[5:], settings, 24, 32, 5,
                                 device="cpu")])
    np.testing.assert_array_equal(whole, parts)
    again = tenh.apply_effects_batch(frames[3:], settings, 24, 32, 3,
                                     device="cpu")
    np.testing.assert_array_equal(whole[3:], again)


def test_enhance_batches_run_the_short_tail_unpadded(monkeypatch):
    """``enhance_batches`` at batch 2 over a 5-frame clip runs the step on
    2, 2 and 1 frames (no pad frame) and writes the bytes the same clip
    gives at batch 1."""
    settings = EnhancerSettings.normalize({**GRAIN, "sharpen_strength": 1.2})
    clip = np.random.default_rng(8).integers(0, 256, (5, 12, 16, 3), np.uint8)
    lengths: list = []
    real = tenh._enhance_step

    def step(frames, *args):
        lengths.append(int(frames.shape[0]))
        return real(frames, *args)

    monkeypatch.setattr(tenh, "_enhance_step", step)

    def run(batch):
        written: list = []
        done, smallest = tenh.enhance_batches(
            [(i, clip[i:i + batch]) for i in range(0, 5, batch)], settings,
            24, 32, device="cpu", batch_size=batch, write=written.append)
        assert (done, smallest) == (5, batch)
        return written

    pairs = run(2)
    assert lengths == [2, 2, 1]
    assert [w.shape[0] for w in pairs] == [2, 2, 1]
    singles = run(1)
    assert lengths[3:] == [1] * 5
    assert np.concatenate(pairs).tobytes() == np.concatenate(singles).tobytes()


def _grain_stats(noise):
    stds = noise.reshape(-1, 3).std(axis=0)
    return stds[0] / stds[1], stds[2] / stds[1], stds[1], noise.mean()


def test_grain_statistics_match_the_contract_in_both_packages():
    payload = {"sharpen_enabled": False, "grain_enabled": True,
               "grain_intensity": 0.01, "saturation_mix": 1.0, "seed": 5}
    grey = np.full((2, 128, 160, 3), 0.5, np.float32)
    port = tenh.apply_effects_batch(grey, EnhancerSettings.normalize(payload),
                                    device="cpu")
    jax_out = np.asarray(jenh.apply_effects_batch(
        grey, jparams.EnhancerSettings.normalize(payload)))
    for out in (port, jax_out):
        ratio_r, ratio_b, std_g, mean = _grain_stats(
            (out.astype(np.float64) - 0.5) / 0.01)
        assert abs(ratio_r - 2.0) <= 0.1 and abs(ratio_b - 3.0) <= 0.15
        assert abs(std_g - 1.0) <= 0.05 and abs(mean) <= 0.02
    assert not np.array_equal(port, jax_out)  # two streams, by design


def test_submit_is_deferred_and_uint8_quantizes_the_float_result():
    settings = EnhancerSettings.normalize({"sharpen_strength": 1.0, **GRAIN})
    u8 = np.random.default_rng(4).integers(0, 256, (2, 12, 16, 3), np.uint8)
    pending = tenh.submit_effects_batch(u8, settings, 20, 30, 7,
                                        device="cpu", as_uint8=True)
    assert pending.count == 2 and pending.device_ms() == 0.0
    as_float = tenh.apply_effects_batch(u8, settings, 20, 30, 7, device="cpu")
    np.testing.assert_array_equal(
        pending.result(), np.clip(as_float * 255.0, 0, 255).astype(np.uint8))


@pytest.mark.parametrize("mesh", [None, "cpu"])
def test_batch_functions_take_the_jax_positions(mesh):
    """``(frames, settings, out_height, out_width, frame_start, mesh,
    as_uint8)`` by position, as vrgdg_tpu.jobs.enhancer takes them, in all
    three batch functions; ``device`` stays a keyword."""
    settings = EnhancerSettings.normalize({"sharpen_strength": 1.0, **GRAIN})
    u8 = np.random.default_rng(6).integers(0, 256, (3, 12, 16, 3), np.uint8)
    mesh = None if mesh is None else _cpu_mesh()
    want = tenh.apply_effects_batch(u8, settings, 20, 30, 4, device="cpu",
                                    as_uint8=True)
    assert want.dtype == np.uint8 and want.shape == (3, 20, 30, 3)
    np.testing.assert_array_equal(
        tenh.apply_effects_batch(u8, settings, 20, 30, 4, mesh, True,
                                 device="cpu"), want)
    np.testing.assert_array_equal(
        tenh.submit_effects_batch(u8, settings, 20, 30, 4, mesh, True,
                                  device="cpu").result(), want)
    out, smallest = tenh.process_with_retry(u8, settings, 20, 30, 4, mesh,
                                            True, device="cpu")
    np.testing.assert_array_equal(out, want)
    assert smallest == 3


def test_mesh_for_settings_refuses_more_than_one_card(monkeypatch):
    """Since the port has a mesh, more than one card builds one (as the
    JAX package's ``mesh_for_settings`` does) instead of raising; one
    card, the CPU and a device naming one card give ``None``."""
    settings = EnhancerSettings.normalize({})
    monkeypatch.delenv(tdist.ENV_LOCAL_DEVICE_IDS, raising=False)
    assert tenh.mesh_for_settings(settings, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tenh.mesh_for_settings(settings, "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tenh.mesh_for_settings(settings, "cuda")
    assert mesh.shape == {"data": 4, "space": 1} and mesh.size == 4
    assert mesh.devices == tuple((torch.device("cuda", i),) for i in range(4))
    assert not mesh.spans_processes
    spatial = tenh.mesh_for_settings(EnhancerSettings.normalize(
        {"data_parallel": 1, "spatial_parallel": 2}), "cuda")
    assert spatial.shape == {"data": 1, "space": 2}
    assert tenh.mesh_for_settings(EnhancerSettings.normalize(
        {"data_parallel": 3}), "cuda").size == 3
    assert tenh.mesh_for_settings(
        EnhancerSettings.normalize({"data_parallel": 1}), "cuda") is None
    assert tenh.mesh_for_settings(settings, "cuda:1") is None
    monkeypatch.setenv(tdist.ENV_LOCAL_DEVICE_IDS, "1,3")
    assert tenh.mesh_for_settings(settings, "cuda").devices == (
        (torch.device("cuda", 1),), (torch.device("cuda", 3),))


# --------------------------------------------------------------------------
# the step on a mesh of CPU devices
# --------------------------------------------------------------------------

def _cpu_mesh(n=8, spatial=1):
    return make_mesh(n, spatial=spatial, devices=[torch.device("cpu")] * n)


def test_effects_batch_mesh_bit_identity():
    settings = EnhancerSettings.normalize({
        "sharpen_strength": 1.2, "grain_enabled": True,
        "grain_intensity": 0.08, "seed": 99})
    frames = np.random.default_rng(1).uniform(
        0, 1, (5, 12, 16, 3)).astype(np.float32)   # 5 frames over 8: pads
    single = tenh.apply_effects_batch(frames, settings, 24, 32,
                                      frame_start=3, device="cpu")
    sharded = tenh.apply_effects_batch(frames, settings, 24, 32,
                                       frame_start=3, mesh=_cpu_mesh())
    assert sharded.shape == single.shape
    np.testing.assert_array_equal(single, sharded)
    u8 = np.random.default_rng(2).integers(0, 256, (5, 12, 16, 3), np.uint8)
    np.testing.assert_array_equal(
        tenh.apply_effects_batch(u8, settings, 24, 32, 3, device="cpu",
                                 as_uint8=True),
        tenh.apply_effects_batch(u8, settings, 24, 32, 3, mesh=_cpu_mesh(),
                                 as_uint8=True))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((16, 24), (32, 48)),     # the JAX suite's spatial case
    ((16, 20), (41, 30)),     # output rows that do not divide the axis
    ((24, 20), (7, 30)),      # downscale
    ((16, 24), (16, 36)),     # equal heights: no height halo
])
def test_effects_batch_spatial_sharding_tolerance(in_hw, out_hw):
    """4 data x 2 space: lanczos4 reads its support's rows as a halo,
    unsharp one row, grain the shard's rows of the whole frame's; within
    1e-5 of one device (the products sum in another order)."""
    settings = EnhancerSettings.normalize({
        "sharpen_strength": 1.2, "grain_enabled": True,
        "grain_intensity": 0.05, "seed": 5, "spatial_parallel": 2})
    frames = np.random.default_rng(2).uniform(
        0, 1, (4, *in_hw, 3)).astype(np.float32)
    single = tenh.apply_effects_batch(frames, settings, *out_hw,
                                      frame_start=0, device="cpu")
    sharded = tenh.apply_effects_batch(frames, settings, *out_hw,
                                       frame_start=0, mesh=_cpu_mesh(8, 2))
    np.testing.assert_allclose(sharded, single, atol=1e-5, rtol=0)


def test_effects_batch_spatial_matches_jax_grain_off():
    payload = {"sharpen_strength": 1.2, "spatial_parallel": 2}
    frames = np.random.default_rng(4).uniform(
        0, 1, (4, 16, 24, 3)).astype(np.float32)
    want = jenh.apply_effects_batch(
        frames, jparams.EnhancerSettings.normalize(payload), 32, 48,
        mesh=jenh.mesh_for_settings(
            jparams.EnhancerSettings.normalize(payload)))
    got = tenh.apply_effects_batch(frames, EnhancerSettings.normalize(payload),
                                   32, 48, mesh=_cpu_mesh(8, 2))
    assert np.max(np.abs(got - np.asarray(want))) <= 1e-5


def test_spatial_only_when_the_height_divides_the_axis(monkeypatch):
    """The JAX package's rule: a frame whose height does not divide the
    space axis stays whole on its data row's first card."""
    calls = []
    real = tenh._enhance_rows
    monkeypatch.setattr(tenh, "_enhance_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    settings = EnhancerSettings.normalize({"spatial_parallel": 2,
                                           "sharpen_strength": 1.0})
    rng = np.random.default_rng(3)
    odd = rng.uniform(0, 1, (4, 15, 24, 3)).astype(np.float32)  # 15 % 2
    single = tenh.apply_effects_batch(odd, settings, 30, 48, device="cpu")
    sharded = tenh.apply_effects_batch(odd, settings, 30, 48,
                                       mesh=_cpu_mesh(8, 2))
    np.testing.assert_array_equal(sharded, single)
    assert calls == []
    even = rng.uniform(0, 1, (4, 16, 24, 3)).astype(np.float32)
    tenh.apply_effects_batch(even, settings, 32, 48, mesh=_cpu_mesh(8, 2))
    assert len(calls) == 4   # one per data row


def test_film_grain_row_start_draws_the_whole_frames_rows():
    """The plain ``film_grain`` (the ``film_grain`` kernel's plain
    version) on rows [a, b) with ``row_start=a`` equals rows [a, b) of
    the whole frame's, bit for bit; rows past the frame are refused."""
    from vrgdg_tpu_torch.kernels.grain_cuda import film_grain_kernel
    from vrgdg_tpu_torch.ops.grain import film_grain

    frames = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (3, 20, 12, 3)).astype(np.float32))
    whole = film_grain(frames, 0.08, 0.4, 17, frame_start=6)
    for a, b in ((0, 5), (5, 13), (13, 20)):
        part = film_grain_kernel(frames[:, a:b].contiguous(), 0.08, 0.4, 17,
                                 frame_start=6, row_start=a, frame_height=20)
        assert torch.equal(part, whole[:, a:b])
    with pytest.raises(ValueError, match="do not lie"):
        film_grain(frames[:, :8], 0.08, 0.4, 17, row_start=15,
                   frame_height=20)


def test_full_job_mesh_vs_single_bit_identity(source_video, tmp_path,
                                              monkeypatch):
    """The job on a mesh of four CPU devices decodes equal to the job on
    one, and reports the mesh in its status."""
    outputs = {}
    for name, mesh in (("mesh", _cpu_mesh(4)), ("single", None)):
        monkeypatch.setattr(tenh, "mesh_for_settings",
                            lambda settings, device, mesh=mesh: mesh)
        registry = tenh.JobRegistry()
        tenh.render_job("job", {"source_path": source_video,
                                "settings": {**GRAIN, "segment_seconds": 5}},
                        registry=registry, base_folder=str(tmp_path / name),
                        device="cpu")
        snap = registry.snapshot("job")
        assert snap["status"] == "complete", snap.get("error")
        assert snap["mesh_devices"] == (4 if mesh else 1)
        assert snap["fps_per_chip"] > 0
        outputs[name] = _decode(snap["output_path"])
    np.testing.assert_array_equal(outputs["mesh"], outputs["single"])


def test_upload_folder_matches_jax(tmp_path):
    path = tenh.upload_folder(str(tmp_path))
    assert path == jenh.upload_folder(str(tmp_path))
    assert os.path.isdir(path)


# --------------------------------------------------------------------------
# OOM handling
# --------------------------------------------------------------------------

def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")


def test_oom_bisection(monkeypatch):
    calls = []
    real = tenh.apply_effects_batch

    def flaky(frames, settings, out_h=None, out_w=None, frame_start=0, *,
              device, mesh=None, as_uint8=False):
        calls.append(len(frames))
        if len(frames) > 2:
            raise _oom()
        return real(frames, settings, out_h, out_w, frame_start,
                    device=device, mesh=mesh)

    monkeypatch.setattr(tenh, "apply_effects_batch", flaky)
    settings = EnhancerSettings.normalize({"sharpen_strength": 1.0, **GRAIN})
    frames = np.random.default_rng(5).uniform(
        0, 1, (8, 8, 8, 3)).astype(np.float32)
    out, smallest = tenh.process_with_retry(frames, settings, 8, 8, 0,
                                            device="cpu")
    np.testing.assert_array_equal(
        out, real(frames, settings, 8, 8, 0, device="cpu"))
    assert smallest == 2 and max(calls) == 8 and 2 in calls
    with pytest.raises(ValueError):  # not an OOM: raised as is
        monkeypatch.setattr(tenh, "apply_effects_batch",
                            lambda *a, **k: (_ for _ in ()).throw(
                                ValueError("bad")))
        tenh.process_with_retry(frames, settings, 8, 8, 0, device="cpu")


@pytest.mark.parametrize("where", ["submit", "force"])
def test_oom_fallback_keeps_frame_order(source_video, tmp_path, monkeypatch,
                                        where):
    """An OOM at submit time (where torch raises it) or when a batch is
    forced: older in-flight batches are encoded first, and the segment is
    byte-identical to a fault-free render."""
    settings = EnhancerSettings.normalize({**GRAIN, "batch_size": 4})
    meta = tvio.probe_video(source_video)

    def render(name, inject):
        calls = {"n": 0}
        with monkeypatch.context() as patch:
            if where == "submit":
                real = tenh.submit_effects_batch

                def flaky(frames, *args, **kwargs):
                    calls["n"] += 1
                    if inject and calls["n"] in (3, 6):
                        raise _oom()
                    return real(frames, *args, **kwargs)

                patch.setattr(tenh, "submit_effects_batch", flaky)
            else:
                real = tenh.PendingBatch.result

                def flaky(self):
                    calls["n"] += 1
                    if inject and calls["n"] in (2, 5):
                        raise _oom()
                    return real(self)

                patch.setattr(tenh.PendingBatch, "result", flaky)
            path = str(tmp_path / name)
            tenh._render_segment(source_video, path, 0, meta["frame_count"],
                                 meta, settings, "oom_job",
                                 threading.Event(), tenh.JobRegistry(),
                                 device="cpu")
        assert not inject or calls["n"] > 6
        with open(path, "rb") as handle:
            return handle.read()

    assert render("clean.mp4", False) == render("faulty.mp4", True)


# --------------------------------------------------------------------------
# the job
# --------------------------------------------------------------------------

def test_full_render_job(source_video, tmp_path):
    registry = tenh.JobRegistry()
    payload = {"source_path": source_video,
               "settings": {**GRAIN, "segment_seconds": 5,
                            "output_name": "demo.mp4"}}
    snap = tenh.start_render(payload, registry=registry,
                             base_folder=str(tmp_path), device="cpu")
    final = _wait(registry, snap["job_id"], {"complete", "failed", "canceled"})
    assert final["status"] == "complete", final.get("error")
    assert final["progress"] == 1.0 and final["total_segments"] == 2
    assert final["device"] == "cpu"
    totals = final["stage_seconds_total"]
    assert set(totals) == {"decode", "device", "encode", "concat"}
    assert all(v > 0 for v in totals.values())
    assert final["encode_backend"] in {"native:mp4concat", "ffmpeg:libx264",
                                       "cv2:avc1", "cv2:H264", "cv2:X264",
                                       "cv2:mp4v"}
    meta = tvio.probe_video(final["output_path"])
    assert (meta["frame_count"], meta["width"], meta["height"]) == (60, 64, 48)
    job_folder = os.path.join(tenh.jobs_folder(str(tmp_path)), snap["job_id"])
    assert not os.path.isdir(os.path.join(job_folder, "segments"))
    assert tmf.read_manifest(job_folder)["status"] == "complete"


class _CancelAfterFirstCommit(tenh.JobRegistry):
    """Sets the job's cancel event right after its first segment commits
    (the post-commit update is the only one with ``stage_seconds_total``
    and no status)."""

    def update(self, job_id, **values):
        super().update(job_id, **values)
        if "stage_seconds_total" in values and "status" not in values:
            self.cancel_event(job_id).set()


def test_cancel_then_resume_is_byte_identical(source_video, tmp_path):
    payload = {"source_path": source_video,
               "settings": {**GRAIN, "segment_seconds": 5}}
    plain = tenh.JobRegistry()
    snap = tenh.start_render(payload, registry=plain,
                             base_folder=str(tmp_path / "a"), device="cpu")
    full = _wait(plain, snap["job_id"], {"complete", "failed"})
    assert full["status"] == "complete", full.get("error")

    base = str(tmp_path / "b")
    canceling = _CancelAfterFirstCommit()
    snap = tenh.start_render(payload, registry=canceling, base_folder=base,
                             device="cpu")
    job_id = snap["job_id"]
    stopped = _wait(canceling, job_id, {"canceled", "complete", "failed"})
    assert stopped["status"] == "canceled" and stopped["can_resume"] is True
    job_folder = os.path.join(tenh.jobs_folder(base), job_id)
    assert tmf.read_manifest(job_folder)["completed_segments"] == [0]
    # resume in a fresh registry (a process restart): the payload comes
    # back from the manifest on disk
    fresh = tenh.JobRegistry()
    snap = tenh.start_render({}, resume_job_id=job_id, registry=fresh,
                             base_folder=base, device="cpu")
    resumed = _wait(fresh, snap["job_id"], {"complete", "failed"})
    assert resumed["status"] == "complete", resumed.get("error")
    np.testing.assert_array_equal(_decode(full["output_path"]),
                                  _decode(resumed["output_path"]))


def test_resume_refuses_changed_fingerprint(source_video, tmp_path):
    registry = tenh.JobRegistry()
    job_id = "enhancer_test_stale"
    job_folder = os.path.join(tenh.jobs_folder(str(tmp_path)), job_id)
    tmf.write_manifest(job_folder, {
        "fingerprint": "deadbeef", "source_path": source_video,
        "settings": {"segment_seconds": 5}, "completed_segments": []})
    tenh.render_job(job_id, {"source_path": source_video,
                             "settings": {"segment_seconds": 5}},
                    resume=True, registry=registry,
                    base_folder=str(tmp_path), device="cpu")
    snap = registry.snapshot(job_id)
    assert snap["status"] == "failed" and snap["can_resume"] is True
    assert "cannot resume" in snap["error"]


def test_registry_guard_cancel_and_snapshots():
    registry = tenh.JobRegistry()
    registry.update("busy", status="running")
    with pytest.raises(ValueError, match="already running"):
        tenh.start_render({"source_path": "x"}, registry=registry,
                          device="cpu")
    event = registry.cancel_event("busy")
    assert not event.is_set()
    tenh.cancel_render("busy", registry=registry)
    assert event.is_set()
    with pytest.raises(ValueError):
        tenh.cancel_render("nope", registry=registry)
    registry.attach("busy", "thread", object())
    assert "thread" not in registry.snapshot("busy")
    assert [s["job_id"] for s in registry.all_snapshots()] == ["busy"]


def test_start_render_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tenh.start_render({"source_path": "x"}, registry=tenh.JobRegistry())


def test_preview_frame(source_video, tmp_path):
    result = tenh.preview_frame(source_video, 1.0, {"sharpen_strength": 2.0},
                                base_folder=str(tmp_path), device="cpu")
    assert result["frame_index"] == 10
    before = cv2.imread(result["before_path"])
    after = cv2.imread(result["after_path"])
    assert before.shape == after.shape == (48, 64, 3)
    assert np.any(before != after)  # sharpening changed pixels


def test_cli_enhance_on_cpu_and_refusal(tmp_path):
    clip = _write_clip(tmp_path / "tiny.mp4", 3, size=(32, 24), seed=6)
    env = {**os.environ, "PYTHONPATH": REPO}
    done = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "enhance", clip,
         "--settings", '{"upscale_resolution": "2k"}', "--device", "cpu",
         "--output-root", str(tmp_path / "out")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
        check=False)
    assert done.returncode == 0, done.stderr[-2000:]
    final = json.loads(done.stdout)
    assert final["status"] == "complete"
    meta = tvio.probe_video(final["output_path"])
    assert (meta["frame_count"], meta["width"], meta["height"]) == (3, 2560, 1920)
    if torch.cuda.is_available():
        return
    refused = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "enhance", clip,
         "--device", "cuda"], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120, check=False)
    assert refused.returncode != 0
    assert "no CUDA device is available" in refused.stderr


# --------------------------------------------------------------------------
# the copied host modules agree with their originals
# --------------------------------------------------------------------------

def test_manifest_copy(source_video, tmp_path):
    with open(os.path.join(REPO, "vrgdg_tpu", "jobs", "manifest.py"), "rb") as a, \
            open(os.path.join(REPO, "vrgdg_tpu_torch", "jobs", "manifest.py"),
                 "rb") as b:
        assert a.read() == b.read()
    settings = EnhancerSettings.normalize({"seed": 3}).to_dict()
    assert (jmf.settings_fingerprint(source_video, settings, 60)
            == tmf.settings_fingerprint(source_video, settings, 60))
    folder = str(tmp_path / "job")
    tmf.write_manifest(folder, {"completed_segments": [0, 1, 7]})
    assert jmf.read_manifest(folder) == tmf.read_manifest(folder)
    assert (jmf.prune_completed([0, "1", 7, None], 3, folder)
            == tmf.prune_completed([0, "1", 7, None], 3, folder) == set())


def _code_lines(path):
    with open(path, "rb") as handle:
        return [line for line in handle.read().splitlines()
                if not line.lstrip().startswith(b"//")]


def test_mp4concat_source_copy():
    """The port's copy differs from the original only in its comments."""
    original = _code_lines(os.path.join(REPO, "vrgdg_tpu", "native",
                                        "mp4concat.cpp"))
    assert len(original) > 600
    assert original == _code_lines(os.path.join(
        REPO, "vrgdg_tpu_torch", "native", "mp4concat.cpp"))


def test_frames_to_array_copy():
    frames = list(np.random.default_rng(7).integers(
        0, 256, (3, 5, 6, 3), np.uint8))
    np.testing.assert_array_equal(jvio.frames_to_array(frames),
                                  tvio.frames_to_array(frames))


@pytest.mark.parametrize("as_float", [False, True])
def test_parallel_reader_copy(source_video, as_float):
    def batches(module):
        reader = module.ParallelVideoReader(
            source_video, batch_size=4, start_frame=3, end_frame=57,
            workers=3, chunk_batches=2, as_float=as_float)
        with reader:
            return list(reader)

    got, want = batches(tvio), batches(jvio)
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(3, 57, 4))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with tvio.VideoReader(source_video, batch_size=4, start_frame=3,
                          end_frame=57, as_float=False) as sequential:
        expected = np.concatenate([b for _, b in sequential])
    joined = np.concatenate([b for _, b in got])
    if as_float:
        expected = expected.astype(np.float32) / 255.0
    np.testing.assert_array_equal(joined, expected)


def test_concat_videos_copy(tmp_path):
    segments = [_write_clip(tmp_path / f"seg{i}.mp4", n, seed=i)
                for i, n in enumerate((7, 5))]
    results = {}
    for name, module in (("jax", jvio), ("port", tvio)):
        out = str(tmp_path / f"{name}.mp4")
        results[name] = (module.concat_videos(segments, out, 10.0, 64, 48,
                                              preserve_audio=False),
                         _decode(out))
    assert results["jax"][0] == results["port"][0]
    np.testing.assert_array_equal(results["jax"][1], results["port"][1])
    np.testing.assert_array_equal(
        results["port"][1], np.concatenate([_decode(s) for s in segments]))
