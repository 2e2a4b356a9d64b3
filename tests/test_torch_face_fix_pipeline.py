"""The port's in-memory Face Fix pipeline
(vrgdg_tpu_torch.jobs.face_fix_pipeline) against
vrgdg_tpu.jobs.face_fix_pipeline on the CPU, on the same seeded batch and
synthetic detector.

Tracking entries and anchors exactly equal; the 512 bicubic crops within
2e-5; the radial composite within 2e-5 (its faces are resampled bicubic)
and its masks within 1e-5; the anchor PNGs decoded within one level on at
most 0.1% of values (both round); the crop video's frame count and size
exact.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.jobs import face_fix_pipeline as jffp
from vrgdg_tpu_torch.jobs import face_fix_pipeline as tffp

FRAMES, H, W = 14, 240, 320
FACE = 16
BICUBIC = 2e-5
EXACT = 1e-5
KW = dict(rotation_assist="off", minimum_face_pixels=8)


def _clip(gap_frames=()):
    rng = np.random.default_rng(0)
    frames = np.full((FRAMES, H, W, 3), 0.15, np.float32)
    frames += rng.uniform(0, 0.02, frames.shape).astype(np.float32)
    for i in range(FRAMES):
        if i in gap_frames:
            continue
        x, y = 40 + 2 * i, 60 + i
        frames[i, y:y + FACE, x:x + FACE] = 0.8
        frames[i, y + 4:y + 7, x + 3:x + 13] = (0.9, 0.4, 0.3)
    return frames


def detector(frame, region):
    left, top, right, bottom = region
    patch = frame[top:bottom, left:right]
    mask = patch[..., 1] > 150
    if not mask.any():
        return []
    ys, xs = np.nonzero(mask)
    return [(left + float(xs.min()), top + float(ys.min()),
             float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1),
             0.9)]


def _close(got, want, tol):
    got, want = got.cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= tol


@pytest.mark.parametrize("gaps,carry,interval", [
    ((), 2, 4), ((5, 6), 2, 4), ((5,), 0, 16), ((0, 1, 9, 10, 11), 1, 3)])
def test_prepare_matches(gaps, carry, interval):
    frames = _clip(gaps)
    kw = dict(KW, anchor_interval=interval, short_gap_tracking=carry)
    crops, anchors, context = tffp.prepare_face_pipeline(
        torch.from_numpy(frames), detector, **kw)
    jcrops, janchors, jcontext = jffp.prepare_face_pipeline(frames, detector,
                                                            **kw)
    assert context.entries == jcontext.entries
    assert context.anchor_indices == jcontext.anchor_indices
    assert (context.frame_count, context.width, context.height) == (
        jcontext.frame_count, jcontext.width, jcontext.height)
    assert context.job_id.startswith("standalone_")
    _close(crops, jcrops, BICUBIC)
    _close(anchors, janchors, BICUBIC)


def test_prepare_from_numpy_on_a_named_device():
    frames = _clip()
    crops, _, context = tffp.prepare_face_pipeline(frames, detector,
                                                   device="cpu", **KW)
    assert crops.device.type == "cpu" and crops.dtype == torch.float32
    np.testing.assert_array_equal(context.original_frames.numpy(), frames)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tffp.prepare_face_pipeline(frames, detector, **KW)


def test_prepare_refusals():
    with pytest.raises(ValueError, match="non-empty BHWC"):
        tffp.prepare_face_pipeline(torch.zeros((0, 8, 8, 3)), detector)
    with pytest.raises(ValueError, match="No face was detected"):
        tffp.prepare_face_pipeline(torch.zeros((3, 32, 32, 3)), detector)
    with pytest.raises(ValueError, match="none are small enough"):
        tffp.prepare_face_pipeline(torch.from_numpy(_clip()), detector,
                                   repair_distance="custom",
                                   custom_distance_threshold=1.0, **KW)


@pytest.mark.parametrize("short_by", [0, 3])
@pytest.mark.parametrize("feather,color_match", [(18, 0.65), (40, 0.0)])
def test_composite_matches(short_by, feather, color_match):
    frames = _clip((5,))
    crops, _, context = tffp.prepare_face_pipeline(torch.from_numpy(frames),
                                                   detector, **KW)
    jcrops, _, jcontext = jffp.prepare_face_pipeline(frames, detector, **KW)
    faces = np.clip(crops.numpy()[:FRAMES - short_by] * 0.9 + 0.08, 0, 1)
    got = tffp.composite_repaired(faces, context, feather, color_match)
    want = jffp.composite_repaired(jnp.asarray(faces), jcontext, feather,
                                   color_match)
    _close(got[0], want[0], BICUBIC)
    _close(got[1], want[1], EXACT)
    assert got[2] == want[2] == FRAMES - short_by
    with pytest.raises(ValueError):
        tffp.composite_repaired(faces[:FRAMES - 8], context)


def test_full_pipeline_with_artifacts(tmp_path):
    pytest.importorskip("cv2")
    from vrgdg_tpu_torch.runtime import image_io, video_io

    frames = _clip()
    seen = {}

    def model(crop_batch, anchor_batch, safe_indices, name):
        assert all(i % 8 != 1 for i in safe_indices)
        seen[name] = list(safe_indices)
        return crop_batch * 0.85 + 0.1

    kw = dict(fps=10.0, color_match=0.5, anchor_interval=4, **KW)
    got = tffp.run_face_fix_pipeline(
        torch.from_numpy(frames), lambda *a: model(*a, "port"),
        detector=detector, job_folder=str(tmp_path / "port"), **kw)
    want = jffp.run_face_fix_pipeline(
        frames, lambda *a: model(*a, "jax"), detector=detector,
        job_folder=str(tmp_path / "jax"), **kw)
    assert seen["port"] == seen["jax"]
    _close(got[0], want[0], BICUBIC)
    _close(got[1], want[1], EXACT)
    assert got[2] == want[2] == FRAMES
    # the artifacts: anchor PNGs (both round) and the 512 crop video
    ours = sorted(glob.glob(str(tmp_path / "port" / "enhanced_anchors_512"
                                / "*.png")))
    theirs = sorted(glob.glob(str(tmp_path / "jax" / "enhanced_anchors_512"
                                  / "*.png")))
    assert [os.path.basename(p) for p in ours] \
        == [os.path.basename(p) for p in theirs] and ours
    for a, b in zip(ours, theirs):
        diff = np.abs(image_io.read_rgb(a).astype(np.int16)
                      - image_io.read_rgb(b).astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    meta = video_io.probe_video(str(tmp_path / "port" / "face_video_512.mp4"))
    assert (meta["frame_count"], meta["width"], meta["height"]) == (FRAMES,
                                                                     512, 512)
    # in memory: the same repair, no artifacts
    memory = tffp.run_face_fix_pipeline(
        torch.from_numpy(frames), lambda *a: model(*a, "memory"),
        detector=detector, **kw)
    assert torch.equal(memory[0], got[0])


def test_collect_rejects_mismatched_jobs(tmp_path):
    frames = torch.from_numpy(_clip())
    _, _, ctx_a = tffp.prepare_face_pipeline(frames, detector, **KW)
    _, _, ctx_b = tffp.prepare_face_pipeline(frames, detector, **KW)
    with pytest.raises(ValueError, match="different Face Fix jobs"):
        tffp.collect_ltx_inputs(ctx_a, ctx_b)
    with pytest.raises(FileNotFoundError, match="cropped Face Fix video"):
        tffp.collect_ltx_inputs(ctx_a, ctx_a)
