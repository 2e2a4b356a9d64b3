"""The port's guided-enhance prepare/restore math
(vrgdg_tpu_torch.jobs.prepare_restore) against vrgdg_tpu's on seeded
clips.

Bound: working frames, anchors and restored clips <= 2e-5 against JAX,
the torch-parity budget of the resampling they run on; index plans and
context fields exactly equal.  The anchor PNG helpers: PNGs of the same
values decode equal, anchors read back bit for bit (EXIF transpose and
Pillow's LANCZOS included); PNGs of the two packages' prepared frames
within one level on at most 0.1% of values.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.jobs import prepare_restore as jpr
from vrgdg_tpu_torch.jobs import prepare_restore as tpr

BOUND = 2e-5


def _clip(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= BOUND


@pytest.mark.parametrize("count,interval", [(40, 16), (33, 16), (1, 16),
                                            (17, 8), (64, 5), (9, 2)])
def test_index_plans_match_jax(count, interval):
    indices = tpr.anchor_indices(count, interval)
    assert indices == jpr.anchor_indices(count, interval)
    assert (tpr.safe_conditioning_indices(indices, count)
            == jpr.safe_conditioning_indices(indices, count))
    for crowded in ([16, 17], [0, 1], [17], [1, 9, 17, 25]):
        assert (tpr.safe_conditioning_indices(crowded, 40)
                == jpr.safe_conditioning_indices(crowded, 40))
    with pytest.raises(ValueError, match="safe LTX"):
        tpr.safe_conditioning_indices([1, 1, 1], 2)


@pytest.mark.parametrize("fit", ["letterbox", "stretch", "crop"])
def test_prepare_matches_jax(fit):
    clip = _clip(0, (20, 36, 64, 3))
    kwargs = dict(anchor_interval=8, anchor_width=100, anchor_height=50,
                  working_width=130, working_height=70,
                  dimension_multiple=32, fit_mode=fit, fps=12.0)
    j_work, j_anchors, j_ctx = jpr.prepare(jnp.asarray(clip), **kwargs)
    t_work, t_anchors, t_ctx = tpr.prepare(torch.from_numpy(clip), **kwargs)
    _close(t_work, j_work)
    _close(t_anchors, j_anchors)
    assert t_work.shape == (20, 64, 128, 3)
    for name in ("source_width", "source_height", "frame_count", "fps",
                 "anchor_indices", "anchor_width", "anchor_height",
                 "working_width", "working_height", "fit_mode",
                 "resize_method"):
        assert getattr(t_ctx, name) == getattr(j_ctx, name), name


@pytest.mark.parametrize("fit", ["letterbox", "stretch", "crop"])
@pytest.mark.parametrize("drift,strength", [(0, 1.0), (-3, 1.0), (4, 0.5),
                                            (-7, 0.0)])
def test_restore_matches_jax(fit, drift, strength):
    clip = _clip(1, (20, 30, 40, 3))
    kwargs = dict(anchor_interval=8, working_width=64, working_height=64,
                  dimension_multiple=8, fit_mode=fit)
    j_work, _, j_ctx = jpr.prepare(jnp.asarray(clip), **kwargs)
    t_work, _, t_ctx = tpr.prepare(torch.from_numpy(clip), **kwargs)
    # a stand-in model: brighten, and drop or repeat frames within +-7
    model = _clip(2, (20 + drift, 64, 64, 3)) * 0.5 \
        if drift > 0 else None
    j_in = np.asarray(j_work)[:20 + drift] if drift <= 0 else model
    t_in = t_work.numpy()[:20 + drift] if drift <= 0 else model
    want = np.asarray(jpr.restore(jnp.asarray(j_in), j_ctx,
                                  enhancement_strength=strength))
    got = tpr.restore(torch.from_numpy(np.array(t_in)), t_ctx,
                      enhancement_strength=strength)
    assert got.shape == clip.shape
    _close(got, want)
    usable = min(20, 20 + drift)
    # source-tail frames are the untouched originals
    np.testing.assert_array_equal(got.numpy()[usable:], clip[usable:])
    if strength == 0.0:
        np.testing.assert_allclose(got.numpy(), clip, atol=1e-6)


def test_restore_refuses_drift_beyond_tolerance():
    clip = torch.from_numpy(_clip(3, (20, 16, 16, 3)))
    working, _, ctx = tpr.prepare(clip, working_width=32, working_height=32,
                                  dimension_multiple=8)
    with pytest.raises(ValueError, match="frames"):
        tpr.restore(working[:12], ctx)
    with pytest.raises(ValueError, match="non-empty"):
        tpr.prepare(clip[:0])


def test_restore_keeps_extra_channels_and_blends_linearly():
    clip = _clip(4, (4, 16, 16, 4))
    working, _, ctx = tpr.prepare(torch.from_numpy(clip), working_width=16,
                                  working_height=16, dimension_multiple=8,
                                  fit_mode="stretch")
    enhanced = torch.clamp(working + 0.2, 0, 1)
    zero, half, full = (tpr.restore(enhanced, ctx, enhancement_strength=s)
                        for s in (0.0, 0.5, 1.0))
    np.testing.assert_array_equal(full.numpy()[..., 3], clip[..., 3])
    np.testing.assert_allclose(half.numpy(), (zero.numpy() + full.numpy()) / 2,
                               atol=1e-5)


def test_run_guided_enhance_matches_jax():
    clip = _clip(5, (12, 24, 32, 3))
    seen = {}

    def model(working, anchors, safe):
        seen.setdefault("safe", []).append(safe)
        return working * 0.9

    kwargs = dict(anchor_interval=8, working_width=64, working_height=48,
                  dimension_multiple=16, fit_mode="letterbox",
                  resize_method="bilinear", enhancement_strength=0.8)
    want = jpr.run_guided_enhance(jnp.asarray(clip), model, **kwargs)
    got = tpr.run_guided_enhance(torch.from_numpy(clip), model, **kwargs)
    _close(got, want)
    assert seen["safe"][0] == seen["safe"][1]
    assert all(i % 8 != 1 for i in seen["safe"][1])


# --------------------------------------------------------------------------
# the anchor PNG helpers (cv2 and numpy in place of Pillow)
# --------------------------------------------------------------------------

def _pngs(folder):
    from PIL import Image

    return [np.asarray(Image.open(os.path.join(folder, name)).convert("RGB"))
            for name in sorted(os.listdir(folder))]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_image_batch_matches_jax(tmp_path, as_tensor):
    """Rounded to the nearest level (values on a half level included), the
    same names, and stale media files cleared."""
    frames = _clip(6, (5, 24, 32, 4))
    frames[0, 0, :4, 0] = np.array([0.5, 1.5, 2.5, 254.5], np.float32) / 255
    ours, theirs = str(tmp_path / "t"), str(tmp_path / "j")
    tpr.save_image_batch(_clip(7, (7, 8, 8, 3)), ours, "anchor")
    jpr.save_image_batch(_clip(7, (7, 8, 8, 3)), theirs, "anchor")
    got = tpr.save_image_batch(torch.from_numpy(frames) if as_tensor
                               else frames, ours, "anchor")
    want = jpr.save_image_batch(frames, theirs, "anchor")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        f"anchor_{i:06d}.png" for i in range(5)]
    assert len(os.listdir(ours)) == 5
    for a, b in zip(_pngs(ours), _pngs(theirs)):
        np.testing.assert_array_equal(a, b)


def test_iter_anchor_images_matches_jax(tmp_path):
    """Mixed sizes, formats and an EXIF-rotated first image: the size is
    taken after its transpose, and every frame is resized with Pillow's
    LANCZOS bit for bit."""
    from PIL import Image

    rng = np.random.default_rng(8)
    folder = tmp_path / "anchors"
    folder.mkdir()
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(rng.integers(0, 256, (30, 44, 3), np.uint8)).save(
        folder / "a_000.jpg", exif=exif)
    Image.fromarray(rng.integers(0, 256, (60, 20, 4), np.uint8)).save(
        folder / "a_001.png")
    Image.fromarray(rng.integers(0, 256, (44, 30, 3), np.uint8)).save(
        folder / "a_002.bmp")
    Image.fromarray(rng.integers(0, 256, (13, 90), np.uint8)).save(
        folder / "a_003.webp")
    (folder / "notes.txt").write_text("ignored")
    w, h, count, frames = tpr.iter_anchor_images(str(folder))
    jw, jh, jcount, jframes = jpr.iter_anchor_images(str(folder))
    assert (w, h, count) == (jw, jh, jcount) == (30, 44, 4)
    got, want = list(frames), list(jframes)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (44, 30, 3)
        np.testing.assert_array_equal(a, b)
    batches = list(tpr.load_anchor_batches(str(folder), 3))
    assert [b.shape[0] for b in batches] == [3, 1]
    np.testing.assert_array_equal(np.concatenate(batches), np.stack(want))


def test_anchor_round_trip_and_empty_folder(tmp_path):
    frames = _clip(9, (10, 24, 32, 3))
    folder = str(tmp_path / "anchors")
    tpr.save_image_batch(frames, folder, "anchor")
    batches = list(tpr.load_anchor_batches(folder, 4))
    assert [b.shape[0] for b in batches] == [4, 4, 2]
    np.testing.assert_allclose(np.concatenate(batches), frames,
                               atol=0.5 / 255 + 1e-6)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tpr.iter_anchor_images(str(empty))


def test_store_enhanced_anchors_count_validation(tmp_path):
    video = torch.from_numpy(_clip(10, (9, 32, 32, 3)))
    _, anchors, context = tpr.prepare(video, anchor_interval=4,
                                      anchor_width=128, anchor_height=128,
                                      working_width=128, working_height=128,
                                      dimension_multiple=8)
    job = str(tmp_path / "job")
    folder = tpr.store_enhanced_anchors(anchors, context, job)
    assert context.extras["enhanced_anchor_folder"] == folder
    _, _, count, _ = tpr.iter_anchor_images(folder)
    assert count == len(context.anchor_indices) == 3
    with pytest.raises(ValueError, match="expected"):
        tpr.store_enhanced_anchors(anchors[:-1], context, job)


def test_persist_prepare_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from vrgdg_tpu_torch.runtime import video_io as tvio

    clip = _clip(11, (8, 48, 64, 3))
    kwargs = dict(anchor_interval=4, anchor_width=64, anchor_height=48,
                  working_width=64, working_height=48, dimension_multiple=8,
                  fps=10.0)
    t_work, t_anchors, t_ctx = tpr.prepare(torch.from_numpy(clip), **kwargs)
    j_work, j_anchors, j_ctx = jpr.prepare(jnp.asarray(clip), **kwargs)
    got = tpr.persist_prepare(t_work, t_anchors, t_ctx, str(tmp_path / "t"))
    want = jpr.persist_prepare(j_work, j_anchors, j_ctx, str(tmp_path / "j"))
    assert {k: os.path.relpath(v, str(tmp_path / "t"))
            for k, v in got.items()} == {
        k: os.path.relpath(v, str(tmp_path / "j")) for k, v in want.items()}
    assert {k: t_ctx.extras[k] for k in got} == got
    for key in ("anchor_sources_folder", "ltx_frames_folder"):
        ours, theirs = _pngs(got[key]), _pngs(want[key])
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            diff = np.abs(a.astype(np.int16) - b)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    meta = tvio.probe_video(got["ltx_video_path"])
    assert (meta["frame_count"], meta["width"], meta["height"]) == (8, 64, 48)
