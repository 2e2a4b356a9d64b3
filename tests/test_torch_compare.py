"""The port's compare renders and compare appliers
(vrgdg_tpu_torch.ops.compare, vrgdg_tpu_torch.api.compare) against
vrgdg_tpu's on seeded inputs, on the CPU.

Bounds: the selection modes (side_by_side, slider, blink) pick input
values, so they are exact; the blend modes (overlay, difference) are
float32 arithmetic that XLA may fuse differently, <= 1e-6; a B of another
size is letterboxed through the bicubic resample, <= 1e-5 (the port's
resample budget against JAX).  Clips are compared decoded, frame for
frame: the port reads uint8 and divides by 255 in torch, which on the CPU
is the same IEEE division as the JAX reader's numpy one, so the selection
modes decode equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu.api import compare as jcmp
from vrgdg_tpu.ops import compare as jops
from vrgdg_tpu_torch import cli
from vrgdg_tpu_torch.api import compare as tcmp
from vrgdg_tpu_torch.ops import compare as tops

SELECTION = ("side_by_side", "slider", "blink")
BLEND = ("overlay", "difference")


def _frames(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _pair(mode, b_shape):
    a = _frames(0, (3, 36, 64, 3))
    b = _frames(1, b_shape)
    kw = dict(slider_position=0.37, overlay_opacity=0.3, difference_gain=4.0,
              fps=10.0, blink_speed=4.0, frame_start=5)
    want = np.asarray(jops.render_compare(jnp.asarray(a), jnp.asarray(b),
                                          mode, **kw))
    got = tops.render_compare(torch.from_numpy(a), torch.from_numpy(b),
                              mode, **kw).numpy()
    return got, want


@pytest.mark.parametrize("mode", tops.MODES)
def test_modes_match_jax(mode):
    got, want = _pair(mode, (3, 36, 64, 3))
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode in SELECTION:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("mode", tops.MODES)
def test_letterboxed_b_matches_jax(mode):
    """B of another size and more frames: letterboxed onto A, truncated
    to A's frame count."""
    got, want = _pair(mode, (4, 20, 30, 4))
    assert got.shape == want.shape
    assert got.shape[0] == 3
    assert np.max(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("position,seam", [(0.0, 2), (1.0, 2), (0.5, 0),
                                           (0.61, 3), (-2.0, 1)])
def test_slider_edges_match_jax(position, seam):
    a, b = _frames(2, (1, 8, 17, 3)), _frames(3, (1, 8, 17, 3))
    want = np.asarray(jops.slider(jnp.asarray(a), jnp.asarray(b), position,
                                  seam))
    got = tops.slider(torch.from_numpy(a), torch.from_numpy(b), position,
                      seam).numpy()
    np.testing.assert_array_equal(got, want)


def test_blink_is_batch_split_invariant():
    a, b = _frames(4, (12, 6, 8, 3)), _frames(5, (12, 6, 8, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = tops.blink(ta, tb, fps=6.0, blink_speed=2.0, frame_start=3)
    split = torch.cat([
        tops.blink(ta[:5], tb[:5], fps=6.0, blink_speed=2.0, frame_start=3),
        tops.blink(ta[5:], tb[5:], fps=6.0, blink_speed=2.0, frame_start=8)])
    assert torch.equal(whole, split)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(jops.blink(
        jnp.asarray(a), jnp.asarray(b), 6.0, 2.0, 3)))
    for fps, speed in ((24.0, 1.0), (30.0, 0.01), (10.0, 50.0), (1.0, 8.0)):
        assert tops.blink_period(fps, speed) == jops.blink_period(fps, speed)


def test_unknown_mode_raises():
    x = torch.zeros((1, 2, 2, 3))
    with pytest.raises(ValueError, match="Unknown compare mode"):
        tops.render_compare(x, x, "wipe")
    assert tops.MODES == jops.MODES


# --------------------------------------------------------------------------
# compare_videos against the JAX applier
# --------------------------------------------------------------------------

def _write_clip(path, frames, size, seed, fps=10.0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             size)
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
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


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    folder = tmp_path_factory.mktemp("compare_clips")
    return (_write_clip(folder / "a.mp4", 11, (64, 48), 0),
            _write_clip(folder / "b.mp4", 9, (64, 48), 1),
            _write_clip(folder / "small.mp4", 12, (32, 20), 2))


@pytest.mark.parametrize("mode,b_index", [("side_by_side", 1), ("blink", 1),
                                          ("slider", 1), ("overlay", 1),
                                          ("difference", 2)])
def test_compare_videos_matches_jax(clips, tmp_path, mode, b_index):
    """Truncated to the shorter clip (9 frames), a tail batch of 1 at
    batch 4, decoded frame for frame against the JAX applier's output."""
    a, b = clips[0], clips[b_index]
    kw = dict(slider_position=0.4, overlay_opacity=0.25, difference_gain=2.0,
              blink_speed=2.5, batch_size=4)
    want = jcmp.compare_videos(a, b, mode, str(tmp_path / "j.mp4"), **kw)
    got = tcmp.compare_videos(a, b, mode, str(tmp_path / "t.mp4"),
                              device="cpu", **kw)
    frames = 9 if b_index == 1 else 11
    width = 130 if mode == "side_by_side" else 64
    assert set(got) == set(want) | {"stage_seconds"}
    for key in ("mode", "width", "height", "fps", "processed_frames",
                "encoder", "browser_friendly"):
        assert got[key] == want[key], key
    assert (got["processed_frames"], got["width"]) == (frames, width)
    assert got["device"] == "cpu"
    assert set(got["stage_seconds"]) >= {"decode", "device", "encode"}
    mine, theirs = _decode(got["output"]), _decode(want["output"])
    assert mine.shape == (frames, 48, width, 3)
    if mode in SELECTION:
        np.testing.assert_array_equal(mine, theirs)
    else:
        diff = np.abs(mine.astype(np.int16) - theirs.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert os.path.isfile(got["thumbnail_path"])


def test_compare_videos_blink_alternates_by_period(clips, tmp_path):
    """blink at 10 fps and 2.5 Hz: 4 frames of A, then 4 of B, ..."""
    a, b = clips[0], clips[1]
    out = tcmp.compare_videos(a, b, "blink", str(tmp_path / "k.mp4"),
                              blink_speed=2.5, batch_size=3, device="cpu")
    period = tops.blink_period(10.0, 2.5)
    assert period == 4
    side = _decode(tcmp.compare_videos(
        a, b, "side_by_side", str(tmp_path / "s.mp4"), batch_size=3,
        device="cpu")["output"])
    blinked = _decode(out["output"])
    # each frame is nearer A's or B's, as the side_by_side render decoded
    # them (both passed through a lossy encode), as its period says
    for index in range(out["processed_frames"]):
        frame = blinked[index].astype(np.int16)
        to_a = np.abs(frame - side[index, :, :64]).mean()
        to_b = np.abs(frame - side[index, :, 66:]).mean()
        assert (to_a < to_b) == ((index // period) % 2 == 0), index


def test_compare_refuses_unknown_mode_and_missing_card(clips, tmp_path):
    with pytest.raises(ValueError, match="Unknown compare mode"):
        tcmp.compare_videos(clips[0], clips[1], "wipe", device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcmp.compare_videos(clips[0], clips[1], "blink")


def test_cli_compare_videos(clips, tmp_path, capsys):
    out = str(tmp_path / "cli.mp4")
    cli.main(["compare", clips[0], clips[1], "--mode", "side_by_side", "-o",
              out, "--batch-size", "4", "--device", "cpu"])
    result = json.loads(capsys.readouterr().out)
    assert (result["width"], result["height"], result["processed_frames"]) \
        == (130, 48, 9)
    assert _decode(out).shape == (9, 48, 130, 3)
    with pytest.raises(SystemExit) as refused:
        cli.main(["compare", clips[0], clips[1], "--device", "cuda"]
                 if not torch.cuda.is_available() else ["compare", "--bad"])
    assert refused.value.code == 2
