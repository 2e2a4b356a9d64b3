"""The port's folder loaders (vrgdg_tpu_torch.runtime.media_loaders) and
video reader against vrgdg_tpu's, on the CPU: the cases of
tests/test_media_loaders.py, each run through both packages on the same
files, with the decoded frames equal bit for bit.  Also the
``VRGDG_DISPATCH_DEPTH`` override, which changes the pipelining and not
the output bytes, and which reaches both batch streams (the appliers' and
the enhancer's).
"""

import os
import random

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu.runtime import media_loaders as jml
from vrgdg_tpu.runtime import video_io as jvio
from vrgdg_tpu_torch.api import appliers as tap
from vrgdg_tpu_torch.core.params import EnhancerSettings
from vrgdg_tpu_torch.jobs import enhancer as tenh
from vrgdg_tpu_torch.runtime import batch_stream
from vrgdg_tpu_torch.runtime import media_loaders as tml
from vrgdg_tpu_torch.runtime import video_io as tvio


@pytest.fixture()
def image_folder(tmp_path):
    # deliberately shuffled creation order; numeric order is 1, 2, 10
    rng = np.random.default_rng(0)
    for name in ("shot_00010_.png", "shot_00001_.png", "img2.jpg",
                 "frame_7.tiff", "shot_00003_.webp"):
        Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8)).save(
            tmp_path / name)
    (tmp_path / "notes.txt").write_text("ignored")
    return str(tmp_path)


def test_extension_sets_copy():
    assert tml.IMAGE_EXTENSIONS == jml.IMAGE_EXTENSIONS
    assert tml.VIDEO_EXTENSIONS == jml.VIDEO_EXTENSIONS
    assert tvio.IMAGE_EXTENSIONS == jvio.IMAGE_EXTENSIONS
    assert ".tiff" in tml.IMAGE_EXTENSIONS


def test_numeric_sort_order(image_folder):
    assert tml.list_images(image_folder) == jml.list_images(image_folder) == [
        "shot_00001_.png", "img2.jpg", "shot_00003_.webp", "frame_7.tiff",
        "shot_00010_.png"]


@pytest.mark.parametrize("index", [0, 1, 2, 3, 4, 7, -1])
def test_indexed_load_and_wraparound(image_folder, index):
    got, picked = tml.indexed_image_from_folder(image_folder, index)
    want, expected = jml.indexed_image_from_folder(image_folder, index)
    assert picked == expected == index % 5
    assert got.shape == (1, 6, 8, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_random_after_end_avoids_recent_picks(tmp_path):
    for i in range(4):
        Image.new("RGB", (4, 4), (i, i, i)).save(tmp_path / f"f_{i + 1}.png")
    picks = {}
    for name, module in (("port", tml), ("jax", jml)):
        history: list[int] = []
        rng = random.Random(0)
        picks[name] = [module.indexed_image_from_folder(
            str(tmp_path), index=99, random_after_end=True, history=history,
            rng=rng)[1] for _ in range(16)]
        assert len(history) == 2
    assert picks["port"] == picks["jax"]
    for a, b in zip(picks["port"], picks["port"][1:]):
        assert a != b
    assert set(picks["port"]) == {0, 1, 2, 3}


def test_numbered_image_matches_index_plus_one(image_folder):
    np.testing.assert_array_equal(
        tml.numbered_image_from_folder(image_folder, 2),
        jml.numbered_image_from_folder(image_folder, 2))  # number 3: webp
    with pytest.raises(FileNotFoundError):
        tml.numbered_image_from_folder(image_folder, 5)


def test_missing_folder_and_empty_folder(tmp_path):
    with pytest.raises(FileNotFoundError):
        tml.list_images(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tml.list_images(str(empty))


def test_load_image_reads_as_pillow(tmp_path):
    path = str(tmp_path / "rotated.jpg")
    exif = Image.Exif()
    exif[0x0112] = 8
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (10, 14, 3), np.uint8)).save(path, exif=exif)
    got = tml.load_image(path)
    assert got.shape == (1, 10, 14, 3)
    np.testing.assert_array_equal(got, jml.load_image(path))


def test_image_batch_from_paths(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"img{i}.png"
        Image.new("RGB", (8, 6), (i * 40, 0, 0)).save(p)
        paths.append(str(p))
    batch = tml.image_batch_from_paths(paths + ["  "])
    np.testing.assert_array_equal(batch, jml.image_batch_from_paths(paths))
    assert batch.shape == (3, 6, 8, 3)
    odd = tmp_path / "odd.png"
    Image.new("RGB", (4, 4)).save(odd)
    with pytest.raises(ValueError, match="share dimensions"):
        tml.image_batch_from_paths(paths + [str(odd)])
    with pytest.raises(ValueError):
        tml.image_batch_from_paths([])


def _write_clip(path, frames, size=(32, 16), seed=0, fps=12.0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             size)
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
    writer.release()
    return str(path)


def test_load_videos_from_folder(tmp_path):
    for seed, (name, frames) in enumerate([("a.mp4", 5), ("b.mp4", 3),
                                           ("c.mp4", 4)]):
        _write_clip(tmp_path / name, frames, seed=seed)
    batch = tml.load_videos_from_folder(str(tmp_path), scene_count=2)
    assert batch.shape == (8, 16, 32, 3) and batch.dtype == np.float32
    np.testing.assert_array_equal(
        batch, jml.load_videos_from_folder(str(tmp_path), scene_count=2))
    with pytest.raises(FileNotFoundError):
        tml.load_videos_from_folder(str(tmp_path / "none"))


# --------------------------------------------------------------------------
# VideoReader(as_float=...) and VRGDG_DISPATCH_DEPTH
# --------------------------------------------------------------------------

@pytest.mark.parametrize("as_float", [None, True, False])
def test_video_reader_matches_jax(tmp_path, as_float):
    clip = _write_clip(tmp_path / "clip.mp4", 11, seed=4)
    kw = {} if as_float is None else {"as_float": as_float}

    def read(module):
        with module.VideoReader(clip, batch_size=4, start_frame=1,
                                end_frame=10, **kw) as reader:
            return list(reader)

    got, want = read(tvio), read(jvio)
    assert [i for i, _ in got] == [i for i, _ in want] == [1, 5, 9]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == (np.uint8 if as_float is False
                                      else np.float32)
        np.testing.assert_array_equal(a, b)


def test_dispatch_depth_env_overrides_and_keeps_bytes(tmp_path, monkeypatch):
    clip = _write_clip(tmp_path / "clip.mp4", 7, size=(48, 32), seed=5)
    outputs = {}
    for depth in ("1", "3"):
        monkeypatch.setenv("VRGDG_DISPATCH_DEPTH", depth)
        out = str(tmp_path / f"depth{depth}.mp4")
        result = tap.apply_adjust_to_video(
            clip, out, {"contrast": 25}, batch_size=2, device="cpu")
        assert result["dispatch_depth"] == int(depth)
        assert result["processed_frames"] == 7
        with open(out, "rb") as handle:
            outputs[depth] = handle.read()
    assert outputs["1"] == outputs["3"]
    monkeypatch.delenv("VRGDG_DISPATCH_DEPTH")
    result = tap.apply_adjust_to_video(clip, str(tmp_path / "d.mp4"),
                                       {"contrast": 25}, batch_size=2,
                                       device="cpu")
    assert result["dispatch_depth"] == 2


@pytest.mark.parametrize("caller", ["grade", "enhance"])
def test_dispatch_depth_env_reaches_both_streams(tmp_path, monkeypatch,
                                                 caller):
    """``VRGDG_DISPATCH_DEPTH`` reaches the grade's stream (through
    ``_apply_effect_to_video``) and the enhancer's (``enhance_batches``)
    through ``batch_stream.dispatch_depth``: both FIFOs fill to 3."""
    full: list = []
    real_push = batch_stream.InFlight.push

    def push(self, *args):
        due = real_push(self, *args)
        full.append((self.depth, len(self)))
        return due

    monkeypatch.setattr(batch_stream.InFlight, "push", push)
    monkeypatch.setenv("VRGDG_DISPATCH_DEPTH", "3")
    if caller == "grade":
        clip = _write_clip(tmp_path / "clip.mp4", 7, size=(48, 32), seed=5)
        result = tap.apply_adjust_to_video(
            clip, str(tmp_path / "out.mp4"), {"contrast": 25}, batch_size=2,
            device="cpu")
        assert result["processed_frames"] == 7
    else:
        frames = np.random.default_rng(5).integers(0, 256, (7, 8, 8, 3),
                                                   np.uint8)
        done, _ = tenh.enhance_batches(
            [(i, frames[i:i + 2]) for i in range(0, 7, 2)],
            EnhancerSettings.normalize({"sharpen_strength": 1.0}), 8, 8,
            device="cpu", batch_size=2, write=lambda out: None)
        assert done == 7
    assert {depth for depth, _ in full} == {3}
    assert max(length for _, length in full) == 3
