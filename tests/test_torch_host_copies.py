"""The host modules the port's server needs, held equal to their originals.

``vrgdg_tpu_torch.runtime.{audio, audio_toolkit, beats}``,
``vrgdg_tpu_torch.release_notes`` and the rest of
``vrgdg_tpu_torch.runtime.video_io`` are copies of JAX-free modules of
``vrgdg_tpu`` (which cannot be imported without JAX). Each copied function
keeps its original's source, and both run here on the same seeded inputs:
dicts, arrays and WAV bytes equal, video files decoding equal, and the
``beats``, ``scene-srt`` and ``audio peaks`` commands printing the same
JSON as ``vrgdg_tpu.cli``'s.
"""

import inspect
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu import release_notes as j_notes
from vrgdg_tpu.runtime import audio as j_audio
from vrgdg_tpu.runtime import audio_toolkit as j_at
from vrgdg_tpu.runtime import beats as j_beats
from vrgdg_tpu.runtime import video_io as j_vio
from vrgdg_tpu_torch import release_notes as t_notes
from vrgdg_tpu_torch.runtime import audio as t_audio
from vrgdg_tpu_torch.runtime import audio_toolkit as t_at
from vrgdg_tpu_torch.runtime import beats as t_beats
from vrgdg_tpu_torch.runtime import video_io as t_vio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_VIDEO_IO_COPIES = (
    "safe_name", "pad_frames_array", "split_frames", "add_preroll_frames",
    "trim_image_batch", "trim_image_batch_srt", "build_chunk_output_path",
    "trim_final_clip", "combine_scene_videos", "list_final_set_videos",
    "assemble_final_video", "find_grid_videos", "_fit_grid_tile",
    "render_video_grid", "add_label_bar", "save_labeled_set_video")


def _functions(module):
    return sorted(name for name, value in vars(module).items()
                  if inspect.isfunction(value)
                  and value.__module__ == module.__name__)


def _normalized(source: str) -> str:
    # the copies cite the reference's files by name alone, where the
    # originals give the reference tree's absolute path, and name their
    # own package where a docstring points at a sibling module
    return (re.sub(r"/\w+/reference/", "", source)
            .replace("vrgdg_tpu.runtime.", "vrgdg_tpu_torch.runtime."))


@pytest.mark.parametrize("original,copy", [
    (j_audio, t_audio), (j_at, t_at), (j_beats, t_beats),
    (j_notes, t_notes)], ids=["audio", "audio_toolkit", "beats",
                              "release_notes"])
def test_copied_modules_keep_every_function_source(original, copy):
    names = _functions(original)
    assert names == _functions(copy)
    for name in names:
        assert inspect.getsource(getattr(copy, name)) == _normalized(
            inspect.getsource(getattr(original, name))), name


@pytest.mark.parametrize("name", _VIDEO_IO_COPIES)
def test_video_io_copies_keep_their_source(name):
    assert inspect.getsource(getattr(t_vio, name)) == _normalized(
        inspect.getsource(getattr(j_vio, name)))


def test_video_io_constants_equal():
    assert t_vio.GRID_LABEL_BAND == j_vio.GRID_LABEL_BAND
    assert t_vio._GRID_VIDEO_EXTENSIONS == j_vio._GRID_VIDEO_EXTENSIONS
    assert t_vio.VIDEO_EXTENSIONS == j_vio.VIDEO_EXTENSIONS


# --------------------------------------------------------------------------
# audio
# --------------------------------------------------------------------------

SR = 22050


def click_track(bpm=120.0, seconds=8.0, sr=SR, amplitude=0.9, seed=7):
    """Decaying noise bursts every beat over a quiet noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    y = rng.normal(0.0, 0.003, n).astype(np.float32)
    burst = np.exp(-np.linspace(0.0, 6.0, int(0.02 * sr))).astype(np.float32)
    t = 0.0
    while t < seconds:
        start = int(t * sr)
        end = min(n, start + burst.size)
        y[start:end] += amplitude * burst[:end - start] \
            * rng.normal(0.0, 1.0, end - start).astype(np.float32)
        t += 60.0 / bpm
    return y


def _audio(mono, channels=2, sr=SR):
    return j_at.make_audio(np.tile(mono, (1, channels, 1)), sr)


def _same(a, b):
    """Deep equality over dicts, lists, tuples and numpy arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_analyze_beats_with_stems_equal():
    mix = click_track()
    stems = {"drums": _audio(click_track(amplitude=1.0, seed=8)),
             "bass": _audio(click_track(amplitude=0.3, seed=9)),
             "vocals": _audio(np.zeros_like(mix)),
             "other": _audio(click_track(amplitude=0.5, seed=10))}
    ours = t_beats.analyze_beats(_audio(mix), **stems)
    theirs = j_beats.analyze_beats(_audio(mix), **stems)
    _same(ours, theirs)
    assert abs(ours["bpm"] - 120.0) < 6.0 and ours["beats"]


@pytest.mark.parametrize("preset", ["impact_weighted", "varied_no_repeat",
                                    "clustered_no_repeat"])
def test_generate_scene_srt_equal(preset, tmp_path):
    data = j_beats.analyze_beats(_audio(click_track(seconds=20.0)))
    kwargs = dict(min_duration=1.5, max_duration=5.0, bias=0.6,
                  duration_preset=preset, seed=3)
    ours = t_beats.generate_scene_srt(
        data, output_path=str(tmp_path / "t.srt"), **kwargs)
    theirs = j_beats.generate_scene_srt(
        data, output_path=str(tmp_path / "j.srt"), **kwargs)
    assert ours.pop("srt_path").endswith("t.srt")
    assert theirs.pop("srt_path").endswith("j.srt")
    _same(ours, theirs)
    assert (tmp_path / "t.srt").read_bytes() == \
        (tmp_path / "j.srt").read_bytes()


def test_save_wav_bytes_and_peaks_equal(tmp_path):
    audio = _audio(click_track(seconds=3.0))
    ours, theirs = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    t_at.save_wav(ours, audio)
    j_at.save_wav(theirs, audio)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for target in (600, 37):
        _same(t_audio.read_audio_peaks(ours, target),
              j_audio.read_audio_peaks(theirs, target))
    _same(t_at.load_audio(ours), j_at.load_audio(theirs))


@pytest.mark.parametrize("payload", [
    {"duration": 2.5}, {"duration": "1.25", "scope": "scene",
                        "scene_number": 3}])
def test_create_silent_audio_equal(payload, tmp_path):
    ours = t_audio.create_silent_audio(
        {**payload, "project_folder": str(tmp_path / "t")})
    theirs = j_audio.create_silent_audio(
        {**payload, "project_folder": str(tmp_path / "j")})
    for result, tag in ((ours, "t"), (theirs, "j")):
        for key in ("audio_path", "saved_path", "audio_folder"):
            result[key] = os.path.relpath(result[key], tmp_path / tag)
    _same(ours, theirs)
    with open(tmp_path / "t" / ours["audio_path"], "rb") as a, \
            open(tmp_path / "j" / theirs["audio_path"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("pad", [False, True])
def test_split_audio_by_durations_equal(pad):
    audio = _audio(click_track(seconds=12.0))
    _same(t_at.split_audio_by_durations(audio, [2.0, 3.5, 4.0], 0.5,
                                        pad_to_chunk=pad, gain_db=-3.0),
          j_at.split_audio_by_durations(audio, [2.0, 3.5, 4.0], 0.5,
                                        pad_to_chunk=pad, gain_db=-3.0))


@pytest.mark.parametrize("chunk,pre,tail", [(0, 6, 0), (1, 4, 5), (2, 0, 5)])
def test_split_audio_srt_equal(chunk, pre, tail):
    audio = _audio(click_track(seconds=10.0))
    srt = ("1\n00:00:00,000 --> 00:00:03,000\nA\n\n"
           "2\n00:00:03,000 --> 00:00:07,000\nB\n\n"
           "3\n00:00:07,000 --> 00:00:09,500\nC\n")
    _same(t_at.split_audio_srt(audio, chunk, srt_source=srt, fps=24,
                               tail_loss_frames=tail, pre_frames=pre),
          j_at.split_audio_srt(audio, chunk, srt_source=srt, fps=24,
                               tail_loss_frames=tail, pre_frames=pre))


@pytest.mark.parametrize("index,delay", [(0, 40.0), (3, 40.0), (2, -25.0)])
def test_delay_audio_by_index_equal(index, delay):
    audio = _audio(click_track(seconds=1.0), sr=8000)
    _same(t_at.delay_audio_by_index(audio, index, delay),
          j_at.delay_audio_by_index(audio, index, delay))


# --------------------------------------------------------------------------
# release notes
# --------------------------------------------------------------------------

def test_release_notes_equal(tmp_path):
    _same(t_notes.load_release_notes(), j_notes.load_release_notes())
    assert t_notes._notes_path() == j_notes._notes_path()
    document, source = t_notes.load_release_notes()
    assert source == "local"
    assert t_notes.latest_release(document) == \
        j_notes.latest_release(document)
    missing = str(tmp_path / "none.json")
    _same(t_notes.load_release_notes(missing),
          j_notes.load_release_notes(missing))
    odd = tmp_path / "odd.json"
    odd.write_text(json.dumps({"product": "x", "releases": "nope"}))
    _same(t_notes.load_release_notes(str(odd)),
          j_notes.load_release_notes(str(odd)))
    assert t_notes.latest_release({"releases": []}) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for module in (t_notes, j_notes):
        with pytest.raises(ValueError):
            module.load_release_notes(str(bad))


# --------------------------------------------------------------------------
# video_io
# --------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["my clip (1).mp4", "../../etc/passwd",
                                   "", None, "a" * 150 + ".mp4",
                                   "  ..hidden.MOV  ", "x.m!p@4"])
def test_safe_name_equal(value):
    assert t_vio.safe_name(value, "uploaded_video") == \
        j_vio.safe_name(value, "uploaded_video")


def _frames(seed, count=7, h=24, w=32):
    return np.random.default_rng(seed).random((count, h, w, 3),
                                              dtype=np.float32)


def test_frame_batch_helpers_equal():
    frames = _frames(0)
    for pad, front in ((3, False), (2, True), (0, True)):
        _same(t_vio.pad_frames_array(frames, pad, front),
              j_vio.pad_frames_array(frames, pad, front))
    for count, per in ((3, 3), (4, 2), (1, 10)):
        _same(t_vio.split_frames(frames, count, per),
              j_vio.split_frames(frames, count, per))
    _same(t_vio.split_frames(frames[:0], 2, 3),
          j_vio.split_frames(frames[:0], 2, 3))
    for args in ((97, 0, 6), (97, 2, 6), (41, 1, 0)):
        assert t_vio.add_preroll_frames(*args) == \
            j_vio.add_preroll_frames(*args)
    for args in ((4, 2, 0, 1), (4, 2, 1, 1), (10, 1, 1, 6), (3, 0, 0)):
        _same(t_vio.trim_image_batch(frames, *args),
              j_vio.trim_image_batch(frames, *args))
    for args in ((4, 0, 0), (4, 2, 1), (3, 9, 2)):
        _same(t_vio.trim_image_batch_srt(frames, *args),
              j_vio.trim_image_batch_srt(frames, *args))


@pytest.mark.parametrize("mode,srt", [("overwrite", False), ("backup", False),
                                      ("backup", True)])
def test_build_chunk_output_path_equal(mode, srt, tmp_path):
    for tag in ("t", "j"):
        os.makedirs(tmp_path / tag)
        for name in ("video_0001.mp4", "video_0002_0001.mp4",
                     "video_00010.mp4"):
            (tmp_path / tag / name).write_bytes(b"x")
    ours = t_vio.build_chunk_output_path(str(tmp_path / "t"), 1, "video_07",
                                         mode, srt)
    theirs = j_vio.build_chunk_output_path(str(tmp_path / "j"), 1,
                                           "video_07", mode, srt)
    assert os.path.relpath(ours, tmp_path / "t") == \
        os.path.relpath(theirs, tmp_path / "j")
    listing = [sorted(os.path.relpath(os.path.join(root, name), top)
                      for root, _, names in os.walk(top) for name in names)
               for top in (tmp_path / "t", tmp_path / "j")]
    # backups carry a time stamp in the plain scheme: compare their stems
    strip = [[name.split(".mp4.")[0] for name in names] for names in listing]
    assert strip[0] == strip[1]


def _write_clip(path, count, value_seed, size=(32, 24), fps=10.0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             size)
    rng = np.random.default_rng(value_seed)
    for _ in range(count):
        writer.write(rng.integers(0, 255, (size[1], size[0], 3), np.uint8))
    writer.release()
    return str(path)


def _decode(path):
    capture = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return np.stack(frames)


def test_trim_final_clip_equal(tmp_path):
    outs = []
    for tag in ("t", "j"):
        folder = tmp_path / tag
        os.makedirs(folder)
        _write_clip(folder / "video_0000.mp4", 20, 1)
        _write_clip(folder / "video_0001.mp4", 20, 2)
        module = t_vio if tag == "t" else j_vio
        assert module.trim_final_clip(str(folder), "video", 20, 3.0, 0, 2,
                                      10) == ""
        final = module.trim_final_clip(str(folder), "video", 20, 3.0, 1, 2,
                                       10, overwrite=False)
        outs.append(final)
    assert os.path.basename(outs[0]) == os.path.basename(outs[1])
    np.testing.assert_array_equal(_decode(outs[0]), _decode(outs[1]))


def test_render_video_grid_equal(tmp_path):
    a = _write_clip(tmp_path / "a.mp4", 5, 3)
    b = _write_clip(tmp_path / "b.mp4", 3, 4, size=(48, 24))
    _write_clip(tmp_path / "c_VIDEOGRID_1.mp4", 2, 5)
    assert t_vio.find_grid_videos(str(tmp_path)) == \
        j_vio.find_grid_videos(str(tmp_path)) == [a, b]
    arrays = _frames(6, count=4)
    for sources, kwargs in (([a, b], {}),
                            ([a, arrays, b], {"labels": ["one", "", "3"]}),
                            ([b], {"cell_width": 40, "cell_height": 50,
                                   "label_tiles": False})):
        _same(t_vio.render_video_grid(sources, **kwargs),
              j_vio.render_video_grid(sources, **kwargs))


def test_label_bar_and_combiners_equal(tmp_path):
    clips = [_frames(10 + i, count=5 + i) for i in range(3)]
    _same(t_vio.add_label_bar(clips[0], "set 1 - group 2"),
          j_vio.add_label_bar(clips[0], "set 1 - group 2"))
    for meta, kwargs in (({"durations": [0.3, 0.0, 0.5]}, {"fps": 10.0}),
                         ({"durations": [0.3, 0.0, 0.9]},
                          {"fps": 10.0, "pad_short": True}),
                         ({"durations_frames": [2, 9, 1]},
                          {"index": 1, "total_sets": 2,
                           "groups_in_last_set": 2})):
        videos = [clips[0], None, clips[1], clips[2]][:3]
        _same(t_vio.combine_scene_videos(videos, meta, **kwargs),
              j_vio.combine_scene_videos(videos, meta, **kwargs))
    meta = {"durations": [0.4, 0.6, 0.5]}
    ours = t_vio.save_labeled_set_video(clips, meta, str(tmp_path / "t"),
                                        fps=10.0, index=1, total_sets=3)
    theirs = j_vio.save_labeled_set_video(clips, meta, str(tmp_path / "j"),
                                          fps=10.0, index=1, total_sets=3)
    assert os.path.relpath(ours, tmp_path / "t") == \
        os.path.relpath(theirs, tmp_path / "j")
    np.testing.assert_array_equal(_decode(ours), _decode(theirs))


def test_assemble_final_video_equal(tmp_path):
    audio = _audio(click_track(seconds=2.0), sr=8000)
    outs = []
    for tag, module in (("t", t_vio), ("j", j_vio)):
        folder = tmp_path / tag
        os.makedirs(folder)
        _write_clip(folder / "set1-audio.mp4", 4, 20)
        _write_clip(folder / "set2-audio.mp4", 6, 21)
        _write_clip(folder / "ignored.mp4", 3, 22)
        first = module.assemble_final_video(str(folder), threshold=3)
        assert first["skipped"] and first["count"] == 2
        assert module.list_final_set_videos(str(folder)) == [
            "set1-audio.mp4", "set2-audio.mp4"]
        result = module.assemble_final_video(str(folder), audio=audio,
                                              threshold=2)
        outs.append(result)
    for result, tag in zip(outs, ("t", "j")):
        result["output"] = os.path.relpath(result["output"], tmp_path / tag)
    _same(outs[0], outs[1])
    np.testing.assert_array_equal(
        _decode(tmp_path / "t" / outs[0]["output"]),
        _decode(tmp_path / "j" / outs[1]["output"]))


# --------------------------------------------------------------------------
# the beats, scene-srt and audio peaks commands
# --------------------------------------------------------------------------

def _cli(package, args, cwd):
    done = subprocess.run([sys.executable, "-m", f"{package}.cli", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300, check=False,
                          env={**os.environ, "PYTHONPATH": REPO,
                               "JAX_PLATFORMS": "cpu"})
    assert done.returncode == 0, done.stderr
    return json.loads(done.stdout)


def test_audio_commands_print_what_the_jax_cli_prints(tmp_path):
    mix = str(tmp_path / "mix.wav")
    drums = str(tmp_path / "drums.wav")
    j_at.save_wav(mix, _audio(click_track(seconds=10.0)))
    j_at.save_wav(drums, _audio(click_track(seconds=10.0, amplitude=1.0,
                                            seed=8)))
    for args in (["beats", mix, "--drums", drums],
                 ["audio", "peaks", mix, "--target-peaks", "300"]):
        assert _cli("vrgdg_tpu_torch", args, str(tmp_path)) == \
            _cli("vrgdg_tpu", args, str(tmp_path))
    outs = []
    for package in ("vrgdg_tpu_torch", "vrgdg_tpu"):
        data = str(tmp_path / f"{package}.json")
        written = _cli(package, ["beats", mix, "-o", data], str(tmp_path))
        assert written.pop("output") == data
        srt = str(tmp_path / f"{package}.srt")
        result = _cli(package, ["scene-srt", data, "-o", srt,
                                "--duration-preset", "varied_no_repeat",
                                "--seed", "4"], str(tmp_path))
        assert result.pop("srt_path") == srt
        with open(data, encoding="utf-8") as handle, \
                open(srt, encoding="utf-8") as srt_handle:
            outs.append((written, handle.read(), result, srt_handle.read()))
    assert outs[0] == outs[1]
