"""The port's targeted far-face repair (vrgdg_tpu_torch.jobs.face_repair)
against vrgdg_tpu.jobs.face_repair on the CPU.

The parsing, geometry, masks, colour match and prepare are host code
copied from the original: results, manifests and written files exactly
equal (apart from the run's folders).  The lanczos4 rescale
(``_resize_u8``) runs as torch ops: uint8 within one level of the JAX
package's on at most 0.1% of values, and so the composited frames; the
rebuilt video's frame count and size exact.  The ``face-repair``
command's four actions run beside the JAX command, with a manual box and
with the real YuNet detector.
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu.jobs import face_repair as jfr
from vrgdg_tpu_torch import cli
from vrgdg_tpu_torch.jobs import face_repair as tfr
from vrgdg_tpu_torch.jobs.face_fix import DEFAULT_ASSETS_DIR

YUNET = os.path.join(DEFAULT_ASSETS_DIR, "face_detection_yunet_2023mar.onnx")


def _within_one_level(got, want, share=1e-3):
    diff = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    assert np.shape(got) == np.shape(want)
    assert diff.max() <= 1 and (diff > 0).mean() <= share, \
        (int(diff.max()), float((diff > 0).mean()))


def _normalized(value, roots):
    if isinstance(value, dict):
        return {k: _normalized(v, roots) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalized(v, roots) for v in value]
    if isinstance(value, str):
        for root in roots:
            value = value.replace(root, "<root>")
    return value


# --------------------------------------------------------------------------
# the copied host code
# --------------------------------------------------------------------------

def test_parsing_copy():
    for text in ("120-160,300-318", "5", "9-3", "0-0", " 7 , 9-12 ",
                 "1-2\n8-4", ",,3,", "10-10,10-10"):
        assert tfr.parse_ranges(text) == jfr.parse_ranges(text)
        assert tfr.frames_in_ranges(tfr.parse_ranges(text)) \
            == jfr.frames_in_ranges(jfr.parse_ranges(text))
    for bad in ("", ",,,", "a-b", "5-", "-3"):
        with pytest.raises(ValueError):
            tfr.parse_ranges(bad)
    for text in ("", "10,20,30,40", "10,20,5,8", "100x50x40x30",
                 "12.7,3.2,50.9,60.1"):
        assert tfr.parse_box(text) == jfr.parse_box(text)
    with pytest.raises(ValueError, match="four numbers"):
        tfr.parse_box("1,2,3")


@pytest.mark.parametrize("seed", range(3))
def test_pick_face_and_crop_copy(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        width, height = int(rng.integers(64, 1920)), int(rng.integers(64,
                                                                      1080))
        faces = [(int(rng.integers(0, width - 8)),
                  int(rng.integers(0, height - 8)),
                  int(rng.integers(4, 200)), int(rng.integers(4, 200)),
                  float(rng.random())) for _ in range(int(rng.integers(0, 5)))]
        for mode in ("largest", "center"):
            mine = tfr.pick_face(faces, width, height, mode)
            assert mine == jfr.pick_face(faces, width, height, mode)
            if mine is not None:
                padding = float(rng.uniform(1.0, 4.0))
                assert tfr.expanded_crop_box(mine, width, height, padding) \
                    == jfr.expanded_crop_box(mine, width, height, padding)


@pytest.mark.parametrize("size,feather", [((40, 40), 6), ((31, 57), 0),
                                          ((120, 90), 18)])
def test_mask_and_color_match_copy(size, feather):
    mask = tfr.soft_ellipse_mask(*size, feather)
    np.testing.assert_array_equal(mask, jfr.soft_ellipse_mask(*size,
                                                              feather))
    rng = np.random.default_rng(feather)
    original = rng.integers(0, 256, (size[1], size[0], 3), np.uint8)
    repaired = rng.integers(0, 256, (size[1], size[0], 3), np.uint8)
    np.testing.assert_array_equal(
        tfr.match_crop_colors(original, repaired, mask),
        jfr.match_crop_colors(original, repaired, mask))


@pytest.mark.parametrize("shape,size", [((40, 40, 3), (97, 97)),
                                        ((97, 61, 3), (40, 33)),
                                        ((50, 64), (120, 100)),
                                        ((48, 640, 3), (31, 413))])
def test_resize_u8_matches(shape, size):
    image = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                       np.uint8)
    got = tfr._resize_u8(image, *size, device="cpu")
    want = jfr._resize_u8(image, *size)
    assert got.dtype == want.dtype == np.uint8
    _within_one_level(got, want)


def test_detector_selection_and_device_refusal(tmp_path):
    frame = np.full((80, 80, 3), 128, np.uint8)
    if getattr(cv2, "CascadeClassifier", None) is not None:
        assert tfr.detect_repair_faces(frame, "opencv", 0.35) == []
    else:
        with pytest.raises(RuntimeError, match="CascadeClassifier"):
            tfr.detect_repair_faces(frame, "opencv", 0.35)
    with pytest.raises(ValueError, match="Unknown detector"):
        tfr.detect_repair_faces(frame, "mediapipe", 0.35)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfr.composite(str(tmp_path / "manifest.json"))


# --------------------------------------------------------------------------
# prepare -> composite -> contact sheet -> rebuild, beside the JAX package
# --------------------------------------------------------------------------

def _write_clip(path, frames=12, size=(120, 160)):
    h, w = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (w, h))
    rng = np.random.default_rng(0)
    for i in range(frames):
        frame = np.full((h, w, 3), 40 + i, np.uint8)
        frame[30:70, 50:90] = (90, 150, 200)
        frame += rng.integers(0, 5, frame.shape, dtype=np.uint8)
        writer.write(frame)
    writer.release()
    return path


def _tint(manifest_path, folder):
    os.makedirs(folder, exist_ok=True)
    with open(manifest_path, encoding="utf-8") as handle:
        manifest = json.load(handle)
    for entry in manifest["entries"]:
        crop = cv2.imread(entry["crop"], cv2.IMREAD_COLOR)
        crop[..., 2] = 255
        crop = cv2.resize(crop, (64, 64), interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(folder, entry["repaired_name"]), crop)
    return manifest


@pytest.fixture(scope="module")
def repairs(tmp_path_factory):
    out = {}
    for name, module in (("jax", jfr), ("port", tfr)):
        root = str(tmp_path_factory.mktemp(f"repair_{name}"))
        clip = _write_clip(os.path.join(root, "clip.mp4"))
        result = module.prepare(clip, "2-4,7", os.path.join(root, "repair"),
                                manual_box="50,30,40,40", padding=1.5,
                                feather=6)
        manifest = _tint(result["manifest_path"], os.path.join(root, "fixed"))
        out[name] = {"root": root, "result": result, "manifest": manifest,
                     "module": module}
    return out


def _kw(name, **kw):
    return kw if name == "jax" else dict(kw, device="cpu")


def test_prepare_matches(repairs):
    roots = (repairs["jax"]["root"], repairs["port"]["root"])
    got, want = repairs["port"], repairs["jax"]
    assert _normalized(got["result"], roots) == _normalized(want["result"],
                                                            roots)
    assert _normalized(got["manifest"], roots) \
        == _normalized(want["manifest"], roots)
    for ours, theirs in zip(got["manifest"]["entries"],
                            want["manifest"]["entries"]):
        for key in ("original_frame", "crop", "mask"):
            with open(ours[key], "rb") as a, open(theirs[key], "rb") as b:
                assert a.read() == b.read(), key


@pytest.mark.parametrize("feather,color_match", [(6, False), (6, True),
                                                 (-1, False), (30, True)])
def test_composite_matches(repairs, feather, color_match):
    roots = (repairs["jax"]["root"], repairs["port"]["root"])
    results = {}
    for name, job in repairs.items():
        out_dir = os.path.join(job["root"], f"comp_{feather}_{color_match}")
        results[name] = job["module"].composite(
            job["result"]["manifest_path"],
            repaired_dir=os.path.join(job["root"], "fixed"), out_dir=out_dir,
            **_kw(name, feather=feather, color_match=color_match))
    assert _normalized(results["port"], roots) \
        == _normalized(results["jax"], roots)
    assert results["port"]["written"] == 4
    for entry in repairs["port"]["manifest"]["entries"]:
        name = f"frame_{entry['frame']:06d}.png"
        _within_one_level(
            cv2.imread(os.path.join(results["port"]["out_dir"], name)),
            cv2.imread(os.path.join(results["jax"]["out_dir"], name)))


@pytest.mark.parametrize("thumb_width", [900, 200])
def test_contact_sheet_and_rebuild_match(repairs, thumb_width):
    roots = (repairs["jax"]["root"], repairs["port"]["root"])
    sheets, videos = {}, {}
    for name, job in repairs.items():
        manifest = job["result"]["manifest_path"]
        job["module"].composite(manifest, repaired_dir=os.path.join(
            job["root"], "fixed"), **_kw(name, feather=6))
        sheets[name] = job["module"].contact_sheet(
            manifest, out_path=os.path.join(job["root"],
                                            f"sheet_{thumb_width}.jpg"),
            **_kw(name, columns=2, thumb_width=thumb_width))
        videos[name] = [job["module"].rebuild_video(
            manifest, os.path.join(job["root"], f"{kind}.mp4"),
            **_kw(name, only_ranges=kind == "ranges"))
            for kind in ("full", "ranges")]
    assert _normalized(sheets["port"], roots) == _normalized(sheets["jax"],
                                                             roots)
    ours = cv2.imread(sheets["port"]["sheet_path"]).astype(np.int16)
    theirs = cv2.imread(sheets["jax"]["sheet_path"]).astype(np.int16)
    assert ours.shape == theirs.shape
    # JPEG of inputs at most one level apart
    assert np.abs(ours - theirs).mean() < 0.5
    assert _normalized(videos["port"], roots) == _normalized(videos["jax"],
                                                             roots)
    assert [v["written"] for v in videos["port"]] == [12, 4]
    for video in videos["port"]:
        capture = cv2.VideoCapture(video["output"])
        count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
        size = (int(capture.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        capture.release()
        assert (count, size) == (video["written"], (160, 120))


def test_composite_skips_missing_crops(tmp_path):
    clip = _write_clip(str(tmp_path / "clip.mp4"), frames=6)
    result = tfr.prepare(clip, "1-2", str(tmp_path / "r"),
                         manual_box="50,30,40,40")
    comp = tfr.composite(result["manifest_path"],
                         repaired_dir=str(tmp_path / "empty"), device="cpu")
    assert comp["written"] == 0 and len(comp["skipped"]) == 2


# --------------------------------------------------------------------------
# the face-repair command, all four actions, beside the JAX command
# --------------------------------------------------------------------------

def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def _face_clip(path):
    """Twelve 640x480 frames of the cartoon face of
    tests/test_face_detector.py, panning."""
    from tests.test_torch_face_fix import _face_clip as draw

    return draw(path)


def _command_chain(main, root, prepare_flags, extra, capsys):
    clip = _face_clip(os.path.join(root, "face.mp4"))
    out_dir = os.path.join(root, "repair")
    prepared = _run(main, ["face-repair", "prepare", "--video", clip,
                           "--ranges", "1-3,8", "--out", out_dir,
                           "--padding", "1.6", "--feather", "10",
                           *prepare_flags, *extra], capsys)
    fixed = os.path.join(root, "fixed")
    _tint(prepared["manifest_path"], fixed)
    manifest = prepared["manifest_path"]
    return [prepared,
            _run(main, ["face-repair", "composite", "--manifest", manifest,
                        "--repaired-dir", fixed, "--color-match",
                        "--feather", "10", *extra], capsys),
            _run(main, ["face-repair", "contact-sheet", "--manifest",
                        manifest, "--columns", "2", "--thumb-width", "500",
                        *extra], capsys),
            _run(main, ["face-repair", "rebuild-video", "--manifest",
                        manifest, "--out", os.path.join(root, "preview.mp4"),
                        *extra], capsys)]


@pytest.mark.parametrize("detector", ["manual", "yunet"])
def test_face_repair_command_matches_jax(tmp_path, capsys, detector):
    if detector == "yunet" and not os.path.isfile(YUNET):
        pytest.skip("the YuNet asset is not in assets/")
    from vrgdg_tpu import cli as jcli

    flags = (["--manual-box", "200,80,240,320"] if detector == "manual"
             else ["--detector", "auto", "--min-confidence", "0.3"])
    roots = (str(tmp_path / "jax"), str(tmp_path / "port"))
    for root in roots:
        os.makedirs(root)
    want = _command_chain(jcli.main, roots[0], flags, [], capsys)
    got = _command_chain(cli.main, roots[1], flags, ["--device", "cpu"],
                         capsys)
    assert _normalized(got, roots) == _normalized(want, roots)
    assert got[0]["crops"] == 4 and got[1]["written"] == 4
    assert got[3] == {**got[3], "written": 12, "replaced": 4}
    for name in ("frame_000001.png", "frame_000008.png"):
        _within_one_level(
            cv2.imread(os.path.join(got[1]["out_dir"], name)),
            cv2.imread(os.path.join(want[1]["out_dir"], name)))
