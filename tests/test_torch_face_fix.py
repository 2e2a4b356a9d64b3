"""The port's Face Fix job engine (vrgdg_tpu_torch.jobs.face_fix) against
vrgdg_tpu.jobs.face_fix on the CPU.

The geometry, tracking, prepare and accept endpoints are host code copied
from the original: their results, manifests and crops are held exactly
equal (apart from job ids, timestamps and the run's folders).  Finalize
composites as torch ops: its PNGs within one level of the JAX package's
on at most 0.1% of values, its video's frame count and size exact.  The
ffmpeg branches run through tests/fake_ffmpeg.py.  The ``face-fix``
command's seven actions run end to end with the real YuNet detector on
a small clip, beside the JAX command.
"""

import json
import os
import re
import shutil
import stat

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu.jobs import face_fix as jff
from vrgdg_tpu_torch import cli
from vrgdg_tpu_torch.jobs import face_fix as tff
from vrgdg_tpu_torch.runtime import video_io as tvideo_io

HERE = os.path.dirname(os.path.abspath(__file__))
YUNET = os.path.join(jff.DEFAULT_ASSETS_DIR,
                     "face_detection_yunet_2023mar.onnx")


# --------------------------------------------------------------------------
# geometry, tracking and strength: the copied host code
# --------------------------------------------------------------------------

def _boxes(seed, count):
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0, 600)), float(rng.uniform(0, 400)),
             float(rng.uniform(2, 150)), float(rng.uniform(2, 150)),
             float(rng.random())) for _ in range(count)]


@pytest.mark.parametrize("seed", range(4))
def test_geometry_copy(seed):
    boxes = _boxes(seed, 10)
    for a in boxes:
        for b in boxes:
            assert tff.box_iou(a[:4], b[:4]) == jff.box_iou(a[:4], b[:4])
        for scale in (4.0, 4.5):
            assert tff.expanded_region(a[:4], 640, 480, scale) \
                == jff.expanded_region(a[:4], 640, 480, scale)
        for padding in (0.0, 0.1, 2.0):
            assert tff.square_crop_box(a[:4], 640, 480, padding) \
                == jff.square_crop_box(a[:4], 640, 480, padding)
    assert tff.dedup_detections(boxes) == jff.dedup_detections(boxes)
    for previous in (None, boxes[0][:4]):
        for minimum in (4, 40):
            assert tff.select_tracked(boxes, previous, 640, 480, minimum) \
                == jff.select_tracked(boxes, previous, 640, 480, minimum)
    assert tff.smooth_box(boxes[1][:4], boxes[2]) \
        == jff.smooth_box(boxes[1][:4], boxes[2])


@pytest.mark.parametrize("size", [(320, 240), (640, 480), (1920, 1080)])
def test_regions_and_anchor_indices_copy(size):
    assert tff.initial_regions(*size) == jff.initial_regions(*size)
    for count in (0, 1, 9, 40, 72, 300):
        for interval in (None, 1, 8, 16, 500):
            assert tff.face_fix_anchor_indices(count, interval) \
                == jff.face_fix_anchor_indices(count, interval)
    raw = list(np.random.default_rng(size[0]).integers(-5, 50, 12))
    assert tff.safe_ltx_indices(raw, 33) == jff.safe_ltx_indices(raw, 33)


@pytest.mark.parametrize("preset", ["very_far", "far", "far_medium", "all",
                                    "custom", "bogus", None])
def test_distance_strength_copy(preset):
    for width in np.linspace(0.0, 15.0, 31):
        assert tff.distance_repair_strength(width, preset, 9.0) \
            == jff.distance_repair_strength(width, preset, 9.0)


def test_tracker_copy():
    hits = [None if i in (3, 4, 7, 8, 9) else (10.0 + i, 20.0, 16.0, 16.0,
                                               0.9) for i in range(14)]
    ours, theirs = tff.FaceTracker(), jff.FaceTracker()
    for hit in hits:
        assert tff.FaceTracker.search_regions(ours, 640, 480) \
            == jff.FaceTracker.search_regions(theirs, 640, 480)
        assert tuple(ours.observe(hit)) == tuple(theirs.observe(hit))
        assert (ours.box, ours.run_id) == (theirs.box, theirs.run_id)
    assert (ours.runs_opened, ours.carried_frames, ours.skipped_frames) == (
        theirs.runs_opened, theirs.carried_frames, theirs.skipped_frames)


def _square_detector(frame, region):
    """Find the bright square in the region: a stand-in for cv2.dnn."""
    left, top, right, bottom = region
    patch = frame[top:bottom, left:right]
    mask = patch[..., 0] > 150
    if not mask.any():
        return []
    ys, xs = np.nonzero(mask)
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    return [(left + float(x0), top + float(y0), float(x1 - x0),
             float(y1 - y0), 0.95)]


@pytest.mark.parametrize("assist", ["off", "light", "strong"])
def test_detect_with_rotation_copy(assist):
    frame = np.full((480, 640, 3), 30, np.uint8)
    frame[200:240, 300:340] = 220
    frame[40:60, 500:530] = 210
    regions = tff.initial_regions(640, 480)
    assert tff.detect_with_rotation(_square_detector, frame, 0.5, regions,
                                    assist) \
        == jff.detect_with_rotation(_square_detector, frame, 0.5, regions,
                                    assist)


def test_default_assets_dir_is_the_repository_folder():
    assert os.path.abspath(tff.DEFAULT_ASSETS_DIR) \
        == os.path.abspath(jff.DEFAULT_ASSETS_DIR)
    with pytest.raises(RuntimeError, match="compatible OpenCV face"):
        tff.load_default_detector(os.path.join(HERE, "no_such_assets"))


# --------------------------------------------------------------------------
# the job on a synthetic clip, beside the JAX package's
# --------------------------------------------------------------------------

FRAMES, W, H = 20, 320, 240
FACE_W = 16


def _face_box(i):
    return (40 + 2 * i, 60 + i, FACE_W, FACE_W)


def _write_scene(path):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (W, H))
    rng = np.random.default_rng(1)
    for i in range(FRAMES):
        frame = rng.integers(30, 60, (H, W, 3), dtype=np.uint8)
        x, y, w, h = _face_box(i)
        frame[y:y + h, x:x + w] = 200
        frame[y + 4:y + 7, x + 3:x + 13] = (90, 120, 230)
        writer.write(frame)
    writer.release()
    return path


_STAMPS = [(re.compile(r"face_fix_\d{8}_\d{6}_[0-9a-f]{8}"), "<job>"),
           (re.compile(r"_facefix_\d{8}_\d{6}"), "_facefix_<time>")]


def _normalized(value, roots):
    """A result or manifest with the run's folders, job ids and
    timestamps replaced by placeholders."""
    if isinstance(value, dict):
        return {k: _normalized(v, roots) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalized(v, roots) for v in value]
    if isinstance(value, str):
        for root in roots:
            value = value.replace(root, "<root>")
        for pattern, text in _STAMPS:
            value = pattern.sub(text, value)
    return value


def _decode_all(path):
    capture = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return frames


def _within_one_level(got, want, share=1e-3):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape
    assert diff.max() <= 1 and (diff > 0).mean() <= share, \
        (int(diff.max()), float((diff > 0).mean()))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The same scene prepared by both packages, each in its own root."""
    out = {}
    for name, module in (("jax", jff), ("port", tff)):
        root = str(tmp_path_factory.mktemp(f"facefix_{name}"))
        scene = _write_scene(os.path.join(root, "scene.mp4"))
        result = module.prepare_face_fix({
            "video_path": scene, "project_folder": root, "whole_scene": True,
            "repair_distance": "far", "rotation_assist": "off",
            "minimum_face_pixels": 8, "anchor_interval": 8},
            detector=_square_detector)
        out[name] = {"root": root, "scene": scene, "prepared": result,
                     "module": module}
    return out


def _manifest(job):
    with open(job["prepared"]["manifest_path"], encoding="utf-8") as handle:
        return json.load(handle)


def test_prepare_results_manifests_and_crops_match(jobs):
    jax_job, port_job = jobs["jax"], jobs["port"]
    roots = (jax_job["root"], port_job["root"])
    assert _normalized(port_job["prepared"], roots) \
        == _normalized(jax_job["prepared"], roots)
    assert _normalized(_manifest(port_job), roots) \
        == _normalized(_manifest(jax_job), roots)
    for ours, theirs in zip(_manifest(port_job)["entries"],
                            _manifest(jax_job)["entries"]):
        with open(ours["crop_path"], "rb") as a, \
                open(theirs["crop_path"], "rb") as b:
            assert a.read() == b.read()
    estimate = {"video_path": port_job["scene"], "whole_scene": True,
                "anchor_interval": 8}
    assert _normalized(tff.estimate_anchors(estimate), roots) == _normalized(
        jff.estimate_anchors({**estimate,
                              "video_path": jax_job["scene"]}), roots)


def _accept_all(job, short_by):
    """Enhanced anchors and LTX frames (brightened crops, ``short_by``
    frames short) through both accept endpoints and the inputs contract."""
    module, manifest = job["module"], _manifest(job)
    path = job["prepared"]["manifest_path"]
    results = []
    for anchor in manifest["runs"][0]["anchors"]:
        src = cv2.imread(anchor["source_path"])
        fake = anchor["source_path"] + ".enh.png"
        cv2.imwrite(fake, np.clip(src.astype(np.int32) + 40, 0,
                                  255).astype(np.uint8))
        results.append(module.accept_enhanced_anchor({
            "manifest_path": path, "run_index": 0, "order": anchor["order"],
            "image": fake}))
    results.append(module.build_ltx_inputs({"manifest_path": path,
                                            "run_index": 0}))
    folder = os.path.join(job["prepared"]["job_folder"], "fake_ltx")
    os.makedirs(folder, exist_ok=True)
    images = []
    for entry in manifest["entries"][:FRAMES - short_by]:
        crop = cv2.imread(entry["crop_path"]).astype(np.int32)
        crop[..., 2] = crop[..., 2] * 3 // 4 + 60
        image = os.path.join(folder, f"ltx_{entry['index']:06d}.png")
        cv2.imwrite(image, np.clip(crop + 20, 0, 255).astype(np.uint8))
        images.append({"path": image})
    results.append(module.accept_ltx_frames({"manifest_path": path,
                                             "run_index": 0,
                                             "images": images}))
    entry = manifest["entries"][2]
    results.append(module.accept_enhanced_crop({
        "manifest_path": path, "index": 2, "image": entry["crop_path"]}))
    return results


def test_accept_finalize_and_video_match(jobs):
    jax_job, port_job = jobs["jax"], jobs["port"]
    roots = (jax_job["root"], port_job["root"])
    assert _normalized(_accept_all(port_job, 3), roots) \
        == _normalized(_accept_all(jax_job, 3), roots)
    # feather 40 is a 161-tap kernel, wider than the 19-pixel boxes
    for feather in (6, 40):
        payload = {"feather": feather, "color_match": 0.5}
        want = jff.finalize_face_fix({
            **payload, "manifest_path": jax_job["prepared"]["manifest_path"]})
        got = tff.finalize_face_fix({
            **payload, "manifest_path": port_job["prepared"]["manifest_path"]},
            device="cpu")
        assert _normalized(got, roots) == _normalized(want, roots)
        assert got["frames_repaired"] == FRAMES - 3
        for ours, theirs in zip(_manifest(port_job)["entries"][:FRAMES - 3],
                                _manifest(jax_job)["entries"][:FRAMES - 3]):
            _within_one_level(cv2.imread(ours["composited_path"]),
                              cv2.imread(theirs["composited_path"]))
        frames = _decode_all(got["output_video_path"])
        assert len(frames) == FRAMES and frames[0].shape == (H, W, 3)
        x, y, w, h = _face_box(0)
        assert frames[0][y:y + h, x:x + w, 2].mean() > 150
    assert _normalized(_manifest(port_job), roots) \
        == _normalized(_manifest(jax_job), roots)


def test_accept_ltx_refuses_a_large_delta(jobs):
    with pytest.raises(ValueError, match="temporal-length"):
        tff.accept_ltx_frames({
            "manifest_path": jobs["port"]["prepared"]["manifest_path"],
            "run_index": 0, "images": [None] * (FRAMES - 8)})


def test_manifest_path_guard_and_device_refusal(tmp_path):
    bogus = tmp_path / "manifest.json"
    bogus.write_text("{}")
    with pytest.raises(ValueError, match="not inside a Face Fix job"):
        tff.accept_enhanced_crop({"manifest_path": str(bogus), "index": 0,
                                  "image": str(bogus)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tff.finalize_face_fix({"manifest_path": str(bogus)})


# --------------------------------------------------------------------------
# the ffmpeg branches, through the fake ffmpeg
# --------------------------------------------------------------------------

@pytest.fixture()
def port_fake_ffmpeg(tmp_path, monkeypatch):
    target = tmp_path / "ffmpeg"
    shutil.copy(os.path.join(HERE, "fake_ffmpeg.py"), target)
    target.chmod(target.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(tvideo_io, "find_ffmpeg", lambda: str(target))
    monkeypatch.delenv("FAKE_FFMPEG_FAIL", raising=False)
    monkeypatch.delenv("FAKE_FFMPEG_SLEEP", raising=False)
    return str(target)


def test_crop_video_ffmpeg_branch(port_fake_ffmpeg, tmp_path, monkeypatch):
    crops = tmp_path / "crops"
    crops.mkdir()
    rng = np.random.default_rng(3)
    for i in range(5):
        cv2.imwrite(str(crops / f"frame_{i:06d}.png"),
                    rng.integers(0, 255, (64, 64, 3), np.uint8))
    out = str(tmp_path / "crops.mp4")
    tff._encode_crop_video(str(crops), out, 12.0, 5)
    meta = tvideo_io.probe_video(out)
    assert (meta["frame_count"], meta["width"], meta["height"]) == (5, 64, 64)
    monkeypatch.setenv("FAKE_FFMPEG_FAIL", "1")
    with pytest.raises(RuntimeError, match="Conversion failed"):
        tff._encode_crop_video(str(crops), str(tmp_path / "o.mp4"), 12.0, 5)


def test_finalize_ffmpeg_branch(port_fake_ffmpeg, tmp_path):
    root = str(tmp_path)
    scene = _write_scene(os.path.join(root, "scene.mp4"))
    prepared = tff.prepare_face_fix({
        "video_path": scene, "project_folder": root, "whole_scene": True,
        "rotation_assist": "off", "minimum_face_pixels": 8},
        detector=_square_detector)
    job = {"module": tff, "prepared": prepared}
    _accept_all(job, 0)
    timer = tff.StageTimer()
    final = tff.finalize_face_fix({"manifest_path": prepared["manifest_path"],
                                   "feather": 6}, device="cpu", timer=timer)
    assert set(timer.seconds()) == {"composite", "encode"}
    assert timer.counts()["composite"] == FRAMES
    meta = tvideo_io.probe_video(final["output_video_path"])
    assert (meta["frame_count"], meta["width"], meta["height"]) == (FRAMES, W,
                                                                     H)
    assert final["audio_preserved"] is False
    assert not os.path.exists(os.path.join(prepared["job_folder"],
                                           "face_fix_silent.avi"))


# --------------------------------------------------------------------------
# the face-fix command, all seven actions, beside the JAX command
# --------------------------------------------------------------------------

def _draw_face(canvas, center, axes=(110, 150)):
    """The cartoon face of tests/test_face_detector.py (BGR)."""
    cx, cy = center
    ax, ay = axes
    cv2.ellipse(canvas, (cx, cy), (ax, ay), 0, 0, 360, (140, 170, 205), -1)
    eye_y = cy - int(0.27 * ay)
    dx = int(0.41 * ax)
    for ex in (cx - dx, cx + dx):
        cv2.ellipse(canvas, (ex, eye_y), (int(0.2 * ax), int(0.09 * ay)),
                    0, 0, 360, (255, 255, 255), -1)
        cv2.circle(canvas, (ex, eye_y), max(2, int(0.07 * ax)),
                   (40, 30, 30), -1)
    cv2.ellipse(canvas, (cx, cy + int(0.1 * ay)),
                (max(2, int(0.11 * ax)), int(0.2 * ay)), 0, 0, 360,
                (120, 150, 185), -1)
    cv2.ellipse(canvas, (cx, cy + int(0.47 * ay)),
                (int(0.41 * ax), int(0.12 * ay)), 0, 0, 180,
                (60, 60, 160), 6)
    return canvas


def _face_clip(path, frames=12):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                             (640, 480))
    for i in range(frames):
        writer.write(_draw_face(np.full((480, 640, 3), 60, np.uint8),
                                (320 + 3 * i, 240)))
    writer.release()
    return path


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def _command_chain(main, root, extra, capsys):
    """estimate -> prepare -> accept-anchor (each) -> accept-crop -> inputs
    -> accept-ltx (9 of the run's frames: the 8n+1 tail rule) -> finalize
    through one package's ``face-fix`` command."""
    clip = _face_clip(os.path.join(root, "face.mp4"))
    out = [_run(main, ["face-fix", "estimate", "--video", clip,
                       "--whole-scene", *extra], capsys)]
    payload = {"video_path": clip, "project_folder": root, "confidence": 0.3,
               "repair_distance": "all", "rotation_assist": "off",
               "anchor_interval": 8}
    prepared = _run(main, ["face-fix", "prepare", "--whole-scene",
                           "--payload", json.dumps(payload), *extra], capsys)
    out.append(prepared)
    manifest = prepared["manifest_path"]
    run = prepared["runs"][0]
    for anchor in run["anchors"]:
        image = cv2.imread(anchor["source_path"])
        fake = os.path.join(root, f"enhanced_{anchor['order']}.png")
        cv2.imwrite(fake, np.clip(image.astype(np.int32) * 9 // 10 + 30, 0,
                                  255).astype(np.uint8))
        out.append(_run(main, ["face-fix", "accept-anchor", "--manifest",
                               manifest, "--payload", json.dumps(
                                   {"run_index": 0, "order": anchor["order"],
                                    "image": fake}), *extra], capsys))
    crops = [c["crop_path"] for c in prepared["crops"]]
    out.append(_run(main, ["face-fix", "accept-crop", "--manifest", manifest,
                           "--payload", json.dumps({"index": 0,
                                                    "image": crops[0]}),
                           *extra], capsys))
    out.append(_run(main, ["face-fix", "inputs", "--manifest", manifest,
                           "--payload", json.dumps({"run_index": 0}),
                           *extra], capsys))
    kept = 8 * ((run["frame_count"] - 1) // 8) + 1
    ltx = []
    for index, crop in enumerate(crops[:kept]):
        image = cv2.imread(crop).astype(np.int32)
        fake = os.path.join(root, f"ltx_{index}.png")
        cv2.imwrite(fake, np.clip(image * 9 // 10 + 30, 0, 255)
                    .astype(np.uint8))
        ltx.append(fake)
    out.append(_run(main, ["face-fix", "accept-ltx", "--manifest", manifest,
                           "--payload", json.dumps({"run_index": 0,
                                                    "images": ltx}),
                           *extra], capsys))
    out.append(_run(main, ["face-fix", "finalize", "--manifest", manifest,
                           "--payload", json.dumps({"feather": 18}),
                           *extra], capsys))
    return out


def test_face_fix_command_matches_jax(tmp_path, capsys):
    if not os.path.isfile(YUNET):
        pytest.skip("the YuNet asset is not in assets/")
    from vrgdg_tpu import cli as jcli

    roots = (str(tmp_path / "jax"), str(tmp_path / "port"))
    for root in roots:
        os.makedirs(root)
    want = _command_chain(jcli.main, roots[0], [], capsys)
    got = _command_chain(cli.main, roots[1], ["--device", "cpu"], capsys)
    assert len(got) == len(want) >= 8
    assert _normalized(got, roots) == _normalized(want, roots)
    prepared = got[1]
    assert prepared["face_run_count"] >= 1
    final_got, final_want = got[-1], want[-1]
    assert final_got["frames_repaired"] >= 8
    frames_got = _decode_all(final_got["output_video_path"])
    frames_want = _decode_all(final_want["output_video_path"])
    assert len(frames_got) == len(frames_want) == 12
    assert frames_got[0].shape == frames_want[0].shape == (480, 640, 3)
    manifests = []
    for result in (got, want):
        with open(result[1]["manifest_path"], encoding="utf-8") as handle:
            manifests.append(json.load(handle)["entries"])
    composited = [(ours["composited_path"], theirs["composited_path"])
                  for ours, theirs in zip(*manifests)
                  if ours.get("composited_path")]
    assert len(composited) == final_got["frames_repaired"]
    for ours, theirs in composited:
        _within_one_level(cv2.imread(ours), cv2.imread(theirs))


def test_face_fix_command_refuses_cuda_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as refused:
        cli.main(["face-fix", "estimate", "--video", str(tmp_path / "x.mp4")])
    assert refused.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err
