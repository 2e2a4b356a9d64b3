"""The workflow runner, the scene-render routes and MiniMax H3's support
math, held equal to their originals.

``vrgdg_tpu_torch.runtime.minimax_h3``, ``vrgdg_tpu_torch.api.scene_render``
and ``vrgdg_tpu_torch.api.workflow_runner`` are copies of JAX-free modules
of ``vrgdg_tpu`` (which cannot be imported without JAX).  Every copied
function and class keeps its original's source and every constant its
value, except the ones named in ``CHANGED``.  Then both packages run the
same seeded inputs: each of the 16 prompt builders and ``clear_memory``
on one fake model root (random seeded alike on each side), the seven
scene-render routes and the scene-audio trim through a recording runner
on each package's ffmpeg seam (equal command plans, results and
colour-match cubes), and the ``workflow`` command printing what
``vrgdg_tpu.cli`` prints.  Where Pillow is replaced, the replacement is
held to Pillow itself (present here, absent on the card's machine):
``ImageStat``'s mean and stddev to the bit, and the reference images'
arrays.
"""

import inspect
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")

import chip_smoke as cs
from tests.test_torch_builder import (_canon, _classes, _constants,
                                      _differences, _tree, freeze_clocks,
                                      FROZEN)
from tests.test_torch_host_copies import _functions, _normalized
from vrgdg_tpu import cli as j_cli
from vrgdg_tpu.api import scene_render as j_sr
from vrgdg_tpu.api import workflow_runner as j_wr
from vrgdg_tpu.runtime import minimax_h3 as j_h3
from vrgdg_tpu.runtime import video_io as j_vio
from vrgdg_tpu_torch import cli as t_cli
from vrgdg_tpu_torch.api import scene_render as t_sr
from vrgdg_tpu_torch.api import workflow_runner as t_wr
from vrgdg_tpu_torch.runtime import image_io
from vrgdg_tpu_torch.runtime import minimax_h3 as t_h3
from vrgdg_tpu_torch.runtime import video_io as t_vio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = [(j_h3, t_h3), (j_sr, t_sr), (j_wr, t_wr)]
PAIR_IDS = ["minimax_h3", "scene_render", "workflow_runner"]

# what the port changes, each for a reason its module docstring gives:
# Pillow replaced (the card's machine has none); ``_TEMPLATE_DIR`` is
# written otherwise but names the same folder (the JAX package's data)
CHANGED = {"minimax_h3": {"load_reference_images"},
           "scene_render": {"match_scene_start_color"},
           "workflow_runner": set()}

BUILDER_KEYS = sorted(t_wr.BUILDERS) + ["clear_memory"]


# --------------------------------------------------------------------------
# sources and constants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_function_and_class_source(original,
                                                             copy):
    changed = CHANGED[copy.__name__.rsplit(".", 1)[1]]
    names = _functions(original)
    assert names == _functions(copy) and names
    assert _classes(original) == _classes(copy)
    for name in names + _classes(original):
        ours = inspect.getsource(getattr(copy, name))
        theirs = _normalized(inspect.getsource(getattr(original, name)))
        assert (ours == theirs) == (name not in changed), name


def _by_name(value):
    """A constant with each function in it as its name (``BUILDERS``)."""
    if isinstance(value, dict):
        return {k: _by_name(v) for k, v in value.items()}
    return getattr(value, "__name__", value) if callable(value) else value


@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_constant(original, copy):
    changed = CHANGED[copy.__name__.rsplit(".", 1)[1]]
    ours, theirs = (_by_name(_constants(module))
                    for module in (copy, original))
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert (ours[name] == theirs[name]) == (name not in changed), name


def test_templates_are_read_from_the_jax_package_data():
    assert t_wr._TEMPLATE_DIR == j_wr._TEMPLATE_DIR
    assert t_wr.TEMPLATES == j_wr.TEMPLATES
    for key in t_wr.TEMPLATES:
        assert os.path.isfile(t_wr.template_path(key)), key
        assert t_wr.load_api_template(key) == j_wr.load_api_template(key)


def test_the_new_modules_import_neither_jax_pillow_nor_the_jax_package():
    code = ("import sys\n"
            "import vrgdg_tpu_torch.api.workflow_runner, "
            "vrgdg_tpu_torch.api.scene_render, "
            "vrgdg_tpu_torch.runtime.minimax_h3, "
            "vrgdg_tpu_torch.api.prompt_creator, "
            "vrgdg_tpu_torch.api.pc_instructions, "
            "vrgdg_tpu_torch.api.start_storyboard, "
            "vrgdg_tpu_torch.api.krea2_studio, "
            "vrgdg_tpu_torch.runtime.text_tools, "
            "vrgdg_tpu_torch.server.routes, vrgdg_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vrgdg_tpu', 'PIL')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and "clean" in done.stdout, done.stderr


# --------------------------------------------------------------------------
# the runtime package's exports
# --------------------------------------------------------------------------

# the JAX runtime modules whose names the port does not export: none
NOT_YET = ()


def test_runtime_exports_the_jax_names_of_its_modules():
    import vrgdg_tpu.runtime as j_runtime
    import vrgdg_tpu_torch.runtime as t_runtime

    later = {name for name in j_runtime.__all__
             if getattr(getattr(j_runtime, name), "__module__", "")
             in NOT_YET}
    assert len(j_runtime.__all__) == 53 and len(later) == 0
    assert sorted(t_runtime.__all__) == sorted(set(j_runtime.__all__)
                                               - later)
    assert len(t_runtime.__all__) == 53
    for name in t_runtime.__all__:
        value = getattr(t_runtime, name)
        home = getattr(value, "__module__", None)
        # the functions and classes are the port's own; the constants
        # equal the JAX package's
        if home is not None and not isinstance(value, (tuple, set)):
            assert home.startswith("vrgdg_tpu_torch.runtime."), name
        else:
            assert value == getattr(j_runtime, name), name


def test_importing_the_runtime_package_loads_no_cv2():
    code = ("import sys\n"
            "import vrgdg_tpu_torch.runtime as r\n"
            "from vrgdg_tpu_torch.runtime import VideoReader, "
            "select_prompt, list_images\n"
            "assert 'cv2' not in sys.modules\n"
            "print(len(r.__all__))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and done.stdout.strip() == "53", done.stderr


# --------------------------------------------------------------------------
# shared media
# --------------------------------------------------------------------------

def _png(path, seed, size=(48, 64)):
    image = np.random.default_rng(seed).integers(0, 256, (*size, 3),
                                                 np.uint8)
    assert cv2.imwrite(str(path), image)
    return str(path)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    folder = tmp_path_factory.mktemp("workflow_media")
    frames = folder / "frames"
    frames.mkdir()
    (folder / "h3_project").mkdir()
    images = [_png(frames / f"frame_{n:03d}.png", 30 + n) for n in range(3)]
    segments = [{"id": f"s{n}", "start": 2.5 * (n - 1), "end": 2.5 * n,
                 "label": f"Scene {n}", "lyric_text": f"line {n}"}
                for n in range(1, 7)]
    from vrgdg_tpu_torch.api import builder as t_builder

    srt = folder / "scenes.srt"
    srt.write_text(t_builder.segments_to_srt(segments), encoding="utf-8")
    models = cs.workflow_model_root(str(folder / "models"), 41)
    return {
        "folder": str(folder), "frames": str(frames),
        "h3_project": str(folder / "h3_project"),
        "image": images[0], "image2": images[1],
        "audio": cs._seeded_wav(str(folder / "mix.wav"), 15.0, 22050, 42),
        "srt": str(srt), "models": models,
        "loras": sorted(name for _, _, names in os.walk(
            os.path.join(models, "loras")) for name in names)}


def _fill(value, root):
    return json.loads(json.dumps(value).replace("{root}", root))


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 — refusals are results too
        return {"raised": type(exc).__name__, "error": str(exc)}


# --------------------------------------------------------------------------
# the 16 builders and clear_memory
# --------------------------------------------------------------------------

@pytest.fixture()
def sides(tmp_path, monkeypatch):
    """Each package under a root of its own, its clock frozen, no ingest
    folder from the environment."""
    monkeypatch.delenv("VRGDG_TPU_INPUT", raising=False)
    monkeypatch.delenv("VRGDG_TPU_MODELS", raising=False)
    freeze_clocks(monkeypatch, [j_wr, t_wr])
    roots = {}
    for name, module in (("jax", j_wr), ("port", t_wr)):
        roots[name] = str(tmp_path / name)
        os.makedirs(roots[name])
        monkeypatch.setattr(module, "DEFAULT_OUTPUT_ROOT", roots[name])
    return roots


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("key", BUILDER_KEYS)
def test_builder_prompts_equal(key, seed, sides, media):
    outs, trees = {}, {}
    for name, module in (("jax", j_wr), ("port", t_wr)):
        root = sides[name]
        catalog = module.ModelCatalog(root=media["models"])
        random.seed(seed)
        if key == "clear_memory":
            result = _outcome(module.build_clear_memory_prompt)
        else:
            payload = _fill(cs.workflow_payloads(
                np.random.default_rng(seed), media)[key], root)
            result = _outcome(module.BUILDERS[key], payload,
                              catalog=catalog, base=root)
        outs[name] = _canon(json.loads(json.dumps(result)), root)
        trees[name] = _tree(root)
    assert "raised" not in outs["jax"], outs["jax"]
    assert not _differences(outs["port"], outs["jax"])
    assert trees["port"] == trees["jax"]


@pytest.mark.parametrize("seed", [5, 6])
def test_a_seed_of_minus_one_draws_the_same_seed(seed, sides, media):
    drawn = []
    for name, module in (("jax", j_wr), ("port", t_wr)):
        payload = {**_fill(cs.workflow_payloads(
            np.random.default_rng(3), media)["minimax_h3"], sides[name]),
            "seed": -1}
        random.seed(seed)
        drawn.append(module.build_minimax_h3_prompt(
            payload, catalog=module.ModelCatalog(root=media["models"]),
            base=sides[name])["used_seed"])
    assert drawn[0] == drawn[1] and 0 <= drawn[1] <= 2 ** 64 - 1


def test_choices_and_model_root_equal(sides, media):
    for module in (j_wr, t_wr):
        catalog = module.ModelCatalog(root=media["models"])
        assert module.lora_list(catalog)["loras"][0] == "[none]"
    assert t_wr.lora_list(t_wr.ModelCatalog(root=media["models"])) == \
        j_wr.lora_list(j_wr.ModelCatalog(root=media["models"]))
    assert t_wr.i2v_choices(t_wr.ModelCatalog(root=media["models"])) == \
        j_wr.i2v_choices(j_wr.ModelCatalog(root=media["models"]))
    for name, module in (("jax", j_wr), ("port", t_wr)):
        assert module.load_model_root(sides[name])["source"] == "unset"
        assert module.save_model_root(media["models"], sides[name]) == \
            {"models_root": media["models"], "source": "config"}
        # the default catalog reads the root saved under the output root
        module.set_default_catalog(None)
        try:
            assert module.default_catalog().root == media["models"]
        finally:
            module.set_default_catalog(None)


# --------------------------------------------------------------------------
# the scene-render routes through a recording runner on each seam
# --------------------------------------------------------------------------

SCENE_FILES = ("rendered_scene_videos/video_0001-audio.mp4",
               "rendered_scene_videos/video_0002-audio.mp4",
               "image_to_video_clips_a/video_0003_take-audio.mp4",
               "image_to_video_clips_a/video_0004-audio.mp4",
               "clips/take.mp4", "clips/long_take.mp4", "insert.mp4")


def run_scene_routes(sr, wr, root, media):
    """The seven scene-render routes and the scene-audio trim, as the
    server calls them, under ``root``: ``[(label, result)]``."""
    scenes = os.path.join(root, "scenes")
    for relative in SCENE_FILES:
        path = os.path.join(scenes, relative)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as handle:
            handle.write(b"clip:" + relative.encode())
    os.makedirs(os.path.join(scenes, "text_to_video_clips_old"))
    os.makedirs(os.path.join(root, "renders"))
    shutil.copyfile(media["image"],
                    os.path.join(root, "renders", "gen_0001.png"))
    videos = os.path.join(scenes, "rendered_scene_videos")
    steps = []

    def step(label, fn, payload):
        sr.time.reset()
        steps.append((label, _outcome(fn, payload)))

    step("collect backup", sr.collect_scene_video,
         {"project_folder": scenes, "scene_number": 3,
          "existing_action": "backup", "source_path": os.path.join(
              scenes, "image_to_video_clips_a/video_0003_take-audio.mp4")})
    step("collect", sr.collect_scene_video,
         {"project_folder": scenes, "scene_number": 1,
          "existing_action": "backup",
          "source_path": os.path.join(scenes, "clips/take.mp4")})
    step("trim", sr.trim_scene_video,
         {"project_folder": scenes, "scene_number": 2,
          "source_path": os.path.join(scenes, "clips/long_take.mp4"),
          "start": 1.25, "duration": 3.5, "label": "Best Take!",
          "mark_as_audio_video": True})
    step("find", sr.find_scene_video_output,
         {"project_folder": scenes, "scene_number": 4})
    step("colour match", sr.match_scene_start_color,
         {"project_folder": scenes, "fade_seconds": 1.5, "strength": 0.7,
          "video_path": os.path.join(videos, "video_0002-audio.mp4"),
          "reference_video_path": os.path.join(videos,
                                               "video_0001-audio.mp4")})
    step("stitch", sr.stitch_scene_videos,
         {"project_folder": scenes,
          "scene_paths": [os.path.join(videos, f"video_{n:04d}-audio.mp4")
                          for n in (1, 2, 3)],
          "scene_audio_items": [{"path": media["audio"], "start": 3.0 * n,
                                 "duration": 3.0} for n in range(3)],
          "overlay_items": [{"path": os.path.join(scenes, "insert.mp4"),
                             "start": 1.0, "end": 2.5,
                             "source_start": 0.25}],
          "scene_timing_items": [{"start": 0.0, "end": 3.0},
                                 {"start": 3.0, "end": 6.0},
                                 {"start": 6.0, "end": 9.0}],
          "timeline_fps": 24, "width": 1280, "height": 720,
          "output_prefix": "FINAL_VIDEO"})
    step("slideshow", sr.render_image_slideshow,
         {"project_folder": scenes, "audio_path": media["audio"],
          "audio_start": 2.0, "width": 640, "height": 360, "fps": 12,
          "image_items": [{"path": media["image"], "duration": 1.5},
                          {"path": media["image2"], "duration": 3.0}]})
    step("save image", lambda p: sr.save_generated_image(p, base=root),
         {"image": {"filename": "gen_0001.png", "subfolder": "renders",
                    "type": "output"}, "save_folder": "Approved"})
    step("save image outside", lambda p: sr.save_generated_image(
        p, base=root), {"image": {"filename": "gen_0001.png",
                                  "subfolder": "../..", "type": "output"}})
    step("scene audio", lambda p: wr.prepare_scene_audio_clip(p, base=root),
         {"audio_path": media["audio"], "project_folder": scenes,
          "scene_number": 5, "start_seconds": 2.5, "duration_seconds": 4.0})
    return steps


@pytest.fixture(scope="module")
def scene_runs(media, tmp_path_factory):
    """Both packages through the scene routes, each with its own
    recording runner (small frames) and its own clock."""
    base = tmp_path_factory.mktemp("scene_routes")
    patch = pytest.MonkeyPatch()
    outs = {}
    try:
        for name, sr, wr, vio in (("jax", j_sr, j_wr, j_vio),
                                  ("port", t_sr, t_wr, t_vio)):
            root = str(base / name)
            runner = cs.RecordingRunner(frame=(36, 64))
            patch.setattr(sr, "time", cs._SceneClock(FROZEN))
            patch.setattr(vio, "find_ffmpeg", lambda: "ffmpeg")
            sr.set_ffmpeg_runner(runner)
            try:
                steps = run_scene_routes(sr, wr, root, media)
            finally:
                sr.set_ffmpeg_runner(None)
            outs[name] = (root, steps, runner, _tree(root))
    finally:
        patch.undo()
    return outs


def test_scene_route_results_equal(scene_runs):
    (j_root, j_steps, *_), (t_root, t_steps, *_) = \
        scene_runs["jax"], scene_runs["port"]
    assert [label for label, _ in t_steps] == [label for label, _ in j_steps]
    for (label, ours), (_, theirs) in zip(t_steps, j_steps):
        assert not _differences(_canon(ours, t_root),
                                _canon(theirs, j_root)), label
    refused = [label for label, result in j_steps if "raised" in result]
    assert refused == ["save image outside"]


def test_scene_route_command_plans_and_trees_equal(scene_runs):
    (j_root, _, j_runner, j_tree), (t_root, _, t_runner, t_tree) = \
        scene_runs["jax"], scene_runs["port"]
    plan = cs.command_plan(t_runner.commands, t_root)
    assert plan == cs.command_plan(j_runner.commands, j_root)
    assert len(plan) > 20
    assert sorted(t_tree) == sorted(j_tree)
    assert not _differences(t_tree, j_tree)


def test_colour_match_cube_bytes_equal(scene_runs):
    cubes = [scene_runs[name][2].cubes for name in ("jax", "port")]
    assert cubes[0] == cubes[1] and len(cubes[1]) == 1
    assert cubes[1][0].startswith(b'TITLE "VRGDG opening color match"')


@pytest.mark.parametrize("sr,vio", [(j_sr, j_vio), (t_sr, t_vio)],
                         ids=["jax", "port"])
def test_render_routes_without_ffmpeg_fail_alike(sr, vio, monkeypatch,
                                                 tmp_path):
    monkeypatch.setattr(vio, "find_ffmpeg", lambda: None)
    source = tmp_path / "take.mp4"
    source.write_bytes(b"clip")
    with pytest.raises(RuntimeError) as raised:
        sr.trim_scene_video({"project_folder": str(tmp_path / "p"),
                             "source_path": str(source)})
    assert str(raised.value) == ("FFmpeg was not found: install ffmpeg to "
                                 "use the scene-video render routes.")


# --------------------------------------------------------------------------
# Pillow's ImageStat, held to Pillow
# --------------------------------------------------------------------------

def _write_stats_image(path, mode, seed):
    rng = np.random.default_rng(seed)
    height, width = 1080, 1920
    level = rng.uniform(30, 220, 4)
    if mode == "RGB16":
        data = np.clip(rng.normal(level[:3] * 257, 9000,
                                  (height, width, 3)), 0, 65535)
        assert cv2.imwrite(path, data.astype(np.uint16))
        return path
    bands = {"RGB": 3, "RGBA": 4, "L": 1, "I;16": 1}[mode]
    scale = 257 if mode == "I;16" else 1
    data = np.clip(rng.normal(level[:bands] * scale, 40 * scale,
                              (height, width, bands)), 0, 255 * scale)
    if mode == "I;16":
        # values above 255 too: Pillow's convert("RGB") clips them
        image = PIL_Image.fromarray(data[..., 0].astype(np.uint16))
        assert image.mode == "I;16"
    else:
        array = data.astype(np.uint8)
        image = PIL_Image.fromarray(array[..., 0] if bands == 1 else array,
                                    mode)
    image.save(path)
    return path


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "I;16", "RGB16"])
def test_channel_stats_are_pillows_imagestat(mode, tmp_path):
    from PIL import Image, ImageStat

    paths = [_write_stats_image(str(tmp_path / f"{side}.png"), mode, seed)
             for side, seed in (("reference", 7), ("target", 8))]
    stats = []
    for path in paths:
        with Image.open(path) as image:
            pillow = ImageStat.Stat(image.convert("RGB"))
        ours = image_io.channel_stats(path)
        assert ours.mean == pillow.mean and ours.stddev == pillow.stddev
        stats.append((pillow, ours))
    # the cube baked from each side's statistics: the same bytes
    cubes = []
    for index, (sr, pick) in enumerate(((j_sr, 0), (t_sr, 1))):
        scales, offsets = sr.color_match_correction(stats[0][pick],
                                                    stats[1][pick])
        cube = str(tmp_path / f"match_{index}.cube")
        sr.write_color_match_cube(cube, scales, offsets)
        with open(cube, "rb") as handle:
            cubes.append(handle.read())
    assert cubes[0] == cubes[1]


def test_stats_sums_pass_2_to_the_53():
    # at 1080p a channel's sum squared is past float64's exact integers:
    # only Pillow's order of operations gives its bits
    assert (1920 * 1080 * 128) ** 2 > 2 ** 53


# --------------------------------------------------------------------------
# MiniMax H3's reference images, held to the JAX function (Pillow)
# --------------------------------------------------------------------------

def test_reference_images_equal_the_jax_arrays(tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    for index, orientation in enumerate((None, 6, 3, 8)):
        array = rng.integers(0, 256, (30 + index, 52, 3), np.uint8)
        image = PIL_Image.fromarray(array)
        path = str(tmp_path / f"ref_{index}.jpg")
        if orientation is None:
            path = path[:-4] + ".png"
            image.save(path)
        else:
            exif = image.getexif()
            exif[0x0112] = orientation
            image.save(path, exif=exif, quality=90)
        paths.append(path)
    raw = json.dumps([os.path.basename(p) for p in paths])
    theirs = j_h3.load_reference_images(raw, roots=(str(tmp_path),))
    ours = t_h3.load_reference_images(raw, roots=(str(tmp_path),))
    assert len(ours) == len(theirs) == 4
    for mine, want in zip(ours, theirs):
        assert mine.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(mine, want)
    # the EXIF turn is applied: 6 and 8 swap the sides
    assert ours[1].shape[:2] == (52, 31) and ours[2].shape[:2] == (32, 52)
    with pytest.raises(ValueError, match="at most 9"):
        t_h3.load_reference_images(json.dumps(["x.png"] * 10))


@pytest.mark.parametrize("args", [
    (0.0, 4.0, 0, 0), (1.5, 6.25, 12, 8), (10.0, 10.5, 30, 30),
    (3.0, 71 / 24 + 3.0, 0, 0)], ids=["plain", "handles", "short",
                                      "decimal"])
def test_minimax_timing_equal(args):
    assert t_h3.calculate_minimax_h3_timing(*args) == \
        j_h3.calculate_minimax_h3_timing(*args)


# --------------------------------------------------------------------------
# the workflow command
# --------------------------------------------------------------------------

def _printed(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("action", [
    "list", "lora-list", "choices", "build zimage", "build i2v",
    "build clear_memory", "build flf @file", "build krea2 -o"])
def test_workflow_command_prints_what_the_jax_cli_prints(
        action, sides, media, capsys, tmp_path):
    outs = {}
    for name, main in (("jax", j_cli.main), ("port", t_cli.main)):
        root = sides[name]
        argv = ["workflow", *action.split()[:2], "--models-root",
                media["models"]]
        if action.startswith("build") and "clear_memory" not in action:
            payload = _fill(cs.workflow_payloads(
                np.random.default_rng(21), media)[action.split()[1]], root)
            text = json.dumps(payload)
            if action.endswith("@file"):
                path = os.path.join(root, "payload.json")
                with open(path, "w", encoding="utf-8") as handle:
                    handle.write(text)
                text = "@" + path
            argv += ["--payload", text]
        if action.endswith("-o"):
            argv += ["-o", os.path.join(root, "out.json")]
        random.seed(4)
        printed = _printed(main, argv, capsys)
        outs[name] = (root, printed, _tree(root))
    (j_root, j_out, j_tree), (t_root, t_out, t_tree) = \
        outs["jax"], outs["port"]
    assert t_out.replace(t_root, "<root>") == j_out.replace(j_root, "<root>")
    assert t_tree == j_tree


def test_workflow_command_refuses_an_unknown_builder(capsys):
    with pytest.raises(SystemExit) as refused:
        t_cli.main(["workflow", "build", "nope"])
    assert refused.value.code == 2
    assert "unknown builder 'nope'" in capsys.readouterr().err
