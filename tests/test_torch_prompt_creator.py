"""The prompt creator, its instruction store, the start storyboard, the
Krea2 LoRA Studio and the text tools, held equal to their originals.

``vrgdg_tpu_torch.api.{prompt_creator, pc_instructions, start_storyboard,
krea2_studio}`` and ``vrgdg_tpu_torch.runtime.text_tools`` are copies of
JAX-free modules of ``vrgdg_tpu`` (which cannot be imported without JAX).
Every copied function and class keeps its original's source and every
constant its value, except those named in ``CHANGED``.  Then both
packages run one seeded scenario each, under a root of their own with the
modules' clocks frozen at one instant: the results must be equal JSON
once the root prefix is replaced and the file-system times and the Krea2
dataset's signature (a hash over file times) are dropped, and the two
roots must hold equal file trees.  The Krea2 size check, which reads
image headers where the original opens the file with Pillow, is held to
Pillow itself (present here, absent on the card's machine).
"""

import base64
import json
import os
import types

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")

import chip_smoke as cs
from tests.test_torch_builder import (_canon, _classes, _constants,
                                      _differences, freeze_clocks)
from tests.test_torch_host_copies import _functions, _normalized
from vrgdg_tpu.api import builder as j_builder
from vrgdg_tpu.api import krea2_studio as j_k2s
from vrgdg_tpu.api import pc_instructions as j_pci
from vrgdg_tpu.api import prompt_creator as j_pcr
from vrgdg_tpu.api import start_storyboard as j_ssb
from vrgdg_tpu.api import workflow_runner as j_wr
from vrgdg_tpu.runtime import text_tools as j_tt
from vrgdg_tpu_torch.api import builder as t_builder
from vrgdg_tpu_torch.api import krea2_studio as t_k2s
from vrgdg_tpu_torch.api import pc_instructions as t_pci
from vrgdg_tpu_torch.api import prompt_creator as t_pcr
from vrgdg_tpu_torch.api import start_storyboard as t_ssb
from vrgdg_tpu_torch.api import workflow_runner as t_wr
from vrgdg_tpu_torch.runtime import image_io
from vrgdg_tpu_torch.runtime import text_tools as t_tt

PAIRS = [(j_tt, t_tt), (j_pcr, t_pcr), (j_pci, t_pci), (j_ssb, t_ssb),
         (j_k2s, t_k2s)]
PAIR_IDS = ["text_tools", "prompt_creator", "pc_instructions",
            "start_storyboard", "krea2_studio"]

# what the port changes, each for a reason its module docstring gives:
# the edit pairs' sizes read without Pillow, the AI-Toolkit template read
# from the JAX package's data folder
CHANGED = {"krea2_studio": {"sync_edit_dataset", "ai_toolkit_edit_config"}}

JAX = types.SimpleNamespace(pcr=j_pcr, pci=j_pci, ssb=j_ssb, k2s=j_k2s,
                            builder=j_builder, tt=j_tt, wr=j_wr)
PORT = types.SimpleNamespace(pcr=t_pcr, pci=t_pci, ssb=t_ssb, k2s=t_k2s,
                             builder=t_builder, tt=t_tt, wr=t_wr)

# file-system times, and the Krea2 dataset's hash over them
VOLATILE = {"updated", "modified", "mtime", "signature"}


# --------------------------------------------------------------------------
# sources and constants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_function_and_class_source(original,
                                                             copy):
    import inspect

    changed = CHANGED.get(copy.__name__.rsplit(".", 1)[1], set())
    names = _functions(original)
    assert names == _functions(copy) and names
    assert _classes(original) == _classes(copy)
    for name in names + _classes(original):
        ours = inspect.getsource(getattr(copy, name))
        theirs = _normalized(inspect.getsource(getattr(original, name)))
        assert (ours == theirs) == (name not in changed), name


@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_constant(original, copy):
    assert _constants(copy) == _constants(original)


def test_named_constants_equal():
    assert t_pci._DEFAULTS == j_pci._DEFAULTS and len(t_pci.KEYS) >= 7
    assert t_pci.LABELS == j_pci.LABELS
    assert t_pcr.LLM_SETTINGS == j_pcr.LLM_SETTINGS
    assert t_k2s.IMAGE_EXTS == j_k2s.IMAGE_EXTS
    assert t_k2s.presets() == j_k2s.presets()
    assert t_ssb.SCENE_KEEP_KEYS == j_ssb.SCENE_KEEP_KEYS


# --------------------------------------------------------------------------
# normal forms
# --------------------------------------------------------------------------

def _drop(value):
    if isinstance(value, dict):
        return {k: _drop(v) for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [_drop(v) for v in value]
    return value


def _same(ours, theirs, roots):
    return not _differences(_drop(_canon(json.loads(json.dumps(ours)),
                                         roots[1])),
                            _drop(_canon(json.loads(json.dumps(theirs)),
                                         roots[0])))


def _file_form(name, data, root):
    """A file's bytes in normal form: JSON parsed (root replaced, file
    times and the dataset signature dropped), other text with the root
    replaced, binary as hex."""
    if name.endswith(".json"):
        try:
            return _drop(_canon(json.loads(data.decode("utf-8-sig")), root))
        except ValueError:
            pass
    try:
        return _canon(data.decode("utf-8"), root)
    except UnicodeDecodeError:
        return data.hex()


def _trees(roots):
    found = []
    for root in roots:
        tree = {}
        for folder, _, names in os.walk(root):
            for name in names:
                path = os.path.join(folder, name)
                with open(path, "rb") as handle:
                    tree[os.path.relpath(path, root)] = _file_form(
                        name, handle.read(), root)
        found.append(tree)
    return found


class Recorder:
    def __init__(self):
        self.steps = []

    def __call__(self, label, fn, *args, **kwargs):
        try:
            result = fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — refusals are results too
            result = {"raised": type(exc).__name__, "error": str(exc)}
        self.steps.append((label, result))
        return result


def _data_url(seed, size=(40, 56)):
    image = np.random.default_rng(seed).integers(0, 256, (*size, 3),
                                                 np.uint8)
    ok, buf = cv2.imencode(".png", image)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    folder = tmp_path_factory.mktemp("pc_media")
    still = folder / "still.png"
    still.write_bytes(base64.b64decode(_data_url(3).split(",", 1)[1]))
    return {"folder": str(folder), "still": str(still),
            "url": _data_url(1), "url2": _data_url(2, (48, 64)),
            "audio": cs._seeded_wav(str(folder / "song.wav"), 6.0, 22050,
                                    5),
            "segments": [{"id": f"s{n}", "start": 2.0 * (n - 1),
                          "end": 2.0 * n, "label": f"Scene {n}",
                          "lyric_text": f"line {n}",
                          "t2i_prompt": f"a wide shot {n}"}
                         for n in range(1, 7)]}


def run_both(scenario, media, tmp_path, monkeypatch):
    """``scenario(m, root, media)`` on each package under its own root,
    the modules' clocks frozen: ``(roots, [jax steps, port steps])``."""
    monkeypatch.delenv("VRGDG_TPU_INPUT", raising=False)
    freeze_clocks(monkeypatch, [j_pcr, t_pcr, j_ssb, t_ssb, j_k2s, t_k2s,
                                j_tt, t_tt, j_wr, t_wr, j_builder,
                                t_builder])
    roots, runs = [], []
    for name, m in (("jax", JAX), ("port", PORT)):
        root = str(tmp_path / name)
        os.makedirs(root)
        roots.append(root)
        step = Recorder()
        scenario(m, root, media, step)
        runs.append(step.steps)
    return roots, runs


def _assert_equal_runs(roots, runs):
    (j_steps, t_steps) = runs
    assert [label for label, _ in t_steps] == [label for label, _ in j_steps]
    for (label, ours), (_, theirs) in zip(t_steps, j_steps):
        assert _same(ours, theirs, roots), label
    trees = _trees(roots)
    assert sorted(trees[1]) == sorted(trees[0])
    assert not _differences(trees[1], trees[0])
    return [label for label, result in j_steps
            if isinstance(result, dict) and "raised" in result]


# --------------------------------------------------------------------------
# the prompt creator and its instruction store
# --------------------------------------------------------------------------

def prompt_creator_scenario(m, root, media, step):
    project = os.path.join(root, "Seeded Prompts")
    with open(media["audio"], "rb") as handle:
        wav = handle.read()
    audio = step("import_audio", m.pcr.import_audio, project,
                 "My Song!.wav", wav, root)
    step("import_audio empty", m.pcr.import_audio, project, "x.wav", b"",
         root)
    segments = media["segments"]
    step("save_outputs", m.pcr.save_outputs, {
        "project_folder": project, "subject": "Ann",
        "full_lyrics": "\n".join(s["lyric_text"] for s in segments),
        "segments": {f"segment{n}": s["lyric_text"]
                     for n, s in enumerate(segments, 1)},
        "prompts": "```json\n" + json.dumps(
            {f"Prompt{n}": s["t2i_prompt"]
             for n, s in enumerate(segments, 1)}) + "\n```",
        "i2v_motion_notes": {"Motion1": "slow pan"},
        "srt_text": t_builder.segments_to_srt(segments)}, root)
    step("save_outputs labels only", m.pcr.save_outputs,
         {"project_name": "bad", "prompts": {"Prompt1": "Scene 1"}}, root)
    step("save_draft", m.pcr.save_draft, {
        "project_folder": project, "full_lyrics": "hello world",
        "corrected_segments_text": '{"segment1": "hello world"}',
        "use_srt_durations": "false", "fixed_scene_duration": 3}, root)
    step("load_draft", m.pcr.load_draft, {"project_folder": project}, root)
    step("save_draft named", m.pcr.save_draft, {
        "project_name": "Second", "srt_text":
        "1\n00:00:00,000 --> 00:00:02,000\nA\n"}, root)
    step("list_drafts", m.pcr.list_drafts, root)
    step("config", m.pcr.config, root)
    key = {"project_folder": project, "key": "story_idea"}
    step("get_instruction", m.pci.get_instruction, key, root)
    step("save_instruction", m.pci.save_instruction,
         {**key, "text": "a heist"}, root)
    step("get_instruction saved", m.pci.get_instruction, key, root)
    step("reset_instruction", m.pci.reset_instruction, key, root)
    step("save_preset", m.pci.save_preset,
         {"key": "story_idea", "name": "Heist!", "text": "a heist"}, root)
    step("list_presets", m.pci.list_presets, {"key": "story_idea"}, root)
    step("load_preset", m.pci.load_preset,
         {"key": "story_idea", "name": "Heist!"}, root)
    step("load_preset missing", m.pci.load_preset,
         {"key": "story_idea", "name": "none"}, root)
    step("get_instruction bad key", m.pci.get_instruction,
         {"project_folder": project, "key": "bogus"}, root)
    step("build_whisper_prompt", m.pcr.build_whisper_prompt, {
        "project_folder": project, "audio_path": audio["audio_path"],
        "full_lyrics": "line 1\nline 2", "min_duration": 3,
        "duration_preset": "steady"}, root)
    step("build_whisper_prompt missing audio", m.pcr.build_whisper_prompt,
         {"project_folder": project, "audio_path": "missing.wav"}, root)
    # the builder finds the run through the pointer file
    step("latest source", m.builder.latest_prompt_creator_source, root)


def test_prompt_creator_scenario_equal(media, tmp_path, monkeypatch):
    roots, runs = run_both(prompt_creator_scenario, media, tmp_path,
                           monkeypatch)
    refused = _assert_equal_runs(roots, runs)
    assert refused == ["import_audio empty", "save_outputs labels only",
                       "load_preset missing", "get_instruction bad key",
                       "build_whisper_prompt missing audio"]


# --------------------------------------------------------------------------
# the start storyboard on a builder project
# --------------------------------------------------------------------------

def start_storyboard_scenario(m, root, media, step):
    b = m.builder
    created = b.new_project({"project_name": "Board Clip"}, root)
    folder = created["project_folder"]
    saved = b.save_scene_image({"project_folder": folder, "scene_number": 1,
                                "image_data": media["url"]})
    segments = [dict(seg) for seg in media["segments"]]
    segments[0]["approved_image_path"] = saved["saved_path"]
    segments[1]["custom_image_data"] = media["url2"]
    segments.append({"id": "marker", "type": "marker"})
    b.save_session({"project_folder": folder, "session": {
        "segments": segments, "reference_builder": {
            "locations": [{"id": "loc1", "name": "Pier",
                           "description": "weathered",
                           "image": {"path": media["still"]}}],
            "scene_map": {"s3": "loc1"}}}}, root)
    s = m.ssb
    step("project_folder plain", s.project_folder, media["folder"])
    board = step("load", s.load_board, folder)
    board["scenes"][0]["note"] = "open on the pier"
    step("save", s.save_board, folder, board)
    step("import_project_start_frames", s.import_project_start_frames,
         folder)
    step("import_project_start_frames again", s.import_project_start_frames,
         folder)
    step("import_project_start_frames overwrite",
         s.import_project_start_frames, folder, True)
    step("save_scene_upload", s.save_scene_upload, folder, media["url"], 3,
         "end")
    step("save_scene_upload out of range", s.save_scene_upload, folder,
         media["url"], 99)
    step("save_reference", s.save_reference, folder, media["url2"], None)
    step("save_reference scene", s.save_reference, folder, media["url2"], 4)
    step("import_latest", s.import_latest, folder, 5,
         source_path=media["still"])
    step("import_latest empty", s.import_latest, folder, 5,
         downloads_folder=os.path.join(root, "no_downloads"))
    step("reimport", s.reimport_board, folder)
    step("load again", s.load_board, folder)
    step("image_roots", s.image_roots, folder)


def test_start_storyboard_scenario_equal(media, tmp_path, monkeypatch):
    roots, runs = run_both(start_storyboard_scenario, media, tmp_path,
                           monkeypatch)
    refused = _assert_equal_runs(roots, runs)
    assert refused == ["project_folder plain",
                       "save_scene_upload out of range",
                       "import_latest empty"]
    board = dict(runs[1])["load"]
    assert len(board["scenes"]) == 6
    assert board["scenes"][2]["location_ref"]["name"] == "Pier"
    imported = dict(runs[1])["import_project_start_frames"]
    assert imported["imported"] == 2


# --------------------------------------------------------------------------
# the Krea2 LoRA Studio
# --------------------------------------------------------------------------

def _png_bytes(seed, size):
    image = np.random.default_rng(seed).integers(0, 256, (*size, 3),
                                                 np.uint8)
    ok, buf = cv2.imencode(".png", image)
    assert ok
    return buf.tobytes()


def krea2_scenario(m, root, media, step):
    k = m.k2s
    step("defaults", k.defaults, output_root=root)
    created = step("create_project", k.create_project, {
        "project_name": "Seeded Lora!", "sample_prompt": "portrait of zz",
        "aspect_ratio": "16:9 (Widescreen)"}, root)
    project_dir = created["project"]["project_dir"]
    step("import_files", k.import_files, project_dir, [
        ("Photo One.png", _png_bytes(1, (40, 56))),
        ("photo one.txt", b"caption one"), ("other.jpg", b"P2"),
        ("stray.txt", b"no image"), ("skip.doc", b"x")])
    step("save_project standard", k.save_project,
         {"project_dir": project_dir, "caption_user_notes": "night"})
    same, wide = _png_bytes(2, (40, 56)), _png_bytes(3, (44, 56))
    step("import_edit control", k.import_edit_files, project_dir, "control",
         [("pair_a.png", same), ("pair_b.png", same),
          ("pair_c.png", b"not an image")])
    step("import_edit target", k.import_edit_files, project_dir, "target",
         [("pair_a.png", same), ("pair_a.txt", b"make it night"),
          ("pair_b.png", wide), ("pair_b.txt", b"widen"),
          ("pair_c.png", same), ("pair_c.txt", b"fix")])
    step("import_edit bad role", k.import_edit_files, project_dir, "bogus",
         [])
    step("train_plan incomplete", k.train_plan, {"project_dir": project_dir})
    step("import_edit fix", k.import_edit_files, project_dir, "control",
         [("pair_c.png", same)])
    step("import_edit fix target", k.import_edit_files, project_dir,
         "target", [("pair_b.png", same)])
    step("save_project", k.save_project, {"project_dir": project_dir})
    step("train_plan", k.train_plan, {"project_dir": project_dir})
    step("record_training_result", k.record_training_result, {
        "project_dir": project_dir, "latest_lora_path": "/l/z.safetensors",
        "completed_steps": 250, "total_target_steps": 500,
        "output_name": "zz"})
    step("build_sample_prompt", k.build_sample_prompt,
         {"project_dir": project_dir, "strength_model": 0.8,
          "sample_model_settings": {"vae": "my_vae.safetensors"}})
    renders = os.path.join(root, "renders")
    os.makedirs(renders)
    for number, size in enumerate(((40, 56), (56, 40), (30, 90))):
        with open(os.path.join(renders, f"r{number}.png"), "wb") as handle:
            handle.write(_png_bytes(10 + number, size))
        step(f"save_sample {number}", k.save_sample, {
            "project_dir": project_dir, "step": 250 * (number + 1),
            "image": {"filename": f"r{number}.png",
                      "subfolder": "renders"}}, root)
    step("save_sample missing", k.save_sample, {
        "project_dir": project_dir, "image": {"filename": "none.png"}}, root)
    step("create_xyz", k.create_xyz, {"project_dir": project_dir})
    step("training_progress", k.training_progress, project_dir)
    step("list_projects", k.list_projects, {}, root)
    step("load_project", k.load_project, {"project_dir": project_dir})
    step("load_project missing", k.load_project,
         {"project_dir": os.path.join(root, "none")})


def test_krea2_scenario_equal(media, tmp_path, monkeypatch):
    roots, runs = run_both(krea2_scenario, media, tmp_path, monkeypatch)
    refused = _assert_equal_runs(roots, runs)
    assert refused == ["import_edit bad role", "train_plan incomplete",
                       "save_sample missing", "load_project missing"]
    problems = dict(runs[1])["import_edit target"]["dataset_sync"][
        "problems"]
    control = os.path.join(roots[1], "VRGDG_Krea2_Studio", "Seeded_Lora",
                           "dataset", "control", "pair_c.png")
    assert any("control (56, 40) and target (56, 44) dimensions differ"
               in text for text in problems), problems
    assert f"pair_c: could not validate image dimensions (cannot identify " \
        f"image file {control!r})" in problems
    # the XYZ grid: cv2 on both sides, the same bytes
    grids = [dict(run)["create_xyz"]["xyz_path"] for run in runs]
    with open(grids[0], "rb") as ours, open(grids[1], "rb") as theirs:
        assert ours.read() == theirs.read()


# --------------------------------------------------------------------------
# image sizes from headers, held to Pillow's lazy open
# --------------------------------------------------------------------------

def _exif_jpeg(path, array):
    image = PIL_Image.fromarray(array)
    exif = image.getexif()
    exif[0x0112] = 6
    image.save(path, exif=exif)


def _cut_png(path, array):
    PIL_Image.fromarray(array).save(path)
    with open(path, "rb") as handle:
        data = handle.read()
    with open(path, "wb") as handle:
        handle.write(data[:len(data) // 3])


def _tiff_turned(path, array):
    PIL_Image.fromarray(array).save(path, tiffinfo={274: 8})


SIZE_CASES = {
    "jpeg exif": ("a.jpg", _exif_jpeg),
    "png cut short": ("b.png", _cut_png),
    "png": ("c.png", lambda p, a: PIL_Image.fromarray(a).save(p)),
    "progressive jpeg": ("d.jpeg", lambda p, a: PIL_Image.fromarray(a).save(
        p, progressive=True)),
    "webp lossy": ("e.webp", lambda p, a: PIL_Image.fromarray(a).save(p)),
    "webp lossless": ("f.webp", lambda p, a: PIL_Image.fromarray(a).save(
        p, lossless=True)),
    "webp exif": ("g.webp", lambda p, a: PIL_Image.fromarray(a).save(
        p, exif=b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00")),
    "bmp": ("h.bmp", lambda p, a: PIL_Image.fromarray(a).save(p)),
    "tiff": ("i.tif", lambda p, a: PIL_Image.fromarray(a).save(p)),
    "tiff orientation": ("j.tiff", _tiff_turned),
    "png holding a jpeg": ("k.png", lambda p, a: PIL_Image.fromarray(a).save(
        p, format="JPEG")),
    "png holding a gif": ("l.png", lambda p, a: PIL_Image.fromarray(a).save(
        p, format="GIF")),
    "bigtiff": ("m.tiff", lambda p, a: PIL_Image.fromarray(a).save(
        p, big_tiff=True)),
}


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_image_size_is_pillows(case, tmp_path):
    name, write = SIZE_CASES[case]
    array = np.random.default_rng(len(case)).integers(0, 256, (37, 53, 3),
                                                      np.uint8)
    path = str(tmp_path / name)
    write(path, array)
    with PIL_Image.open(path) as image:
        want = image.size
    assert image_io.image_size(path) == want


@pytest.mark.parametrize("data", [
    b"not an image", b"", b"\x89PNG\r\n\x1a\n",
    b"\xff\xd8\xff\xe0\x00\x10JFIF",
    b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR\x00\x00"],
    ids=["text", "empty", "png signature only", "jpeg header cut",
         "png header cut"])
def test_image_size_refuses_with_pillows_message(data, tmp_path):
    path = str(tmp_path / "it's.png")
    with open(path, "wb") as handle:
        handle.write(data)
    with pytest.raises(Exception) as pillow:
        PIL_Image.open(path)
    with pytest.raises(OSError) as ours:
        image_io.image_size(path)
    # the text the studio writes into its problems
    assert str(ours.value) == str(pillow.value)


def test_edit_sync_problems_equal_pillows(tmp_path):
    """The edit dataset's problems, Pillow's (JAX) against the headers'
    (port): an EXIF-turned JPEG pair, a pair of two sizes, a file with an
    image extension that holds no image."""
    rng = np.random.default_rng(17)
    outs = []
    for name, k in (("jax", j_k2s), ("port", t_k2s)):
        project_dir = str(tmp_path / name)
        paths = k.project_paths(project_dir)
        for folder in (paths["control_dir"], paths["target_dir"]):
            os.makedirs(folder)
        pixels = np.random.default_rng(17).integers(0, 256, (30, 40, 3),
                                                    np.uint8)
        _exif_jpeg(os.path.join(paths["control_dir"], "turned.jpg"), pixels)
        PIL_Image.fromarray(pixels).save(
            os.path.join(paths["target_dir"], "turned.jpg"))
        PIL_Image.fromarray(pixels).save(
            os.path.join(paths["control_dir"], "sizes.png"))
        PIL_Image.fromarray(pixels[:, :33]).save(
            os.path.join(paths["target_dir"], "sizes.png"))
        with open(os.path.join(paths["control_dir"], "junk.webp"),
                  "wb") as handle:
            handle.write(rng.bytes(0) + b"RIFF\x00\x00\x00\x00WEBPjunk")
        PIL_Image.fromarray(pixels).save(
            os.path.join(paths["target_dir"], "junk.webp"))
        for stem in ("turned", "sizes", "junk"):
            with open(os.path.join(paths["target_dir"], stem + ".txt"),
                      "w") as handle:
                handle.write("caption " + stem)
        project, _ = k.sync_edit_dataset({"project_dir": project_dir})
        outs.append((project_dir, project["dataset_sync"]["problems"]))
    (j_dir, j_problems), (t_dir, t_problems) = outs
    assert [p.replace(t_dir, "<p>") for p in t_problems] == \
        [p.replace(j_dir, "<p>") for p in j_problems]
    assert len(t_problems) == 2


# --------------------------------------------------------------------------
# the text tools
# --------------------------------------------------------------------------

_TEXTS = [
    "```json\n{\"Prompt1\": \"a red door\", \"Prompt2\": \"a blue door\"}\n```",
    "<think>plan</think>assistant: 1. a cat | 2. a dog | 3. a bird",
    "\"one\" \"two\" \"three\" \"four\"",
    "Group 1: sunrise over hills\nGroup 2: a city at night\n#3) rain",
    '{"groups": [{"index": 1, "text": "a"}, {"index": 2, "text": "b"}]}',
    "the the the the the the the the the the the the",
    "scene 1: a boat\nscene 2: a pier\n\nscene 3: the sea",
    '[{"scene": 2, "image_prompt": "a lamp"}, {"scene": 1, "t2i_prompt": '
    '"a chair"}]',
]


@pytest.mark.parametrize("text", _TEXTS, ids=[f"text{n}" for n in
                                               range(len(_TEXTS))])
def test_text_tools_equal_on_llm_text(text):
    calls = (
        ("chunk_pipe_prompts", (text, 3)),
        ("chunk_quoted_prompts", (text, 3)),
        ("parse_redo_indexes", (text,)),
        ("parse_override_blocks", (text,)),
        ("extract_prompt_text", (text, 2)),
        ("looks_like_llm_repeat_failure", (text,)),
        ("clean_llm_chat_text", (text,)),
        ("parse_prompt_groups", (text,)),
        ("strip_llm_fence", (text,)),
        ("first_clean_llm_line", (text,)),
        ("parse_concept_prompt_items", (text,)),
        ("group_index_of", (text, True)))
    for name, args in calls:
        ours = _result(getattr(t_tt, name), *args)
        assert ours == _result(getattr(j_tt, name), *args), name


def _result(fn, *args):
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001
        return ("raised", type(exc).__name__, str(exc))


def text_tools_scenario(m, root, media, step):
    tt = m.tt
    state = os.path.join(root, "state", "index.txt")
    for reset in (False, False, True, False):
        step("step_run_index", tt.step_run_index, state, reset)
    step("read_run_index", tt.read_run_index, state)
    step("log_run_state", tt.log_run_state, os.path.join(root, "logs"), 3,
         8)
    out = os.path.join(root, "out")
    os.makedirs(out)
    for number in (1, 2, 5):
        with open(os.path.join(out, f"scene_{number:03d}.png"), "wb") as fh:
            fh.write(b"x")
    step("next_output_index", tt.next_output_index, out)
    step("backup_numbered_files", tt.backup_numbered_files, out, 2)
    step("next_batch_file_index", tt.next_batch_file_index, out, "scene_")
    step("select_prompt", tt.select_prompt, _TEXTS[0].strip("`json\n"), 1)
    step("build_batch_prompt", tt.build_batch_prompt, [1, 2],
         {1: "alpha", 2: "beta", 3: "gamma"}, "global")


def test_text_tools_state_scenario_equal(media, tmp_path, monkeypatch):
    roots, runs = run_both(text_tools_scenario, media, tmp_path,
                           monkeypatch)
    _assert_equal_runs(roots, runs)
