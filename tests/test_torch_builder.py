"""The music video builder project store and the host-only stores around
it, held equal to their originals.

``vrgdg_tpu_torch.api.{instructions, builder, text_files, storyboard,
video_editor, lora_dataset}`` are copies of JAX-free modules of
``vrgdg_tpu.api`` (which cannot be imported without JAX).  Every copied
function and class keeps its original's source and every constant its
value.  Then both packages run one seeded scenario, each under a root of
its own with the modules' clocks frozen at one instant: the results must
be equal JSON once the root prefix is replaced and the file-system times
(``updated``, ``modified``, ``mtime``) are dropped, the two roots must
hold equal file trees (relative names and bytes; text with the root
replaced), exported ZIPs equal members, and the ``builder`` and ``humo``
commands must print the same JSON as ``vrgdg_tpu.cli``'s.
"""

import base64
import datetime as _dt
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types
import wave
import zipfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tests.test_builder_store import make_clip
from tests.test_torch_host_copies import _functions, _normalized
from vrgdg_tpu import cli as j_cli
from vrgdg_tpu.api import builder as j_builder
from vrgdg_tpu.api import instructions as j_instructions
from vrgdg_tpu.api import lora_dataset as j_lora
from vrgdg_tpu.api import storyboard as j_storyboard
from vrgdg_tpu.api import text_files as j_text
from vrgdg_tpu.api import video_editor as j_editor
from vrgdg_tpu.runtime import audio_toolkit as j_at
from vrgdg_tpu_torch import cli as t_cli
from vrgdg_tpu_torch.api import builder as t_builder
from vrgdg_tpu_torch.api import instructions as t_instructions
from vrgdg_tpu_torch.api import lora_dataset as t_lora
from vrgdg_tpu_torch.api import storyboard as t_storyboard
from vrgdg_tpu_torch.api import text_files as t_text
from vrgdg_tpu_torch.api import video_editor as t_editor
from vrgdg_tpu_torch.runtime import audio_toolkit as t_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = [(j_instructions, t_instructions), (j_builder, t_builder),
         (j_text, t_text), (j_storyboard, t_storyboard),
         (j_editor, t_editor), (j_lora, t_lora)]
PAIR_IDS = ["instructions", "builder", "text_files", "storyboard",
            "video_editor", "lora_dataset"]

JAX = types.SimpleNamespace(builder=j_builder, instructions=j_instructions,
                            text=j_text, storyboard=j_storyboard,
                            editor=j_editor, lora=j_lora, at=j_at)
PORT = types.SimpleNamespace(builder=t_builder, instructions=t_instructions,
                             text=t_text, storyboard=t_storyboard,
                             editor=t_editor, lora=t_lora, at=t_at)

# file-system times in results (the modules' own clocks are frozen)
TIMES = {"updated", "modified", "mtime"}
# epoch seconds inside strings (the editor's media URLs carry the mtime)
_EPOCH = re.compile(r"\d{10}")

FROZEN = 1767225600.25   # 2026-01-01T00:00:00.25Z


# --------------------------------------------------------------------------
# sources and constants
# --------------------------------------------------------------------------

def _classes(module):
    return sorted(name for name, value in vars(module).items()
                  if inspect.isclass(value)
                  and value.__module__ == module.__name__)


@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_function_source(original, copy):
    names = _functions(original)
    assert names == _functions(copy) and names
    for name in names:
        assert inspect.getsource(getattr(copy, name)) == _normalized(
            inspect.getsource(getattr(original, name))), name
    assert _classes(original) == _classes(copy)
    for name in _classes(original):
        assert inspect.getsource(getattr(copy, name)) == _normalized(
            inspect.getsource(getattr(original, name))), name


def _constants(module):
    """The module's own data: everything but modules, functions, classes
    and objects without a value (locks, and registries of locks that the
    module fills as it runs, such as ``builder._PROJECT_LOCKS``, whose
    keys are whatever projects earlier tests in the process touched)."""
    found = {}
    for name, value in vars(module).items():
        if name.startswith("__") or inspect.ismodule(value) \
                or inspect.isroutine(value) or inspect.isclass(value):
            continue
        if isinstance(value, dict) and name.endswith("_LOCKS"):
            found[name] = type(value).__name__
        elif isinstance(value, re.Pattern):
            found[name] = (value.pattern, value.flags)
        elif isinstance(value, (str, int, float, tuple, list, dict, set,
                                frozenset)):
            found[name] = value
        else:
            found[name] = type(value).__name__
    return found


@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_constant(original, copy):
    assert _constants(copy) == _constants(original)


def test_named_constants_equal():
    assert t_instructions.REGISTRY == j_instructions.REGISTRY
    assert len(t_instructions.REGISTRY) > 10
    assert t_instructions.PRESET_GROUPS == j_instructions.PRESET_GROUPS
    for name in ("IMAGE_EXTENSIONS", "AUDIO_EXTENSIONS", "VIDEO_EXTENSIONS",
                 "SESSION_FILENAME", "SRT_FILENAME", "SCENE_NOTES_FILENAME",
                 "PACKAGE_MANIFEST", "PORTABLE_EXTENSIONS"):
        assert getattr(t_builder, name) == getattr(j_builder, name), name
    assert t_editor.VIDEO_EXTENSIONS == j_editor.VIDEO_EXTENSIONS
    assert t_text.AUDIO_EXTENSIONS == j_text.AUDIO_EXTENSIONS
    assert t_text.POPUP_TEXT_TARGETS == j_text.POPUP_TEXT_TARGETS
    assert t_storyboard.STORYBOARD_FILENAME == j_storyboard.STORYBOARD_FILENAME


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import vrgdg_tpu_torch.api, vrgdg_tpu_torch.api.instructions, "
            "vrgdg_tpu_torch.server.routes, vrgdg_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'vrgdg_tpu' or "
            "m.startswith('vrgdg_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and "clean" in done.stdout, done.stderr


# --------------------------------------------------------------------------
# seeded media, frozen clocks, normal forms
# --------------------------------------------------------------------------

def _write_wav(path, seconds, seed, rate=44100, channels=2):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = 0.3 * np.sin(2 * np.pi * (220 + 40 * seed) * t)
    data = tone[:, None] + rng.normal(0, 0.05, (t.size, channels))
    samples = np.clip(data * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(channels)
        handle.setsampwidth(2)
        handle.setframerate(rate)
        handle.writeframes(samples.tobytes())
    return str(path)


def _png_data_url(seed, size=(64, 48)):
    image = np.random.default_rng(seed).integers(
        0, 256, (size[1], size[0], 3), np.uint8)
    ok, buf = cv2.imencode(".png", image)
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def _seeded_clip(path, frames, seed, size=(48, 32), fps=8.0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, size)
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    folder = tmp_path_factory.mktemp("builder_media")
    still = folder / "still.png"
    still.write_bytes(base64.b64decode(_png_data_url(3).split(",", 1)[1]))
    (folder / "song.mp3").write_bytes(
        np.random.default_rng(8).integers(0, 256, 4096, np.uint8).tobytes())
    return {
        "folder": str(folder),
        "mix": _write_wav(folder / "mix.wav", 8.0, 1),
        "scene": _write_wav(folder / "scene.wav", 2.0, 2),
        "other": _write_wav(folder / "other.wav", 1.5, 3, rate=22050,
                            channels=1),
        "not_wav": str(folder / "song.mp3"),
        "clip": make_clip(folder / "scene.mp4", frames=10),
        "take": _seeded_clip(folder / "take.mp4", 12, 4),
        "editor_clip": _seeded_clip(folder / "editor.mp4", 9, 5),
        "still": str(still),
        "image_url": _png_data_url(1),
        "second_url": _png_data_url(2),
    }


class _FrozenTime:
    """The ``time`` module with its clock held at one instant."""

    def time(self):
        return FROZEN

    def strftime(self, fmt, moment=None):
        return time.strftime(fmt, time.localtime(FROZEN)
                             if moment is None else moment)

    def __getattr__(self, name):
        return getattr(time, name)


class _FrozenDatetime(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return _dt.datetime.fromtimestamp(FROZEN, tz)


def freeze_clocks(monkeypatch, modules):
    for module in modules:
        if isinstance(getattr(module, "time", None), types.ModuleType):
            monkeypatch.setattr(module, "time", _FrozenTime())
        if getattr(module, "datetime", None) is _dt.datetime:
            monkeypatch.setattr(module, "datetime", _FrozenDatetime)


@pytest.fixture()
def frozen(monkeypatch):
    freeze_clocks(monkeypatch, [module for pair in PAIRS for module in pair])


def _canon(value, root):
    """Root prefix replaced, file-system times dropped."""
    if isinstance(value, dict):
        return {k: _canon(v, root) for k, v in value.items()
                if k not in TIMES}
    if isinstance(value, (list, tuple)):
        return [_canon(v, root) for v in value]
    if isinstance(value, str):
        return _EPOCH.sub("#", value.replace(root, "<root>"))
    return value


def _canon_bytes(name, data, root):
    """A file's bytes in normal form: JSON parsed and canonical, other
    text with the root replaced, binary as is."""
    if name.endswith(".json"):
        try:
            return _canon(json.loads(data.decode("utf-8-sig")), root)
        except ValueError:
            pass
    if os.path.splitext(name)[1] in (".txt", ".srt", ".json", ".tmp"):
        return _canon(data.decode("utf-8"), root)
    return data


def _tree(root):
    """``{relative name: content in normal form}`` of every file."""
    found = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            relative = os.path.relpath(path, root)
            with open(path, "rb") as handle:
                found[relative] = _canon_bytes(name, handle.read(), root)
    return found


def _zip_members(path, root):
    with zipfile.ZipFile(path) as archive:
        return {info.filename: _canon_bytes(info.filename,
                                            archive.read(info), root)
                for info in archive.infolist()}


def _differences(ours, theirs, where=""):
    if isinstance(ours, dict) and isinstance(theirs, dict):
        found = []
        for key in sorted(set(ours) | set(theirs), key=str):
            found += _differences(ours.get(key, "<missing>"),
                                  theirs.get(key, "<missing>"),
                                  f"{where}.{key}")
        return found
    if isinstance(ours, list) and isinstance(theirs, list) \
            and len(ours) == len(theirs):
        return [d for i, (a, b) in enumerate(zip(ours, theirs))
                for d in _differences(a, b, f"{where}[{i}]")]
    return [] if ours == theirs else [(where, str(ours)[:200],
                                       str(theirs)[:200])]


# --------------------------------------------------------------------------
# the scenario
# --------------------------------------------------------------------------

SEGMENTS = [
    {"id": f"s{n}", "start": 1.25 * (n - 1), "end": 1.25 * n,
     "label": f"Scene {n}", "lyric_text": f"line {n}",
     "t2i_prompt": f"a wide shot {n}", "i2v_prompt": f"slow pan {n}",
     "timeline_note": f"note {n}"}
    for n in range(1, 7)]


class Recorder:
    """Each step's result (or its error) in order, under a label."""

    def __init__(self):
        self.steps = []

    def __call__(self, label, fn, *args, **kwargs):
        try:
            result = fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — errors are results too
            result = {"raised": type(exc).__name__, "error": str(exc)}
        self.steps.append((label, result))
        # distinct file-system times between steps, so the modules'
        # mtime orderings never meet a tie
        time.sleep(0.012)
        return result


def run_scenario(m, root, media):
    """The seeded scenario through one package's modules under ``root``:
    ``(steps, exported ZIP members, the extracted final frame path)``."""
    b = m.builder
    step = Recorder()
    os.makedirs(root)

    # 1-2: the project and a 6-scene timeline with the project audio
    created = step("new_project", b.new_project,
                   {"project_name": "Seeded Clip!"}, root)
    folder = created["project_folder"]
    step("save_session", b.save_session,
         {"project_folder": folder, "audio_path": media["mix"],
          "session": {"segments": SEGMENTS, "mood_board_image":
                      media["still"]}}, root)
    step("save_session again", b.save_session,
         {"project_folder": folder,
          "session": b.load_session(folder)["session"]}, root)
    step("list_projects", b.list_projects, root)
    step("load_session", b.load_session, folder)

    # 3: scene images from a seeded data-URL PNG
    step("save_scene_image", b.save_scene_image,
         {"project_folder": folder, "scene_number": 2,
          "image_data": media["image_url"]})
    step("archive_scene_image", b.archive_scene_image,
         {"project_folder": folder, "scene_number": 2,
          "source_path": media["still"]})
    step("save_reference_image", b.save_reference_image,
         {"project_folder": folder, "reference_type": "subject",
          "name": "Hero", "image_data": media["second_url"]})

    # 4-5: scene audio, the timeline mix, a trim
    step("save_scene_audio", b.save_scene_audio,
         {"project_folder": folder, "scene_number": 1,
          "source_path": media["scene"]})
    step("save_scene_audio upload", b.save_scene_audio,
         {"project_folder": folder, "scene_number": 3,
          "audio_name": "upload.wav",
          "audio_data": base64.b64encode(
              open(media["other"], "rb").read()).decode()})
    step("save_project_audio m4a", b.save_project_audio,
         {"project_folder": folder, "audio_name": "master.m4a",
          "source_path": media["mix"]})
    segments = [dict(seg) for seg in SEGMENTS]
    segments[0]["custom_audio_path"] = media["scene"]
    segments[2]["custom_audio_path"] = media["other"]
    step("mix_scene_audio", b.mix_scene_audio,
         {"project_folder": folder, "segments": segments,
          "global_audio_path": media["mix"]})
    step("mix_scene_audio missing", b.mix_scene_audio,
         {"project_folder": folder, "segments": SEGMENTS[:2]})
    step("trim_scene_audio", b.trim_scene_audio,
         {"project_folder": folder, "source_path": media["mix"],
          "scene_number": 4, "start": 1.3, "duration": 2.2})
    step("trim_scene_audio past the end", b.trim_scene_audio,
         {"project_folder": folder, "source_path": media["scene"],
          "scene_number": 4, "start": 5.0, "duration": 1.0})
    step("analyze_audio", b.analyze_audio,
         {"audio_path": media["mix"], "target_peaks": 300}, root)
    step("analyze_audio not wav", b.analyze_audio,
         {"audio_path": media["not_wav"]}, root)
    step("save_project_srt", b.save_project_srt,
         {"project_folder": folder,
          "srt_text": b.segments_to_srt(SEGMENTS)})
    step("save_single_scene_srt", b.save_scene_srt,
         {"project_folder": folder, "scene_number": 5, "start_time": 5.0,
          "duration": 1.25, "label": "Bridge"})
    step("load_srt", b.load_srt, os.path.join(folder, b.SRT_FILENAME))

    # 6-7: the final frame of a scene video, the scan and the restore
    layout = b.ProjectLayout(folder)
    os.makedirs(layout.videos_folder, exist_ok=True)
    shutil.copyfile(media["clip"], layout.scene_video_path(1))
    frame = step("extract_final_frame", b.extract_final_frame,
                 {"project_folder": folder,
                  "source_path": layout.scene_video_path(1),
                  "scene_number": 1})
    step("extract_final_frame outside", b.extract_final_frame,
         {"project_folder": folder, "source_path": media["clip"]})
    step("scan_scene_videos", b.scan_scene_videos, folder)
    step("restore_scene_video", b.restore_scene_video,
         {"project_folder": folder, "scene_number": 1,
          "source_path": media["take"]})
    step("restore_scene_video mismatch", b.restore_scene_video,
         {"project_folder": folder, "scene_number": 2,
          "source_path": media["take"], "expected_duration": 9.0})
    step("scan_scene_videos again", b.scan_scene_videos, folder)
    step("save_render_log", b.save_render_log,
         {"project_folder": folder,
          "log": {"id": "r1", "status": "complete", "scene_count": 6}})
    step("save_wizard_draft", b.save_wizard_draft,
         {"project_folder": folder, "draft": {"step": 2},
          "lyrics": "la la"})
    step("load_wizard_draft", b.load_wizard_draft,
         {"project_folder": folder})
    step("model_defaults", b.load_model_defaults, root)
    step("default_context_paths", b.default_context_paths, root)
    step("default_audio_srt_paths", b.default_audio_srt_paths, root)
    step("prompt_creator_paths", b.prompt_creator_paths, folder)

    # 8: export, then import
    zip_path, download_name = b.export_project(folder)
    try:
        members = _zip_members(zip_path, root)
        step("export_project", lambda: {"download_name": download_name})
        step("import_project", b.import_project, zip_path, "Imported",
             root)
    finally:
        os.remove(zip_path)
    spare = step("new_project spare", b.new_project,
                 {"project_name": "Spare"}, root)
    step("save_session spare", b.save_session,
         {"project_folder": spare["project_folder"],
          "session": {"segments": SEGMENTS[:1]}}, root)
    step("delete_project", b.delete_project,
         {"project_folder": spare["project_folder"]}, root)
    step("delete_project outside", b.delete_project,
         {"project_folder": media["folder"]}, root)

    # 9: the instruction store
    ins = m.instructions
    base = {"project_folder": folder, "key": "t2v", "scene_id": "s1"}
    step("get_instruction", ins.get_instruction, base)
    step("save_instruction all", ins.save_instruction,
         {**base, "scope": "all_scenes", "text": "every scene"})
    step("save_instruction scene", ins.save_instruction,
         {**base, "text": "only s1"})
    step("reset_instruction", ins.reset_instruction,
         {**base, "scope": "scene"})
    step("save_preset", ins.save_preset,
         {"key": "krea2_t2i", "name": "My Look", "text": "preset body"},
         root)
    step("list_presets", ins.list_presets, {"key": "zimage_t2i"}, root)
    step("load_preset", ins.load_preset,
         {"key": "ernie_t2i", "name": "My Look"}, root)

    # 10: text files, storyboard, video editor, LoRA dataset
    tf = m.text
    step("save_text_file", tf.save_text_file,
         {"path": os.path.join(root, "notes.txt"), "content": "hello"})
    step("load_text_file", tf.load_text_file,
         {"path": os.path.join(root, "notes.txt")})
    step("save_text_file refused", tf.save_text_file,
         {"path": os.path.join(root, "x.sh"), "content": "x"})
    step("save_text_advanced", tf.save_text_advanced,
         {"folder_name": "story", "file_name": "scene", "text": "one"}, root)
    step("save_text_advanced 2", tf.save_text_advanced,
         {"folder_name": "story", "file_name": "scene",
          "text": {"a": 1}}, root)
    for text in ("chapter one\n", "\nchapter two"):
        step("save_text_concat", tf.save_text_concat,
             {"folder_name": "story", "file_name": "tale", "concat": True,
              "text": text}, root)
    step("list_category", tf.list_category, "scene1", root)
    step("list_folders", tf.list_folders, root)
    step("list_folder_files", tf.list_folder_files, "story",
         output_root=root)
    step("save_audio_upload", tf.save_audio_upload, "My Song!.wav",
         open(media["scene"], "rb").read(), False, root)
    step("save_audio_upload again", tf.save_audio_upload, "My Song!.wav",
         b"RIFF5678", False, root)
    step("list_audio", tf.list_audio, root)
    step("concept prompts missing", tf.load_shared_concept_prompts, root)
    step("popup_config", tf.popup_config, root)
    step("popup_save_text", tf.popup_save_text,
         {"concept": "a city at dusk", "lyrics": "oh"}, root)
    step("popup_upload_audio", tf.popup_upload_audio, "drop.wav",
         open(media["other"], "rb").read(), root)

    sb = m.storyboard
    board = os.path.join(root, "board")
    step("load_storyboard", sb.load_storyboard,
         {"project_folder": board, "cameraMotionSpeed": 9})
    step("save_storyboard", sb.save_storyboard,
         {"project_folder": board, "storyboard": {
             "projectVideoEngine": "ltx", "scenes": [
                 {"label": "Open", "image_prompt": "dawn sky",
                  "video_prompt": "she sings to the camera",
                  "performance_mode": "singing"},
                 {"image_path": "/x/img.png"}]}})
    step("import_reference_image", sb.import_reference_image,
         {"project_folder": board, "kind": "location", "name": "Old Pier!",
          "description": "weathered wood", "image_data": media["image_url"]})
    step("export_prompts", sb.export_prompts,
         {"project_folder": board, "storyboard": {"scenes": [
             {"label": "One", "image_prompt": "a red door",
              "video_prompt": "door opens slowly", "lyrics": "hey"},
             {"label": "Two", "image_prompt": "a blue door"}]}})

    ve = m.editor
    edit = os.path.join(root, "edit")
    os.makedirs(edit)
    for number in (1, 2, 3):
        shutil.copyfile(media["editor_clip"],
                        os.path.join(edit, f"video_{number:04d}.mp4"))
    with open(os.path.join(edit, "cut.srt"), "w", encoding="utf-8") as fh:
        fh.write("1\n00:00:00,000 --> 00:00:02,000\nA\n\n"
                 "2\n00:00:02,000 --> 00:00:05,000\nB\n\n"
                 "3\n00:00:05,000 --> 00:00:07,500\nC\n")
    roots = (root,)
    step("list_clips", ve.list_clips, edit, "", roots)
    session = {"project_folder": edit, "clips": {
        f"video_{n:04d}.mp4": {
            "name": f"video_{n:04d}.mp4", "clip_number": n,
            "path": os.path.join(edit, f"video_{n:04d}.mp4"),
            "selected_for_remake": n in (1, 3),
            "t2i_prompt": f"prompt {n}"} for n in (1, 2, 3)}}
    step("editor save_session", ve.save_session, edit, session, roots)
    step("list_clips staged", ve.list_clips, edit, "", roots)
    step("editor load_session", ve.load_session, edit, roots)
    step("save_frame", ve.save_frame,
         {"folder_path": edit, "clip_name": "video_0002.mp4",
          "frame_time": 1.25, "image_data": media["image_url"]}, roots)
    session_path = ve.session_path_for(edit)
    step("load_clip", ve.load_clip, session_path, 3)
    for queue in range(3):
        def remake(index=queue):
            result = ve.next_remake(session_path,
                                    os.path.join(edit, "cut.srt"),
                                    media["mix"], fps=24,
                                    tail_loss_frames=5, pre_frames=8)
            audio = result.pop("audio", None)
            if audio is not None:
                result["audio_path"] = m.at.save_wav(
                    os.path.join(root, f"remake_{index}.wav"), audio)
            return result
        step(f"next_remake {queue}", remake)

    ld = m.lora
    dataset = os.path.join(root, "dataset")
    step("save_pair", ld.save_pair,
         {"dataset_folder": dataset, "index": 2, "image": media["still"],
          "caption": "a red door", "trigger_word": "zz"})
    step("save_pair data url", ld.save_pair,
         {"dataset_folder": dataset, "index": 1,
          "image": media["second_url"], "caption": "a blue door"})
    step("save_ic_pair", ld.save_ic_pair,
         {"dataset_folder": dataset, "index": 1, "reference": media["still"],
          "target": media["image_url"], "instruction": "make it  night"})
    step("list_dataset", ld.list_dataset, {"dataset_folder": dataset})
    return step.steps, members, frame.get("saved_path")


@pytest.fixture(scope="module")
def scenario(media, tmp_path_factory):
    """Both packages through the scenario, each under its own root."""
    base = tmp_path_factory.mktemp("builder_scenario")
    patch = pytest.MonkeyPatch()
    try:
        freeze_clocks(patch, [module for pair in PAIRS for module in pair])
        outs = {}
        for name, modules in (("jax", JAX), ("port", PORT)):
            root = str(base / name)
            outs[name] = (root, *run_scenario(modules, root, media))
    finally:
        patch.undo()
    return outs


def test_scenario_results_equal(scenario):
    (j_root, j_steps, _, _), (t_root, t_steps, _, _) = \
        scenario["jax"], scenario["port"]
    assert [label for label, _ in t_steps] == [label for label, _ in j_steps]
    for (label, ours), (_, theirs) in zip(t_steps, j_steps):
        differences = _differences(_canon(ours, t_root),
                                   _canon(theirs, j_root))
        assert not differences, (label, differences)
    errors = {label for label, result in j_steps
              if isinstance(result, dict) and "raised" in result}
    # the refusals the scenario asks for, and nothing else
    assert errors == {"mix_scene_audio missing",
                      "trim_scene_audio past the end",
                      "analyze_audio not wav", "extract_final_frame outside",
                      "delete_project outside", "save_text_file refused",
                      "concept prompts missing"}, errors


def test_scenario_file_trees_equal(scenario):
    (j_root, *_), (t_root, *_) = scenario["jax"], scenario["port"]
    ours, theirs = _tree(t_root), _tree(j_root)
    assert sorted(ours) == sorted(theirs)
    differences = _differences(ours, theirs)
    assert not differences, differences
    wavs = [name for name in ours if name.endswith(".wav")]
    # scene audio, the mix, the trim, the converted m4a, the uploads and
    # the remake slices: byte-equal WAVs
    assert len(wavs) >= 8, wavs


def test_scenario_exports_equal_zip_members(scenario):
    (j_root, _, j_members, _), (t_root, _, t_members, _) = \
        scenario["jax"], scenario["port"]
    assert sorted(t_members) == sorted(j_members)
    assert "vrgdg_builder_session.json" in t_members
    assert not _differences(t_members, j_members)


def test_final_frame_is_the_clips_last_decoded_frame(scenario, media):
    capture = cv2.VideoCapture(media["clip"])
    last = None
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        last = frame
    capture.release()
    for name in ("jax", "port"):
        saved = scenario[name][3]
        np.testing.assert_array_equal(cv2.imread(saved), last)


def test_remake_audio_equals_the_jax_slice(scenario):
    (j_root, *_), (t_root, *_) = scenario["jax"], scenario["port"]
    for index in range(2):
        ours = t_at.load_audio(os.path.join(t_root, f"remake_{index}.wav"))
        theirs = j_at.load_audio(os.path.join(j_root, f"remake_{index}.wav"))
        np.testing.assert_array_equal(ours["waveform"], theirs["waveform"])


# --------------------------------------------------------------------------
# per-project locks, on the port's own copies
# --------------------------------------------------------------------------

def test_port_concurrent_saves_serialize(tmp_path):
    root = str(tmp_path / "out")
    result = t_builder.save_session(
        {"project_name": "locky", "session": {"segments": []}}, root)
    folder = result["project_folder"]
    errors = []

    def spam_logs(start):
        try:
            for index in range(start, start + 10):
                t_builder.save_render_log(
                    {"project_folder": folder,
                     "log": {"id": f"r{index}", "status": "complete"}})
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=spam_logs, args=(base,))
               for base in (0, 100, 200)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert not errors
    session = t_builder._read_json(
        t_builder.ProjectLayout(folder).session_path)
    assert len(session["render_logs"]) == 20
    assert len({entry["id"] for entry in session["render_logs"]}) == 20
    # the port's locks are its own
    assert t_builder._PROJECT_LOCKS_GUARD is not \
        j_builder._PROJECT_LOCKS_GUARD


def test_port_concurrent_remake_next_serves_each_clip_once(tmp_path, media):
    project = tmp_path / "edit_proj"
    project.mkdir()
    for number in (1, 2, 3):
        shutil.copyfile(media["editor_clip"],
                        project / f"video_{number:04d}.mp4")
    (project / "cut.srt").write_text(
        "1\n00:00:00,000 --> 00:00:02,000\nA\n\n"
        "2\n00:00:02,000 --> 00:00:05,000\nB\n\n"
        "3\n00:00:05,000 --> 00:00:07,000\nC\n")
    session = {"project_folder": str(project), "clips": {
        f"video_{n:04d}.mp4": {
            "name": f"video_{n:04d}.mp4", "clip_number": n,
            "path": str(project / f"video_{n:04d}.mp4"),
            "selected_for_remake": True}
        for n in (1, 2, 3)}}
    t_editor.save_session(str(project), session)
    session_path = t_editor.session_path_for(str(project))
    served, errors = [], []

    def poll():
        try:
            while True:
                item = t_editor.next_remake(session_path,
                                            str(project / "cut.srt"),
                                            media["mix"], fps=24)
                if not item["is_valid"]:
                    return
                served.append(item["clip_number"])
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=poll) for _ in range(3)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert not errors
    assert sorted(served) == [1, 2, 3]


# --------------------------------------------------------------------------
# the builder and humo commands
# --------------------------------------------------------------------------

def _cli(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_builder_command_prints_what_the_jax_cli_prints(tmp_path, media,
                                                        capsys, frozen):
    outs = {}
    for name, main in (("jax", j_cli.main), ("port", t_cli.main)):
        base = tmp_path / name
        root = str(base / "root")
        session = base / "session.json"
        os.makedirs(base)
        session.write_text(json.dumps({"segments": SEGMENTS[:3]}))
        segments = base / "segments.json"
        segments.write_text(json.dumps(
            [{**SEGMENTS[0], "custom_audio_path": media["scene"]},
             SEGMENTS[1]]))
        project = os.path.join(root, "Cli Project")
        steps = []

        def run(*argv):
            steps.append(_cli(main, ["builder", *argv, "--output-root",
                                     root], capsys))
            time.sleep(0.012)

        run("new", "Cli Project")
        run("save", project, "--session", str(session), "--audio",
            media["mix"])
        run("save", project, "--name", "Cli Project")
        run("list")
        run("load", project)
        run("scan", project)
        run("analyze", media["mix"])
        run("mix", project, "--session", str(segments))
        run("export", project, "-o", str(base / "out.vrgdg.zip"))
        members = _zip_members(str(base / "out.vrgdg.zip"), root)
        run("import", str(base / "out.vrgdg.zip"), "--name", "Back")
        run("new", "Gone")
        run("save", os.path.join(root, "Gone"))
        run("delete", os.path.join(root, "Gone"))
        outs[name] = (str(base), steps, members, _tree(root))
    (j_base, j_steps, j_members, j_tree), \
        (t_base, t_steps, t_members, t_tree) = outs["jax"], outs["port"]
    assert not _differences(_canon(t_steps, t_base),
                            _canon(j_steps, j_base))
    assert not _differences(t_members, j_members)
    assert sorted(t_tree) == sorted(j_tree)
    assert not _differences(t_tree, j_tree)


def test_humo_command_prints_what_the_jax_cli_prints(tmp_path, media,
                                                     capsys):
    outs = {}
    for name, main in (("jax", j_cli.main), ("port", t_cli.main)):
        base = tmp_path / name
        sets = base / "sets"
        os.makedirs(sets)
        mix = shutil.copyfile(media["mix"], base / "mix.wav")
        for index, seed in ((1, 6), (2, 7)):
            shutil.copyfile(_seeded_clip(tmp_path / f"s{index}.mp4",
                                         4 + index, seed),
                            sets / f"set{index}-audio.mp4")
        steps = [_cli(main, ["humo", *argv], capsys) for argv in (
            ["plan", str(mix), "--scene-duration", "2.5"],
            ["split-set", str(mix), "--index", "0",
             "-o", str(base / "set0")],
            ["chunk", str(mix), "--index", "1", "--durations", "2,1.5,3",
             "-o", str(base / "chunks")],
            ["chunk", str(mix), "--index", "0", "--fps", "25",
             "--humo-align", "-o", str(base / "chunks")],
            ["final", str(sets), "--threshold", "3"],
            ["final", str(sets), "--threshold", "2", "--audio", str(mix)],
            ["grid", str(sets), "--labels", "one,two",
             "-o", str(base / "grid.mp4")])]
        outs[name] = (str(base), steps, _tree(str(base / "set0")),
                      _tree(str(base / "chunks")))
    (j_base, j_steps, *j_trees), (t_base, t_steps, *t_trees) = \
        outs["jax"], outs["port"]
    assert not _differences(_canon(t_steps, t_base),
                            _canon(j_steps, j_base))
    assert t_trees == j_trees
    assert len(t_trees[0]) == 17    # 16 WAVs and meta.json
    for name in ("grid.mp4", "sets/FINAL_VIDEO.mp4"):
        ours, theirs = (os.path.join(outs[key][0], name)
                        for key in ("port", "jax"))
        assert os.path.isfile(ours) == os.path.isfile(theirs)
