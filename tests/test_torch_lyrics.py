"""The port's copies of the text modules (lyric alignment, JSON fixers,
prompt splitters, SRT tools and the four modules of
tests/test_torch_llm_batches.py), held equal to their originals.

``vrgdg_tpu_torch.runtime.{srt_tools, json_fixers, prompt_splitters,
lyric_align, llm_batches, combined_files, text_pickers, graph_plans}`` are
copies of JAX-free modules of ``vrgdg_tpu`` (which cannot be imported
without JAX).  Every function and class keeps its original's source and
every constant its value.  Then both packages run the same seeded inputs
(numpy seeds): a song in the ASR word-JSON contract through the lyric
alignment, broken LLM JSON through the fixers, prompt JSON through every
splitter, SRT text through the SRT tools.  Both sides are the same Python
on the same inputs, so every comparison is exact: results equal, and on a
text neither side can repair, the same exception with the same message.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import chip_smoke as cs
from tests.test_torch_builder import _classes, _constants
from tests.test_torch_host_copies import _functions, _normalized
from vrgdg_tpu.runtime import combined_files as j_cbf
from vrgdg_tpu.runtime import graph_plans as j_gp
from vrgdg_tpu.runtime import json_fixers as j_jf
from vrgdg_tpu.runtime import llm_batches as j_lbx
from vrgdg_tpu.runtime import lyric_align as j_lal
from vrgdg_tpu.runtime import prompt_splitters as j_ps
from vrgdg_tpu.runtime import srt_tools as j_srt
from vrgdg_tpu.runtime import text_pickers as j_tp
from vrgdg_tpu_torch.runtime import combined_files as t_cbf
from vrgdg_tpu_torch.runtime import graph_plans as t_gp
from vrgdg_tpu_torch.runtime import json_fixers as t_jf
from vrgdg_tpu_torch.runtime import llm_batches as t_lbx
from vrgdg_tpu_torch.runtime import lyric_align as t_lal
from vrgdg_tpu_torch.runtime import prompt_splitters as t_ps
from vrgdg_tpu_torch.runtime import srt_tools as t_srt
from vrgdg_tpu_torch.runtime import text_pickers as t_tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = [(j_srt, t_srt), (j_jf, t_jf), (j_ps, t_ps), (j_lal, t_lal),
         (j_lbx, t_lbx), (j_cbf, t_cbf), (j_tp, t_tp), (j_gp, t_gp)]
PAIR_IDS = ["srt_tools", "json_fixers", "prompt_splitters", "lyric_align",
            "llm_batches", "combined_files", "text_pickers", "graph_plans"]

_WORDS = ("hold", "run away", 'neon "rain"', "ámbar", "it's",
          "slow push-in", "雨", "oh", "you", "the river")


def outcome(fn, *args, **kwargs):
    """``("ok", result)`` or ``("error", type name, message)``: a result
    and a refusal compare alike."""
    try:
        return ("ok", json.loads(json.dumps(fn(*args, **kwargs),
                                            default=str)))
    except Exception as exc:  # noqa: BLE001 — the refusal is the outcome
        return ("error", type(exc).__name__, str(exc))


def same(jax_fn, port_fn, *args, **kwargs):
    """Both functions on the same arguments: equal outcomes."""
    want = outcome(jax_fn, *args, **kwargs)
    assert outcome(port_fn, *args, **kwargs) == want
    return want


# --------------------------------------------------------------------------
# sources and constants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_function_and_class_source(original,
                                                             copy):
    names = _functions(original)
    assert names == _functions(copy) and names
    assert _classes(original) == _classes(copy)
    for name in names + _classes(original):
        assert inspect.getsource(getattr(copy, name)) == _normalized(
            inspect.getsource(getattr(original, name))), name


@pytest.mark.parametrize("original,copy", PAIRS, ids=PAIR_IDS)
def test_copied_modules_keep_every_constant(original, copy):
    ours, theirs = _constants(copy), _constants(original)
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        if name == "SPLIT_VARIANTS":
            # a table of dataclass rows holding functions: compare the
            # rows field by field, each function by its source
            assert _rows(copy.SPLIT_VARIANTS) == \
                _rows(original.SPLIT_VARIANTS)
            continue
        assert ours[name] == theirs[name], name


def _rows(table):
    return {key: {field.name: (inspect.getsource(value)
                               if callable(value) else value)
                  for field in dataclasses.fields(row)
                  for value in [getattr(row, field.name)]}
            for key, row in table.items()}


def test_the_new_modules_import_neither_jax_pillow_nor_the_jax_package():
    code = ("import sys\n"
            "import vrgdg_tpu_torch.runtime, "
            "vrgdg_tpu_torch.runtime.lyric_align, "
            "vrgdg_tpu_torch.runtime.json_fixers, "
            "vrgdg_tpu_torch.runtime.llm_batches, "
            "vrgdg_tpu_torch.runtime.combined_files, "
            "vrgdg_tpu_torch.runtime.text_pickers, "
            "vrgdg_tpu_torch.runtime.graph_plans, "
            "vrgdg_tpu_torch.runtime.prompt_splitters, "
            "vrgdg_tpu_torch.runtime.srt_tools, "
            "vrgdg_tpu_torch.tools.generate_lut_examples\n"
            "from vrgdg_tpu_torch.runtime.lyric_align import "
            "humo_scene_windows\n"
            "humo_scene_windows(44100 * 9, 44100)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vrgdg_tpu', 'PIL')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and "clean" in done.stdout, done.stderr


def test_lazy_audio_import_resolves_to_the_port():
    """``humo_scene_windows`` imports ``adjust_frames_humo`` where it
    runs: the port's own ``runtime/audio_toolkit``."""
    source = inspect.getsource(t_lal.humo_scene_windows)
    assert "from .audio_toolkit import adjust_frames_humo" in source
    for total, rate, seconds in ((44100 * 31, 44100, 4.0),
                                 (48000 * 9 + 7, 48000, 2.5)):
        assert t_lal.humo_scene_windows(total, rate, seconds) \
            == j_lal.humo_scene_windows(total, rate, seconds)
    assert "vrgdg_tpu_torch.runtime.audio_toolkit" in sys.modules


# --------------------------------------------------------------------------
# lyric alignment
# --------------------------------------------------------------------------

SONG_SEEDS = (11, 12, 13)


@pytest.fixture(scope="module")
def songs():
    """Seeded songs of 12 reference lines (about 48 s, 130 words)."""
    return {seed: cs.seeded_song(seed, lines=12, seconds=48.0)
            for seed in SONG_SEEDS}


@pytest.mark.parametrize("seed", SONG_SEEDS)
def test_segments_from_words_and_windows_equal(songs, seed):
    song = songs[seed]
    for raw in (song["asr"]["segments"], song["backup"]["segments"]):
        got = same(j_lal.segments_from_words, t_lal.segments_from_words,
                   raw)
        assert got[0] == "ok" and got[1]
    srt = cs.scene_srt(song["asr"]["duration"], 12)
    windows = same(j_lal.srt_windows, t_lal.srt_windows, srt)
    assert len(windows[1]) == 12
    for text in ("", "garbage\n\n3\nnot a stamp",
                 "00:00:00,000 --> 00:00:06,000\nhello\n\n"
                 "00:00:06,000 --> 00:00:12,000\nworld"):
        same(j_lal.srt_windows, t_lal.srt_windows, text)
    same(j_lal.split_reference_lyrics, t_lal.split_reference_lyrics,
         song["reference"])


@pytest.mark.parametrize("gaps", [True, False], ids=["gaps", "no_gaps"])
@pytest.mark.parametrize("mode", j_lal.SEGMENT_MODES)
@pytest.mark.parametrize("seed", SONG_SEEDS)
def test_timestamped_lyrics_equal(songs, seed, mode, gaps):
    song = songs[seed]
    segments = j_lal.segments_from_words(song["asr"]["segments"])
    got = same(j_lal.timestamped_lyrics, t_lal.timestamped_lyrics,
               segments, song["asr"]["duration"],
               reference_lyrics=song["reference"], segment_mode=mode,
               include_instrumental_gaps=gaps)
    assert got[0] == "ok" and got[1]["segment_count"] > 0
    # without reference lyrics too
    same(j_lal.timestamped_lyrics, t_lal.timestamped_lyrics, segments,
         song["asr"]["duration"], segment_mode=mode,
         include_instrumental_gaps=gaps, min_gap_seconds=0.5,
         max_scene_seconds=5.0)


@pytest.mark.parametrize("seed", SONG_SEEDS)
def test_extract_window_lyrics_equal(songs, seed):
    song = songs[seed]
    segments = j_lal.segments_from_words(song["asr"]["segments"])
    backup = j_lal.segments_from_words(song["backup"]["segments"])
    windows = j_lal.srt_windows(cs.scene_srt(song["asr"]["duration"], 12))
    fixed = j_lal.fixed_scene_windows(int(song["asr"]["duration"] * 16000),
                                      16000, 25, 4.0)
    for kwargs in ({}, {"reference_lyrics": song["reference"]},
                   {"reference_lyrics": song["reference"],
                    "strict_reference_text": False,
                    "fill_aggressiveness": 2},
                   {"reference_lyrics": song["reference"],
                    "backup_segments": backup},
                   {"reference_lyrics": song["reference"],
                    "backup_segments": backup, "native_align": True},
                   {"reference_lyrics": song["reference"],
                    "native_align": True, "legacy_beat": True,
                    "preserve_nonvocal_segments": False}):
        for frames in (windows, fixed):
            got = same(j_lal.extract_window_lyrics,
                       t_lal.extract_window_lyrics, segments, frames,
                       **kwargs)
            assert got[0] == "ok" and len(got[1]["texts"]) == len(frames)


# --------------------------------------------------------------------------
# JSON fixers
# --------------------------------------------------------------------------

def damage(rng, text):
    """The damage classes of LLM JSON: fences, chatter, doubled braces,
    trailing commas, smart quotes, inner quotes and cut endings."""
    if rng.random() < 0.4:
        text = f"```json\n{text}\n```"
    if rng.random() < 0.3:
        text = "Sure! Here you go:\n" + text
    if rng.random() < 0.3:
        text = text.replace("{", "{ {", 1)
    if rng.random() < 0.3:
        text = text.replace("}", ",}", 1)
    if rng.random() < 0.3:
        text = text.replace('"', "“", 1).replace('"', "”", 1)
    if rng.random() < 0.2:
        text = text.replace(': "', ': "said "so" ', 1)
    if rng.random() < 0.15:
        text = text.rstrip()[:-int(rng.integers(1, 6))]
    return text


def _pick(rng, options):
    return options[int(rng.integers(len(options)))]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lyric_segment_fixer_and_cleaner_equal(seed):
    rng = np.random.default_rng(seed)
    outcomes = set()
    for _ in range(60):
        style = _pick(rng, ["lyricSegment{i}", "segment{i}",
                            "LyricSegment {i}", "Segment_{i}", "lyric{i}",
                            "s{i}", "verse{i}"])
        payload = {style.replace("{i}", str(i + _pick(rng, [1, 3]))):
                   _pick(rng, _WORDS)
                   for i in range(1, int(rng.integers(0, 7)) + 1)}
        text = damage(rng, json.dumps(payload, ensure_ascii=False))
        outcomes.add(same(j_jf.fix_lyric_segments_json,
                          t_jf.fix_lyric_segments_json, text)[0])
        lines = [f"lyricSegment{i} = " + _pick(
            rng, ["oh", "run run run run", "", "hold me now", "la",
                  *_WORDS]) for i in range(1, int(rng.integers(0, 9)) + 1)]
        same(j_jf.clean_lyric_segments, t_jf.clean_lyric_segments,
             "\n".join(lines), int(_pick(rng, [2, 3, 5])),
             int(_pick(rng, [2, 4, 6])), bool(rng.random() < 0.7),
             bool(rng.random() < 0.7))
    assert outcomes == {"ok", "error"}


@pytest.mark.parametrize("seed", [4, 5])
def test_prompt_map_subject_and_story_fixers_equal(seed, tmp_path):
    rng = np.random.default_rng(seed)
    outcomes = set()
    srt = cs.scene_srt(8.0, 2)
    (tmp_path / "scenes.srt").write_text(srt)
    for case in range(60):
        style = _pick(rng, ["Prompt{i}", "prompt {i}", "Scene{i}", "p-{i}",
                            "text"])
        count = int(rng.integers(0, 7))
        payload = {style.replace("{i}", str(i)): _pick(
            rng, [_pick(rng, _WORDS), f"line\nwith\nbreaks {i}", i * 2,
                  None]) for i in range(1, count + 1)}
        text = damage(rng, json.dumps(payload, ensure_ascii=False))
        outcomes.add(same(j_jf.fix_prompt_map_json, t_jf.fix_prompt_map_json,
                          text)[0])
        source = _pick(rng, [None, srt, str(tmp_path / "scenes.srt")])
        same(j_jf.fix_prompt_map_json, t_jf.fix_prompt_map_json,
             json.dumps({f"Prompt{i}": "a" for i in range(1, count + 1)}),
             srt_source=source)
        same(j_jf.prepend_prompt_subject, t_jf.prepend_prompt_subject,
             _pick(rng, ["A red fox", "", "  the crew "]), text,
             separator=_pick(rng, [", ", " - "]),
             skip_if_already_starts=bool(rng.random() < 0.5))
        groups = [{"index": _pick(rng, [i, str(i), -1, i + 10]),
                   "subject": _pick(rng, _WORDS),
                   "camera": _pick(rng, _WORDS),
                   "scene_and_lighting": _pick(rng, _WORDS),
                   "frame": _pick(rng, _WORDS)}
                  for i in range(1, int(rng.integers(0, 5)) + 1)]
        story = {"story_summary": _pick(rng, _WORDS), "groups": groups}
        if case % 9 == 0:
            del story["story_summary"]
        outcomes.add(same(j_jf.fix_story_group_json,
                          t_jf.fix_story_group_json,
                          damage(rng, json.dumps(story,
                                                 ensure_ascii=False)))[0])
    assert outcomes == {"ok", "error"}


@pytest.mark.parametrize("seed", [6, 7])
def test_merge_segment_durations_equal(seed):
    rng = np.random.default_rng(seed)
    outcomes = set()
    for _ in range(60):
        count = int(rng.integers(1, 6))
        prefix = _pick(rng, ["lyricSegment", "segment"])
        payload = {f"{prefix}{i if rng.random() < 0.8 else i + 1}":
                   _pick(rng, _WORDS) for i in range(1, count + 1)}
        scenes = count if rng.random() < 0.8 else count + 1
        srt = cs.scene_srt(float(rng.uniform(2.0, 40.0)), scenes)
        outcomes.add(same(
            j_jf.merge_segment_durations, t_jf.merge_segment_durations, srt,
            damage(rng, json.dumps(payload, ensure_ascii=False)),
            bool(rng.random() < 0.6), int(_pick(rng, [0, 2, 3])),
            bool(rng.random() < 0.85))[0])
    assert outcomes == {"ok", "error"}


@pytest.mark.parametrize("text", [
    "not json at all", "{}", "", '{"lyricSegment1": "a" "lyricSegment2": "b"}',
    '{ {"lyricSegment1": "x"}', '{"groups": [', '{"story_summary": 3}',
    '```json\n{"Prompt1": "a",}\n```', "[1, 2, 3]"],
    ids=["prose", "empty_object", "empty", "missing_comma", "doubled_brace",
         "cut", "no_groups", "fenced_comma", "list"])
def test_fixers_refuse_alike(text):
    """Texts some fixer cannot repair: the same answer or the same
    exception and message on both sides, fixer by fixer."""
    for name in ("fix_lyric_segments_json", "fix_prompt_map_json",
                 "fix_story_group_json"):
        same(getattr(j_jf, name), getattr(t_jf, name), text)
    same(j_jf.merge_segment_durations, t_jf.merge_segment_durations,
         cs.scene_srt(6.0, 2), text)


# --------------------------------------------------------------------------
# prompt splitters
# --------------------------------------------------------------------------

def _prompt_value(rng):
    return _pick(rng, [_pick(rng, _WORDS), {"shot": _pick(rng, _WORDS)},
                       [_pick(rng, _WORDS), "", _pick(rng, _WORDS)],
                       int(rng.integers(100)), None])


@pytest.mark.parametrize("variant", sorted(j_ps.SPLIT_VARIANTS))
def test_split_prompts_equal(variant):
    rng = np.random.default_rng(sorted(j_ps.SPLIT_VARIANTS).index(variant))
    for case in range(40):
        count = int(rng.integers(0, 40))
        style = _pick(rng, ["prompt{i}", "Prompt {i}", "scene{i}", "x"])
        payload = {style.replace("{i}", str(i)): _prompt_value(rng)
                   for i in range(1, count + 1)}
        text = json.dumps(payload, ensure_ascii=False)
        if case % 3 == 0:
            text = f"```json\n{text}\n```"
        if case % 7 == 0:
            text = text.replace('"', '`"', 1)
        if case % 11 == 0:
            text = text[:-1]
        for index in (0, 1, 3):
            same(j_ps.split_prompts, t_ps.split_prompts, variant, text,
                 index=index)


def test_other_splitters_and_builders_equal():
    rng = np.random.default_rng(21)
    for case in range(40):
        t2i = {"t2i": _pick(rng, _WORDS),
               "i2v": _pick(rng, [_pick(rng, _WORDS),
                                  [_pick(rng, _WORDS), ""]])}
        text = json.dumps(t2i, ensure_ascii=False)
        same(j_ps.split_t2i_i2v, t_ps.split_t2i_i2v,
             _pick(rng, [text, f"```json\n{text}\n```", text[:-2], ""]))
        words = [_pick(rng, _WORDS + ("\n", "\\n", "\r", ". "))
                 for _ in range(int(rng.integers(1, 14)))]
        same(j_ps.split_text_two, t_ps.split_text_two, " ".join(words))
        sections = [(_pick(rng, ["Theme / Style", "Instructions", "Story"]),
                     _pick(rng, ["", "   ", _pick(rng, _WORDS),
                                 f"  {_pick(rng, _WORDS)}\n"]))
                    for _ in range(5)]
        same(j_ps.build_prompt_template, t_ps.build_prompt_template,
             sections)
        count = int(rng.integers(0, 8))
        lyrics = "\n".join(f"lyricSegment{i} = {_pick(rng, _WORDS)}"
                           for i in range(1, count + 1))
        emotions = "\n".join(f"emotionSegment{i}={_pick(rng, ['sad', 'joy'])}"
                             for i in range(1, count + 1)
                             if rng.random() < 0.7)
        same(j_ps.merge_lyrics_emotions, t_ps.merge_lyrics_emotions,
             lyrics, emotions)
        pipes = _pick(rng, [" | ", "\n\n", "\n"]).join(
            _pick(rng, _WORDS) for _ in range(int(rng.integers(0, 20))))
        same(j_ps.split_pipe_or_paragraphs, t_ps.split_pipe_or_paragraphs,
             pipes)
        same(j_ps.pick_cycled_prompt, t_ps.pick_cycled_prompt,
             json.dumps({f"prompt{i}": _pick(rng, _WORDS)
                         for i in range(1, count + 2)}), case)
        same(j_ps.format_emotion_segments, t_ps.format_emotion_segments,
             [_pick(rng, ["sad", "joy", "calm"]) for _ in range(count)])
        same(j_ps.split_theme_context, t_ps.split_theme_context,
             f"Theme: {_pick(rng, _WORDS)}\nContext: {_pick(rng, _WORDS)}"
             f"\n{pipes}")


# --------------------------------------------------------------------------
# SRT tools (the cases of tests/test_srt_and_schedules.py)
# --------------------------------------------------------------------------

SRT = """1
00:00:00,000 --> 00:00:02,500
SCENE 1

2
00:00:02,500 --> 00:00:06,000
SCENE 2

3
00:00:06,000 --> 00:00:10,250
SCENE 3
"""


def test_scene_durations_and_lyric_merge_equal():
    assert same(j_srt.scene_durations, t_srt.scene_durations, SRT)[1] == \
        {"1": 2.5, "2": 3.5, "3": 4.25}
    lyrics = {"lyricSegment1": "hello", "lyricSegment2": "world",
              "lyricSegment9": "missing", "metadata": "dropped"}
    for value in (json.dumps(lyrics), lyrics, "{not json"):
        same(j_srt.merge_srt_lyrics, t_srt.merge_srt_lyrics, SRT, value)
    assert t_srt.scene_durations(SRT) == {1: 2.5, 2: 3.5, 3: 4.25}


def test_latest_srt_equal(tmp_path):
    main, legacy = tmp_path / "srt_files", tmp_path / "SRT_Files"
    main.mkdir()
    legacy.mkdir()
    same(j_srt.latest_srt, t_srt.latest_srt, str(main))
    assert same(j_srt.latest_srt, t_srt.latest_srt, str(main),
                require=True)[1] == "FileNotFoundError"
    old = legacy / "old.srt"
    old.write_text("1\n")
    os.utime(old, (time.time() - 100, time.time() - 100))
    (main / "new.srt").write_text("1\n")
    assert same(j_srt.latest_srt, t_srt.latest_srt, str(main),
                str(legacy))[1][1] == "new.srt"
    future = time.time() + 50
    os.utime(old, (future, future))
    assert same(j_srt.latest_srt, t_srt.latest_srt, str(main),
                str(legacy))[1][1] == "old.srt"
