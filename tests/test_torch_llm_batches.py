"""The LLM batch loop, combined files, text pickers and graph plans of the
port, their routes and commands, and the LUT examples tool, held equal to
the JAX package's.

The modules are copies of ``vrgdg_tpu.runtime``'s (their sources are held
equal in tests/test_torch_lyrics.py).  Here both packages run the same
seeded inputs (numpy seeds): the plan -> save -> combine -> split loop in
a root of each package's own (equal answers and equal written trees, root
paths made relative), the combined-file edits on those trees, the pickers
in every selection and split mode, the graph plans, and a graph plan
applied by each package's ``apply_lora_plan``.  The 14 routes answer alike
on the JAX app and the port's (``device="cpu"``), and the ``lyrics``,
``llm-batch`` and ``graph`` commands print what ``vrgdg_tpu.cli`` prints.
"""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from tests.test_torch_builder import _canon, _differences, _tree
from tests.test_torch_lyrics import same
from tests.test_torch_secondary_ops import _lora
from tests.test_torch_server import both, pair  # noqa: F401 — fixture
from vrgdg_tpu import cli as j_cli
from vrgdg_tpu.ops import lora as j_lora
from vrgdg_tpu.runtime import combined_files as j_cbf
from vrgdg_tpu.runtime import graph_plans as j_gp
from vrgdg_tpu.runtime import llm_batches as j_lbx
from vrgdg_tpu.runtime import text_pickers as j_tp
from vrgdg_tpu_torch import cli as t_cli
from vrgdg_tpu_torch.ops import lora as t_lora
from vrgdg_tpu_torch.runtime import combined_files as t_cbf
from vrgdg_tpu_torch.runtime import graph_plans as t_gp
from vrgdg_tpu_torch.runtime import llm_batches as t_lbx
from vrgdg_tpu_torch.runtime import text_pickers as t_tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (j_lbx, j_cbf), "port": (t_lbx, t_cbf)}


# --------------------------------------------------------------------------
# the LLM batch loop and the combined files it writes
# --------------------------------------------------------------------------

def run_batch_loop(lbx, cbf, base, groups, size, seed):
    """plan -> save until final -> combine -> split, then the combined-file
    browser, a remake edit and the remake indexes, all under ``base``;
    every answer in order."""
    root = os.path.join(base, "llm_batches")
    lyrics = {f"seg{n + 1}": f"line {n + 1}" for n in range(len(groups))}
    answers = []
    for index in range(-(-len(groups) // size)):
        plan = lbx.plan_batch(root, {"groups": groups}, "a summary",
                              batch_size=size, file_prefix="Shot",
                              lyric_segments=lyrics)
        answers.append(plan)
        answers.append(lbx.save_batch(
            plan["folder"], "Shot", index,
            cs.seeded_llm_reply(seed, index, size)))
    assert plan["is_final"]
    answers.append(lbx.combine_batches(plan["folder"], "Shot"))
    damaged = cs.damaged_prompt_json(answers[-1]["text"])
    for index in (0, 1):
        answers.append(lbx.split_prompt_json(
            damaged, folder=os.path.join(base, "split"), index=index))
    answers.append(lbx.plan_batch(root, groups, "again", batch_size=size))
    name = os.path.basename(answers[-4]["path"])
    remake = os.path.join(base, "clips", "remake")
    os.makedirs(remake)
    for number in (2, 9, 30):
        open(os.path.join(remake, f"video_{number}_x.mp4"), "wb").close()
    for call in (
            lambda: cbf.combined_files_state(root, "Text2Image", ""),
            lambda: cbf.combined_files_state(root, "Image2Video", name),
            lambda: cbf.combined_file_prompt_values(root, "", name),
            lambda: cbf.combined_file_prompt_values(root, "", "nope.json"),
            lambda: cbf.update_combined_file_prompts(
                root, {"remake_mode": "true", "combined_json_file": name,
                       "updates": [{"prompt_number": 3, "prompt": "edit",
                                    "image_index": "1, 2"},
                                   {"prompt_number": "x"}]}),
            lambda: cbf.update_combined_file_prompts(
                root, {"remake_mode": True, "use_plain_text": True,
                       "combined_json_file": name,
                       "updates": [{"prompt_number": 4, "prompt": 7}]}),
            lambda: cbf.update_combined_file_prompts(root, {}),
            lambda: cbf.combined_file_prompt_values(root, "", name),
            lambda: cbf.remake_prompt_state(os.path.join(base, "clips")),
            lambda: cbf.remake_prompt_state(os.path.join(base, "none"))):
        try:
            answers.append(call())
        except ValueError as exc:
            answers.append({"error": str(exc)})
    return answers


@pytest.mark.parametrize("groups,size,seed", [(23, 5, 1), (60, 10, 2),
                                              (7, 10, 3)],
                         ids=["23x5", "60x10", "7x10"])
def test_batch_loop_answers_and_trees_equal(tmp_path, groups, size, seed):
    story = cs.seeded_story_groups(seed, groups)["groups"]
    found = {}
    for name, (lbx, cbf) in SIDES.items():
        base = str(tmp_path / name)
        found[name] = (_canon(json.loads(json.dumps(
            run_batch_loop(lbx, cbf, base, story, size, seed), default=str)),
            base), _tree(base))
    assert not _differences(found["port"][0], found["jax"][0])
    assert sorted(found["port"][1]) == sorted(found["jax"][1])
    assert not _differences(found["port"][1], found["jax"][1])
    assert any("_COMBINED.json" in name for name in found["port"][1])


@pytest.mark.parametrize("seed", [4, 5])
def test_prompt_json_hygiene_and_chapters_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    for index in range(20):
        text = cs.seeded_llm_reply(seed, index, int(rng.integers(1, 18)))
        for variant in (text, cs.damaged_prompt_json(text.split("```json")
                                                     [1].split("```")[0]),
                        text[: int(rng.integers(5, 40))], "no json here"):
            same(j_lbx.clean_prompt_json, t_lbx.clean_prompt_json, variant)
            same(j_lbx.extract_json_block, t_lbx.extract_json_block,
                 variant, label="reply")
            same(j_lbx.split_prompt_json, t_lbx.split_prompt_json, variant,
                 index=index % 3)
    for name, (lbx, _) in SIDES.items():
        folder = tmp_path / name
        folder.mkdir()
        (folder / "summary0.json").write_text(json.dumps(
            {"scene_summary": "dawn", "character_arc": "rise"}))
    for index, total in ((0, 1), (1, 3), (2, 3), (5, 2)):
        states = [json.loads(json.dumps(lbx.story_chapter_state(
            "neon noir", str(tmp_path / name), index, total, 7)).replace(
            str(tmp_path / name), "<root>"))
            for name, (lbx, _) in SIDES.items()]
        assert states[0] == states[1]


# --------------------------------------------------------------------------
# text pickers
# --------------------------------------------------------------------------

def _items(rng, split_mode):
    words = [f"{cs._SHOT_WORDS[int(rng.integers(12))]} {n}" for n in
             range(int(rng.integers(1, 12)))]
    return {"auto": "\n".join(words), "line": "\n\n".join(words),
            "blank line": "\n\n".join(f"{w}\nmore" for w in words),
            "comma": ", ".join(words), "pipe": " | ".join(words),
            "json/python": json.dumps({"items": words})}[split_mode]


@pytest.mark.parametrize("selection_mode", j_tp.SELECTION_MODES)
@pytest.mark.parametrize("split_mode", j_tp.SPLIT_MODES)
def test_pick_text_equal(split_mode, selection_mode):
    rng = np.random.default_rng(j_tp.SPLIT_MODES.index(split_mode))
    for seed in (0, 7, 123456):
        items = _items(rng, split_mode)
        for index in (0, 3, 17, -2):
            for pick_count, multi_format in ((1, "auto"), (2, "auto"),
                                             (3, "lines"), (2, "sentence"),
                                             (3, "comma")):
                got = same(j_tp.pick_text, t_tp.pick_text, index, items,
                           label="Shot", split_mode=split_mode,
                           selection_mode=selection_mode, seed=seed,
                           multi_format=multi_format,
                           pick_count=pick_count, keep_empty=index < 0)
                assert got[0] == "ok"


def test_pickers_over_a_long_list_and_multi_pick_equal():
    items = cs.seeded_picker_items(9, 500)
    for mode in j_tp.SELECTION_MODES:
        for index in range(0, 1500, 137):
            assert same(j_tp.pick_text, t_tp.pick_text, index, items,
                        selection_mode=mode, seed=42)[1]["item_count"] == 500
    pickers = [{"items": items, "label": "Shot", "index": 9,
                "selection_mode": "random no repeat", "seed": 5},
               {"preset": "Lighting", "index": 3},
               {"items": "# LABEL: Mood\n# PICK_COUNT: 2\ncalm\nwild\nlost",
                "index": 1}, {"items": "", "label": "empty"}]
    for joiner in ("newline", "blank line", "comma", "pipe", "unknown"):
        same(j_tp.run_multi_picker, t_tp.run_multi_picker, pickers, joiner)


# --------------------------------------------------------------------------
# graph plans, and a plan applied by apply_lora_plan
# --------------------------------------------------------------------------

def _lora_payloads(rng, names, tmp_path):
    (tmp_path / "one.safetensors").write_bytes(b"x")
    (tmp_path / "two.txt").write_bytes(b"x")
    payloads = []
    for variant in ("model_only", "two_pass", "path"):
        for _ in range(8):
            slots = int(rng.integers(0, 10))
            payload = {"variant": variant, "lora_count": _pick(
                rng, [slots, str(slots), "x", 30]),
                "use_custom_loras": _pick(rng, [True, "true", "false",
                                                False, 1]),
                "ltx_two_pass_mode": _pick(rng, [True, "false"])}
            for slot in range(1, slots + 1):
                payload[f"lora_{slot}"] = _pick(rng, names + ["[none]", ""])
                payload[f"strength_{slot}"] = _pick(
                    rng, [round(float(rng.uniform(-2, 2)), 3), 0, "bad"])
                payload[f"first_pass_strength_{slot}"] = _pick(
                    rng, [round(float(rng.uniform(-1, 1)), 3), 0])
                payload[f"second_pass_strength_{slot}"] = _pick(
                    rng, [round(float(rng.uniform(-1, 1)), 3), 0, "x"])
            payload["lora_path"] = _pick(
                rng, ["", str(tmp_path / "one.safetensors"),
                      str(tmp_path / "two.txt"), str(tmp_path / "none.pt")])
            payload["strength_model"] = _pick(rng, [1.0, 0, -0.5])
            payloads.append(payload)
    return payloads


def _pick(rng, options):
    return options[int(rng.integers(len(options)))]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lora_and_state_plans_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    names = [f"style_{n}.safetensors" for n in range(6)]
    outcomes = set()
    for payload in _lora_payloads(rng, names, tmp_path):
        outcomes.add(same(j_gp.lora_plan_from_payload,
                          t_gp.lora_plan_from_payload, payload)[0])
    assert outcomes == {"ok", "error"}
    for _ in range(20):
        state = cs.seeded_state_payload(int(rng.integers(1 << 30)))
        for payload in (state, {**state, "group_targets_json": "[bad"},
                        {**state, "group_targets_json": "",
                         "node_ids_csv": "3, 5;5, x, -1",
                         "group_action": _pick(rng, ["mute", "bypass",
                                                     "active"]),
                         "queue_delay_seconds": _pick(rng, [0, 2.5])},
                        {"mode": "mute", "node_ids": "1,2;3,3",
                         "set_state": _pick(rng, [True, "false"]),
                         "off_mode": _pick(rng, ["mute", "bypass"])}):
            same(j_gp.state_plan_from_payload, t_gp.state_plan_from_payload,
                 payload)


@pytest.mark.parametrize("variant", ["model_only", "two_pass"])
def test_graph_plan_into_apply_lora_plan_matches_jax(variant):
    """The port's plan applied by the port's ``apply_lora_plan`` on the
    CPU against the JAX chain of tests/test_lora_merge.py, at
    ``test_merge_lora``'s tolerance: 1e-5 times the larger of 1 and the
    merged weight's largest magnitude."""
    rng = np.random.default_rng(70)
    names = [f"style_{n}.safetensors" for n in range(4)]
    payload = cs.seeded_lora_payload(71, 4, names)
    payload.update({"variant": variant, "strength_1": 0.8,
                    "strength_2": -0.4, "strength_3": 1.3,
                    "ltx_two_pass_mode": True})
    plan = t_gp.lora_plan_from_payload(payload)
    assert plan == j_gp.lora_plan_from_payload(payload)
    assert not plan["passthrough"] and len(plan["first_pass"]) == 4
    params = {"linear": rng.standard_normal((64, 48)).astype(np.float32),
              "conv": rng.standard_normal((8, 3, 3, 3)).astype(np.float32)}
    loras = {name: {"linear": _lora(80 + n, 8, (64,), (48,), 4.0),
                    "conv": _lora(90 + n, 8, (8,), (3, 3, 3), None)}
             for n, name in enumerate(names)}
    got = t_lora.apply_lora_plan(
        {k: torch.from_numpy(v) for k, v in params.items()}, plan,
        loras.__getitem__)
    want = j_lora.apply_lora_plan(
        {k: jnp.asarray(v) for k, v in params.items()},
        j_gp.lora_plan_from_payload(payload), loras.__getitem__)
    for key in ("first_pass", "second_pass"):
        for name in params:
            ours, theirs = got[key][name].numpy(), np.asarray(
                want[key][name])
            scale = max(1.0, float(np.max(np.abs(theirs))))
            assert float(np.max(np.abs(ours - theirs))) <= 1e-5 * scale
    passthrough = t_gp.multi_lora_plan({"use_custom_loras": False})
    same_params = t_lora.apply_lora_plan(params, passthrough, None)
    assert same_params["first_pass"] == params


# --------------------------------------------------------------------------
# the 14 routes, on the JAX app and the port's
# --------------------------------------------------------------------------

def test_lyrics_and_llm_batch_routes_agree(pair):
    clients, tmp = pair
    song = cs.seeded_song(31, lines=10, seconds=40.0)
    asr, duration = song["asr"]["segments"], song["asr"]["duration"]
    for mode in ("whisper_chunks", "reference_lines", "exact_reference_lines",
                 "reference_stanzas", "reference_scene_words"):
        (status, body), _ = both(
            clients, tmp, "POST", "/vrgdg/lyrics/timestamped",
            json_body={"segments": asr, "reference_lyrics": song["reference"],
                       "segment_mode": mode,
                       "include_instrumental_gaps": mode != "reference_lines"})
        assert status == 200 and body["segment_count"] > 0
    (_, body), _ = both(clients, tmp, "POST", "/vrgdg/lyrics/sheet",
                        json_body={"segments": asr,
                                   "srt_text": cs.scene_srt(duration, 10),
                                   "reference_lyrics": song["reference"],
                                   "backup_segments": song["backup"]
                                   ["segments"], "native_align": True})
    assert len(body["texts"]) == 10
    (_, body), _ = both(clients, tmp, "POST", "/vrgdg/lyrics/sheet",
                        json_body={"segments": asr,
                                   "windows": [[0, 4], [4, 9.5]]})
    assert body["windows"] == [[0, 4], [4, 9.5]]

    groups = cs.seeded_story_groups(32, 12)
    for index in range(3):
        (_, plan), _ = both(clients, tmp, "POST", "/vrgdg/llm_batches/plan",
                            json_body={"story_groups": groups,
                                       "story_summary": "s",
                                       "batch_size": 5})
        folder = "{base}/llm_batches/" + os.path.basename(plan["folder"])
        both(clients, tmp, "POST", "/vrgdg/llm_batches/save",
             json_body={"folder": folder, "batch_index": index,
                        "text": cs.seeded_llm_reply(32, index, 5)})
    assert plan["is_final"]
    (_, combined), _ = both(clients, tmp, "POST",
                            "/vrgdg/llm_batches/combine",
                            json_body={"folder": folder})
    assert combined["count"] == 15
    (_, split), _ = both(clients, tmp, "POST", "/vrgdg/llm_batches/split",
                         json_body={"text": cs.damaged_prompt_json(
                             combined["text"]), "index": 0})
    assert split["prompts"][0]
    name = os.path.basename(combined["path"])
    (_, state), _ = both(clients, tmp, "GET",
                         "/vrgdg/llm_batches/combined_files",
                         params={"batch_type": "Text2Image"})
    assert state["files"] == [name]
    (_, values), _ = both(
        clients, tmp, "GET", "/vrgdg/llm_batches/combined_file_prompt_values",
        params={"combined_json_file": name})
    assert values["prompt_count"] == 15
    (_, edit), _ = both(
        clients, tmp, "POST",
        "/vrgdg/llm_batches/combined_file_update_prompts",
        json_body={"remake_mode": True, "combined_json_file": name,
                   "updates": [{"prompt_number": 7, "prompt": "dusk",
                                "image_index": "2, 3"}]})
    assert edit["updated"] >= 1
    for side in ("jax", "port"):
        os.makedirs(tmp / side / "clips" / "remake")
        open(tmp / side / "clips" / "remake" / "video_4_a.mp4", "wb").close()
    (_, remake), _ = both(clients, tmp, "POST",
                          "/vrgdg/llm_batches/remake_prompt_indexes",
                          json_body={"folder_path": "{base}/clips"})
    assert remake["prompt_numbers"] == [4]
    # refusals: the same status and message on both
    for route, body in (("save", {"folder": "{base}", "batch_index": 0}),
                        ("save", {"folder": str(tmp), "batch_index": 0}),
                        ("combine", {"folder": "{base}/../elsewhere"}),
                        ("save", {"folder": folder}),
                        ("combined_file_update_prompts",
                         {"remake_mode": True}),
                        ("remake_prompt_indexes", {"folder_path": ""})):
        (status, answer), _ = both(clients, tmp, "POST",
                                   "/vrgdg/llm_batches/" + route,
                                   json_body=body)
        assert status == 400 and not answer["ok"]
    (_, answer), _ = both(clients, tmp, "POST", "/vrgdg/llm_batches/save",
                          json_body={"folder": str(tmp), "batch_index": 0})
    assert answer["error"] == \
        "folder must live under the managed llm_batches root"
    # the trees the two servers wrote
    trees = [_canon(_tree(str(tmp / side)), str(tmp / side))
             for side in ("jax", "port")]
    assert sorted(trees[0]) == sorted(trees[1])
    assert not _differences(trees[1], trees[0])


def test_text_picker_and_graph_routes_agree(pair, tmp_path):
    clients, tmp = pair
    items = cs.seeded_picker_items(33, 60)
    for mode in j_tp.SELECTION_MODES:
        (_, body), _ = both(clients, tmp, "POST", "/vrgdg/text_tools/pick",
                            json_body={"index": 41, "items": items,
                                       "selection_mode": mode, "seed": 3,
                                       "pick_count": 2, "label": "Shot"})
        assert body["result"]["item_count"] == 60
    both(clients, tmp, "POST", "/vrgdg/text_tools/pick", json_body={})
    (_, body), _ = both(clients, tmp, "POST", "/vrgdg/text_tools/multi_pick",
                        json_body={"pickers": [{"items": items, "index": 2},
                                               {"preset": "Weather"}],
                                   "joiner": "comma"})
    assert body["result"]["combined_formatted_text"]
    names = [f"style_{n}.safetensors" for n in range(8)]
    for payload in (cs.seeded_lora_payload(34, 8, names),
                    {**cs.seeded_lora_payload(35, 3, names),
                     "variant": "model_only", "ltx_two_pass_mode": "true"},
                    {"variant": "path", "lora_path": str(tmp_path / "x.pt")},
                    {}):
        both(clients, tmp, "POST", "/vrgdg/graph/lora_plan",
             json_body=payload)
    for payload in (cs.seeded_state_payload(36),
                    {"mode": "mute", "node_ids": "4,5", "set_state": "false",
                     "off_mode": "bypass"}, {}):
        (_, body), _ = both(clients, tmp, "POST", "/vrgdg/graph/state_plan",
                            json_body=payload)
        assert body["ok"]


# --------------------------------------------------------------------------
# the lyrics, llm-batch and graph commands
# --------------------------------------------------------------------------

def _printed(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def test_commands_print_what_the_jax_cli_prints(tmp_path, capsys):
    media = cs.text_media(str(tmp_path / "media"), seed=40)
    files = media["files"]
    outs = {}
    for name, main in (("jax", j_cli.main), ("port", t_cli.main)):
        base = str(tmp_path / name)
        os.makedirs(base)
        root = os.path.join(base, "llm_batches")
        steps = [_printed(main, ["lyrics", files["asr"], "--reference",
                                 files["reference"], "--segment-mode", mode],
                          capsys)
                 for mode in ("whisper_chunks", "reference_stanzas")]
        steps.append(_printed(main, ["lyrics", files["asr"],
                                     "--no-instrumental-gaps", "--min-gap",
                                     "0.5", "--max-scene", "6",
                                     "--duration", "300", "-o",
                                     os.path.join(base, "t.json")], capsys))
        steps.append(_printed(main, ["lyrics", files["asr"], "--reference",
                                     files["reference"], "--sheet-srt",
                                     files["srt"], "--backup",
                                     files["backup"], "--native-align"],
                              capsys))
        steps.append(_printed(main, ["lyrics", files["asr"], "--sheet-srt",
                                     files["srt"], "-o",
                                     os.path.join(base, "sheet.txt")],
                              capsys))
        plan = _printed(main, ["llm-batch", "plan", root, "--groups",
                               files["groups"], "--summary", "s",
                               "--batch-size", "25"], capsys)
        folder = json.loads(plan)["folder"]
        steps.append(plan)
        steps.append(_printed(main, ["llm-batch", "save", folder, "--index",
                                     "0", "--text", files["reply"]], capsys))
        combined = _printed(main, ["llm-batch", "combine", folder], capsys)
        steps.append(combined)
        steps.append(_printed(main, ["llm-batch", "split",
                                     json.loads(combined)["path"], "--index",
                                     "2", "--folder",
                                     os.path.join(base, "split")], capsys))
        steps.append(_printed(main, ["graph", "lora-plan", "--payload",
                                     json.dumps(media["lora"])], capsys))
        steps.append(_printed(main, ["graph", "state-plan", "--payload",
                                     "@" + files["state"], "-o",
                                     os.path.join(base, "plan.json")],
                              capsys))
        steps.append(_printed(main, ["graph", "state-plan"], capsys))
        outs[name] = ([step.replace(base, "<base>") for step in steps],
                      _canon(_tree(base), base))
    assert outs["port"][0] == outs["jax"][0]
    assert not _differences(outs["port"][1], outs["jax"][1])
    assert json.loads(outs["port"][0][0])["segment_count"] > 0
    with pytest.raises(SystemExit, match="--groups"):
        t_cli.main(["llm-batch", "plan", str(tmp_path / "x")])
    with pytest.raises(SystemExit, match="--index and --text"):
        t_cli.main(["llm-batch", "save", str(tmp_path / "x")])


def _subcommands(main):
    """``{command: sorted option strings}`` of a CLI's parser."""
    found = {}
    real = argparse.ArgumentParser.parse_args

    def capture(parser, argv=None, namespace=None):
        for action in parser._actions:
            if isinstance(action, argparse._SubParsersAction):
                found.update({name: sorted(option for sub in [choice]
                                           for act in sub._actions
                                           for option in act.option_strings)
                              for name, choice in action.choices.items()})
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return found


def test_cli_subcommands_equal_the_jax_clis():
    """Every command of ``vrgdg_tpu.cli`` exists in the port's CLI; the
    three added here take the same flags (the device commands add
    ``--device``)."""
    ours, theirs = _subcommands(t_cli.main), _subcommands(j_cli.main)
    assert sorted(ours) == sorted(theirs)
    for command in ("lyrics", "llm-batch", "graph", "builder", "humo",
                    "workflow"):
        assert ours[command] == theirs[command], command
    for command in theirs:
        assert set(theirs[command]) <= set(ours[command]), command


# --------------------------------------------------------------------------
# the LUT examples tool
# --------------------------------------------------------------------------

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_lut_examples",
        os.path.join(REPO, "tools", "generate_lut_examples.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# uint8 values (of 18 x 270 x 480 x 3) that differ between the port's CPU
# grade and JAX's, each at a rounding boundary (counted on the CPU)
LUT_BOUNDARY_VALUES = 6


def test_lut_examples_tool_matches_jax(tmp_path):
    """For every bundled LUT the port's graded frame (on the CPU) is within
    the LUT tolerance, 1e-5, of JAX's ``apply_lut``; the quantized frames
    are equal except where the two floats straddle a multiple of 1/255
    (``LUT_BOUNDARY_VALUES`` such values over the 18 LUTs).  The JPEG bytes
    are not compared: cv2's encoder is not Pillow's.  The tool writes only
    into the folder it is given; ``LUTS/examples`` stays as it is."""
    from vrgdg_tpu.core.cube import GLOBAL_LUT_CACHE
    from vrgdg_tpu.ops.lut import apply_lut
    from vrgdg_tpu_torch.tools import generate_lut_examples as gle

    import cv2

    jax_tool = _jax_tool()
    assert gle.test_frame.__code__.co_code == \
        jax_tool.test_frame.__code__.co_code
    np.testing.assert_array_equal(gle.test_frame(), jax_tool.test_frame())
    examples = os.path.join(REPO, "LUTS", "examples")
    before = {name: os.stat(os.path.join(examples, name)).st_mtime_ns
              for name in os.listdir(examples)}
    graded = gle.grade_examples(device="cpu")
    assert len(graded) == 18
    frame = jnp.asarray(jax_tool.test_frame()[None])
    boundary = 0
    for name, ours in graded.items():
        lut = GLOBAL_LUT_CACHE.load(os.path.join(REPO, "LUTS", name))
        theirs = np.asarray(apply_lut(frame, lut, strength=10.0))[0]
        assert float(np.abs(ours - theirs).max()) <= 1e-5, name
        apart = gle.quantize(ours) != np.clip(theirs * 255.0, 0, 255) \
            .astype(np.uint8)
        low = np.minimum(ours, theirs)[apart] * 255.0
        high = np.maximum(ours, theirs)[apart] * 255.0
        assert np.all(np.floor(low) < np.floor(high)), name
        boundary += int(apart.sum())
    assert boundary == LUT_BOUNDARY_VALUES
    written = gle.write_examples(graded, str(tmp_path / "out"))
    assert sorted(os.path.basename(p) for p in written) == sorted(before)
    for path in written:
        assert cv2.imread(path).shape == (gle.HEIGHT, gle.WIDTH, 3)
    assert gle.main([str(tmp_path / "cli"), "--device", "cpu"]) == 0
    assert len(os.listdir(tmp_path / "cli")) == 18
    assert {name: os.stat(os.path.join(examples, name)).st_mtime_ns
            for name in os.listdir(examples)} == before


def test_lut_examples_tool_refuses_a_missing_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs none")
    with pytest.raises(SystemExit) as stop:
        from vrgdg_tpu_torch.tools import generate_lut_examples as gle

        gle.main([str(tmp_path / "out")])
    assert stop.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")
