"""Tiny cells for the CPU tests, added as files and entries only.

:func:`tiny_root` copies ``BENCHMARK.json`` and the benchmark's data and
readers into a fresh folder, then adds to it, as new files and new entries,
a grade cell of 64 x 36 frames and an enhance cell of 256 x 144 frames
upscaled to 2560 x 1440 (the enhancer's smallest target; grain off to keep
the CPU's plain Philox out of the way).  Nothing that was copied is edited.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

from perfbench.cells import ROOT

COPIED = ("configs", "traffic", "metrics", "data", "peaks.json")
TINY_MIX = {"generator": "textured_clips", "width": 64, "height": 36,
            "lengths": [5, 9], "pool_frames": 8, "grid": [8, 6],
            "levels": [16, 235], "noise_sd": 6.0, "references": 2,
            "reference_size": [32, 18]}


def _read(path):
    with open(path, encoding="utf-8") as handle:
        return json.load(handle)


def _write(path, value):
    with open(path, "w", encoding="utf-8") as handle:
        json.dump(value, handle, indent=1)


def _add_cell(root, bench, name, config, mix):
    _write(os.path.join(root, "perfbench", "configs", name + ".json"), config)
    _write(os.path.join(root, "perfbench", "traffic", name + ".json"), mix)
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"perfbench/configs/{name}.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": name, "config": name,
                               "traffic": name, "chips": 1,
                               "why": "a CPU test"})


def make_tiny_root(folder: str) -> str:
    os.makedirs(os.path.join(folder, "perfbench"))
    for name in COPIED:
        source = os.path.join(ROOT, "perfbench", name)
        target = os.path.join(folder, "perfbench", name)
        if os.path.isdir(source):
            shutil.copytree(source, target,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(source, target)
    bench = _read(os.path.join(ROOT, "BENCHMARK.json"))
    grade = _read(os.path.join(ROOT, "perfbench", "configs",
                               "grade_flagship.json"))
    grade["batch_size"] = {"64x36": 2}
    _add_cell(folder, bench, "grade_tiny", grade, TINY_MIX)
    enhance = _read(os.path.join(ROOT, "perfbench", "configs",
                                 "enhance_4k.json"))
    enhance["settings"].update(upscale_resolution="2k", grain_enabled=False)
    _add_cell(folder, bench, "enhance_tiny", enhance,
              dict(TINY_MIX, width=256, height=144, grid=[32, 18],
                   lengths=[2, 3], references=0))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        cells = metric.get("workloads", [])
        if "grade_fused_4k" in cells:
            cells.append("grade_tiny")
        if "enhance_720p_to_4k" in cells:
            cells.append("enhance_tiny")
    _write(os.path.join(folder, "BENCHMARK.json"), bench)
    return folder


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path / "checkout"))
