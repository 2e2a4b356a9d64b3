"""A new configuration, traffic mix, cell and per-layer metric come in as
new files and new entries of BENCHMARK.json: no file the benchmark has is
edited, and the harness finds them by name."""

import hashlib
import json
import os
import time

from perfbench import cells, run
from perfbench.cells import ROOT


def _digests(folder):
    out = {}
    for base, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as handle:
                out[os.path.relpath(path, folder)] = hashlib.sha256(
                    handle.read()).hexdigest()
    return out


def test_cells_of_the_repo_load():
    bench = cells.load_benchmark()
    for workload in bench["workloads"]:
        cell = cells.load_cell(workload["name"])
        assert cell.config["entry"] and cell.traffic["generator"]
        cells.code_module("entries", cell.config["entry"])
        cells.code_module("traffic", cell.traffic["generator"])
        cells.code_module("reference", cell.config["reference"])
        names = {m["name"] for m in cell.end_to_end + cell.per_layer}
        assert "setup_s" in names and {"fps", "enhance_fps"} & names
        for name in names:
            assert callable(cells.metric_reader(name))


def test_new_cell_and_metric_are_files_and_entries(tiny_root):
    copied = {"perfbench/" + path: digest for path, digest in
              _digests(os.path.join(tiny_root, "perfbench")).items()}
    with open(os.path.join(tiny_root, "perfbench", "metrics",
                           "frames_received.per_clip.py"), "w") as handle:
        handle.write('"""frames_received.per_clip: frames a clip."""\n\n\n'
                     "def read(run):\n"
                     "    return sum(r.frames for r in run.clips) / "
                     "len(run.clips)\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as handle:
        bench = json.load(handle)
    bench["end_to_end"].append({
        "name": "frames_received.per_clip", "unit": "frames",
        "better": "higher", "bound": 0.01, "source": "host_clock",
        "workloads": ["grade_tiny"]})
    with open(path, "w") as handle:
        json.dump(bench, handle)

    cell = cells.load_cell("grade_tiny", tiny_root)
    assert cell.traffic["width"] == 64 and cell.config["name"] == "grade_tiny"
    result, _ = run.run_cell(cell, 21, 0.5, False, "cpu", time.perf_counter(),
                             tiny_root)
    assert result["correct"]
    assert 5 <= result["metrics"]["frames_received.per_clip"]["value"] <= 9
    after = {"perfbench/" + path: digest for path, digest in
             _digests(os.path.join(tiny_root, "perfbench")).items()}
    assert all(after[path] == digest for path, digest in copied.items())
    # the repo's own files are the ones that were copied
    assert copied["perfbench/metrics/fps.py"] == _digests(
        os.path.join(ROOT, "perfbench", "metrics"))["fps.py"]


def test_benchmark_json_shape():
    import re

    bench = cells.load_benchmark()
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert name.fullmatch(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for config in bench["configs"]:
        assert config["file"].startswith("perfbench/")
        assert os.path.isfile(os.path.join(ROOT, config["file"]))
    for metric in bench["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for workload in bench["workloads"]:
        cell = cells.load_cell(workload["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for metric in cell.per_layer:
            assert metric["moves"] in reported, metric["name"]
    for metric in bench["per_layer"]:
        assert metric["moves"] in e2e
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
