"""Find the pieces of a cell by the names in ``BENCHMARK.json``.

A cell of ``BENCHMARK.json``'s ``workloads`` names a configuration and a
traffic mix.  The configuration's ``file`` holds the stack's settings and
names the entry (``entries/<entry>.py``) and the reference
(``reference/<reference>.py``); the mix is ``traffic/<traffic>.json`` and
names its generator (``traffic/<generator>.py``); each metric of the cell
is read by ``metrics/<metric>.py``.  Adding a cell, a configuration, a mix
or a metric adds files and entries and edits no code.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


@dataclass(frozen=True)
class Cell:
    """One cell with everything it names, read from the files."""

    name: str
    chips: int
    config: dict        # the configuration's file, plus its "name"
    traffic: dict       # the mix's file, plus its "name"
    end_to_end: list    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list     # and its per-layer ones


def checked_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as handle:
        return json.load(handle)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = dict(_read_json(os.path.join(root, entry["file"])),
                  name=entry["name"])
    traffic_name = checked_name(cell["traffic"], "traffic")
    traffic = dict(_read_json(os.path.join(root, "perfbench", "traffic",
                                           traffic_name + ".json")),
                   name=traffic_name)
    return Cell(name=name, chips=int(cell["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def code_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` for an entry, a traffic generator or
    a reference (plain module names)."""
    if kind not in ("entries", "traffic", "reference"):
        raise ValueError(f"no kind {kind!r}")
    if not isinstance(name, str) or not _MODULE.fullmatch(name):
        raise ValueError(f"bad {kind} module name {name!r}")
    return importlib.import_module(f"perfbench.{kind}.{name}")


def metric_reader(name: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<name>.py`` under ``root``;
    metric names may hold dots, so the file is loaded by its path."""
    checked_name(name, "metric")
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
