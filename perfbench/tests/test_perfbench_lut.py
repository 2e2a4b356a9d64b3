"""The Apply LUT cell on the CPU: a tiny ``lut_apply`` cell (the repo's
configuration at 64 x 36) runs end to end through the harness, is
``correct`` against the float64 reference, and reports ``fps`` and
``clip_s_p90``; traced, ``lut_ms_per_frame`` reads nothing (no span of
the CPU carries CUDA events) and the stream's host spans read.  The
readers of the two new metrics are also held to a hand-written span log."""

import json
import os
import time

import pytest

from perfbench import cells, run
from perfbench.cells import metric_reader
from perfbench.run import ClipRecord, Run
from perfbench.tests.conftest import TINY_MIX, _add_cell, _read, _write
from perfbench.trace import TraceSummary
from perfbench.traffic.textured_clips import Clip


@pytest.fixture
def lut_root(tiny_root):
    """The tiny checkout plus ``lut_tiny``: ``lut_apply`` on 64 x 36 clips
    of 5 and 9 frames, in every metric list that names ``lut_apply_1080p``."""
    path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = _read(path)
    config = _read(os.path.join(tiny_root, "perfbench", "configs",
                                "lut_apply.json"))
    _add_cell(tiny_root, bench, "lut_tiny", config,
              dict(TINY_MIX, references=0))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "lut_apply_1080p" in metric.get("workloads", []):
            metric["workloads"].append("lut_tiny")
    _write(path, bench)
    return tiny_root


def test_tiny_lut_cell_is_correct_and_reports(lut_root):
    cell = cells.load_cell("lut_tiny", lut_root)
    assert cell.config["entry"] == "lut_stream"
    result, lines = run.run_cell(cell, 2 ** 31 + 31, 2.0, False, "cpu",
                                 time.perf_counter(), lut_root)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["checks"]) == {"worst_frame_off", "max_level_diff"}
    assert {"fps", "clip_s_p90", "setup_s"} <= set(result["metrics"])
    assert result["metrics"]["fps"]["value"] > 0


def test_traced_tiny_lut_cell(lut_root, monkeypatch):
    cell = cells.load_cell("lut_tiny", lut_root)
    assert {"lut_ms_per_frame", "lut_step_roofline", "enqueue_ms_per_frame"
            } <= {m["name"] for m in cell.per_layer}
    monkeypatch.setattr(run, "TRACE_LEAD_S", 0.0)
    result, lines = run.run_cell(cell, 2 ** 31 + 32, 0.6, True, "cpu",
                                 time.perf_counter(), lut_root)
    assert result["correct"], lines
    metrics = result["metrics"]
    # CPU spans carry no events; the CPU has no peaks.json entry
    assert "lut_ms_per_frame" not in metrics
    assert "lut_step_roofline" not in metrics
    assert metrics["enqueue_ms_per_frame"]["value"] > 0


class _Events:
    """Stands in for a span's CUDA event pair."""

    def __init__(self, ms):
        self.ms = ms


def _run_of(records, entry="lut_stream", busy_s=None, frames=0):
    clip = Clip(index=0, length=9, offset=0, reference=-1)
    trace = None
    if busy_s is not None:
        trace = TraceSummary(window_s=1.0, busy_s=busy_s, copy_s=0.0,
                             device_ops=[], idle_gaps=[], frames=frames)
    cell = cells.Cell(name="c", chips=1, config={"entry": entry},
                      traffic={}, end_to_end=[], per_layer=[])
    return Run(cell=cell, setup_s=1.0, window_s=40.0,
               clips=[ClipRecord(clip=clip, start=1.0, end=2.0, frames=9)],
               frame_in=(1080, 1920), frame_out=(1080, 1920),
               peaks={"hbm_bytes_per_s": 3.35e12}, trace=trace)


def test_lut_ms_per_frame_arithmetic(monkeypatch):
    from vrgdg_tpu_torch.runtime import profiling
    from vrgdg_tpu_torch.runtime.profiling import SpanRecord

    log = profiling.SpanLog()
    monkeypatch.setattr(profiling, "SPANS", log)
    monkeypatch.setattr(profiling, "device_ms", lambda record:
                        None if record.events is None else record.events.ms)
    read = metric_reader("lut_ms_per_frame")
    start = 1_000_000_000        # the window's first clip opens at 1 s
    for batch, (frames, ms) in enumerate([(8, 24.0), (1, 3.5)]):
        t = start + batch * 10_000_000
        log.add(SpanRecord(3 * batch + 1, "batch.enqueue", t, t + 5_000_000,
                           None, 1, batch, {"frames": frames}))
        log.add(SpanRecord(3 * batch + 2, "grade.lut", t + 1, t + 4_000_000,
                           3 * batch + 1, 1, batch,
                           {"frames": frames, "lut_size": 33}))
    # host spans alone: no reading
    assert read(_run_of(list(log))) is None
    log.clear()
    for batch, (frames, ms) in enumerate([(8, 24.0), (1, 3.5)]):
        t = start + batch * 10_000_000
        log.add(SpanRecord(3 * batch + 1, "batch.enqueue", t, t + 5_000_000,
                           None, 1, batch, {"frames": frames}))
        log.add(SpanRecord(3 * batch + 2, "grade.lut", t + 1, t + 4_000_000,
                           3 * batch + 1, 1, batch,
                           {"frames": frames, "lut_size": 33}, _Events(ms)))
    assert read(_run_of(list(log))) == pytest.approx(27.5 / 9)


def test_lut_step_roofline_arithmetic():
    read = metric_reader("lut_step_roofline")
    # 100 frames in 0.5 busy s: 5 ms a frame against 6 B x 1920 x 1080 at
    # 3.35 TB/s
    least_ms = 6 * 1920 * 1080 / 3.35e12 * 1e3
    got = read(_run_of([], busy_s=0.5, frames=100))
    assert got == pytest.approx(100.0 * least_ms / 5.0)
    assert read(_run_of([], entry="grade_stream", busy_s=0.5,
                        frames=100)) is None
    assert read(_run_of([])) is None


def test_the_repo_cell_names_its_pieces():
    cell = cells.load_cell("lut_apply_1080p")
    assert cell.config["batch_size"] == 8 and cell.config["reduced"] == []
    assert cell.traffic["width"] == 1920 and cell.chips == 1
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"fps", "clip_s_p90", "setup_s", "lut_ms_per_frame",
            "lut_step_roofline", "device_ms_per_frame", "copy_ms_per_frame",
            "idle_share", "stage_ms_per_frame", "enqueue_ms_per_frame",
            "wait_ms_per_frame"} == names
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as handle:
        assert json.load(handle)["workloads"][-1]["name"] == "lut_apply_1080p"
