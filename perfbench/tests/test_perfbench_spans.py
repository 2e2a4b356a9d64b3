"""The readers of the program's spans (``perfbench/spans.py`` and the
metrics that use it): their arithmetic on a hand-written span log, the
window's filter, what they give without spans or after a drop, and a
traced run of the tiny grade cell on the CPU."""

import time

import pytest

from perfbench import cells, run
from perfbench.cells import metric_reader
from perfbench.run import ClipRecord, Run
from perfbench.spans import window_spans
from perfbench.traffic.textured_clips import Clip

MS = 1_000_000      # ns
GRADE = ("pad_ms_per_frame", "stage_ms_per_frame", "enqueue_ms_per_frame",
         "wait_ms_per_frame", "pad_frame_share")
ENHANCE = ("stage_ms_per_frame.enhance", "enqueue_ms_per_frame.enhance",
           "wait_ms_per_frame.enhance")


@pytest.fixture
def log(monkeypatch):
    from vrgdg_tpu_torch.runtime import profiling

    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


def _add(log, name, start_ms, ms, batch=0, **counts):
    from vrgdg_tpu_torch.runtime.profiling import SpanRecord

    start = round(start_ms * MS)
    log.add(SpanRecord(len(log) + 1, name, start, start + round(ms * MS),
                       None, 1, batch, counts))


def _window_run(first_start_s):
    clip = Clip(index=0, length=5, offset=0, reference=0)
    return Run(cell=None, setup_s=1.0, window_s=40.0,
               clips=[ClipRecord(clip=clip, start=first_start_s,
                                 end=first_start_s + 1.0, frames=5)],
               frame_in=(36, 64), frame_out=(36, 64), peaks=None)


def _clip_of_five(log, at_ms, scale=1.0):
    """Three batches at batch size 2 (one pad frame): 5 real frames."""
    for batch in range(3):
        t = at_ms + 10 * batch
        if batch == 2:
            _add(log, "batch.pad", t, 2.0 * scale, batch, pad_frames=1)
        _add(log, "batch.stage", t + 2, 1.0 * scale, batch)
        _add(log, "batch.enqueue", t + 3, 3.0 * scale, batch, frames=2)
        _add(log, "grade.phase1", t + 3.5, 1.0, batch)
        _add(log, "batch.wait", t + 7, 0.5 * scale, batch)


def test_per_frame_arithmetic(log):
    _clip_of_five(log, 1000.0)
    window = _window_run(1.0)                 # the first clip at 1000 ms
    read = {name: metric_reader(name)(window) for name in GRADE + ENHANCE}
    assert read["pad_ms_per_frame"] == pytest.approx(2.0 / 5)
    assert read["stage_ms_per_frame"] == pytest.approx(3.0 / 5)
    assert read["enqueue_ms_per_frame"] == pytest.approx(9.0 / 5)
    assert read["wait_ms_per_frame"] == pytest.approx(1.5 / 5)
    assert read["pad_frame_share"] == pytest.approx(100.0 / 6)
    for name in ENHANCE:
        assert read[name] == read[name.split(".")[0]]


def test_window_leaves_out_a_set_up_span(log):
    _clip_of_five(log, 500.0, scale=100.0)    # set-up's profiled warm clip
    _clip_of_five(log, 1000.0)
    window = _window_run(1.0)
    assert len(window_spans(window)) == 13
    assert metric_reader("stage_ms_per_frame")(window) == pytest.approx(0.6)
    assert metric_reader("pad_frame_share")(window) == pytest.approx(
        100.0 / 6)


def test_nothing_without_spans(log):
    window = _window_run(1.0)
    assert window_spans(window) is None
    _clip_of_five(log, 500.0)                 # set-up only
    assert window_spans(window) is None
    for name in GRADE + ENHANCE:
        assert metric_reader(name)(window) is None


def test_a_missing_span_gives_nothing(log):
    _add(log, "batch.enqueue", 1000.0, 3.0, frames=1)
    window = _window_run(1.0)
    assert metric_reader("enqueue_ms_per_frame")(window) == pytest.approx(3.0)
    assert metric_reader("pad_frame_share")(window) == 0.0
    for name in ("pad_ms_per_frame", "stage_ms_per_frame",
                 "wait_ms_per_frame"):
        assert metric_reader(name)(window) is None


def test_nothing_after_a_drop(log):
    _clip_of_five(log, 1000.0)
    window = _window_run(1.0)
    assert window_spans(window)
    log.dropped = 1
    assert window_spans(window) is None
    for name in GRADE + ENHANCE:
        assert metric_reader(name)(window) is None


def test_traced_tiny_grade_cell_reports_the_pad(tiny_root, monkeypatch):
    cell = cells.load_cell("grade_tiny", tiny_root)
    assert {"pad_frame_share", "pad_ms_per_frame"} <= {
        m["name"] for m in cell.per_layer}
    # profile from the window's first clip, however slow this CPU is
    monkeypatch.setattr(run, "TRACE_LEAD_S", 0.0)
    result, lines = run.run_cell(cell, 2 ** 31 + 21, 0.6, True, "cpu",
                                 time.perf_counter(), tiny_root)
    assert result["correct"], lines
    metrics = result["metrics"]
    # clips of 5 and 9 frames at batch 2: one pad frame in 6 or in 10
    assert 100.0 / 10 <= metrics["pad_frame_share"]["value"] <= 100.0 / 6
    assert metrics["pad_frame_share"]["unit"] == "%"
    assert metrics["pad_ms_per_frame"]["value"] > 0
    assert metrics["enqueue_ms_per_frame"]["value"] > 0
