"""The arithmetic of the readers: union and gaps of device intervals, the
host op behind each gap, the idle share, the rooflines and the p90."""

import statistics

import pytest

from perfbench import trace as tracing
from perfbench.cells import metric_reader
from perfbench.run import ClipRecord, Run
from perfbench.traffic.textured_clips import Clip

H100 = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def test_merge_and_gaps():
    merged = tracing.merge([(5, 7), (0, 2), (1, 3), (7, 8), (10, 12)])
    assert merged == [(0, 3), (5, 8), (10, 12)]
    assert tracing.gaps(merged, 0, 15) == [(3, 5), (8, 10), (12, 15)]
    assert tracing.gaps(merged, 1, 11) == [(3, 5), (8, 10)]
    assert tracing.gaps([], 2, 4) == [(2, 4)]


def test_innermost_host_op():
    host = [("outer", "host", 0, 100), ("copy", "host", 10, 20),
            ("wait", "host", 50, 90), ("inner", "host", 60, 70)]
    assert tracing.innermost(host, [15, 55, 65, 95, 150]) == \
        ["copy", "wait", "inner", "outer", None]


def test_summarize_a_window():
    events = [
        (tracing.SPAN, "host", 100.0, 1100.0),
        ("next", "host", 100.0, 400.0),
        ("aten::copy_", "host", 500.0, 700.0),
        ("Memcpy HtoD (Pinned -> Device)", "device", 150.0, 350.0),
        ("grade_phase1", "device", 300.0, 450.0),
        ("Memcpy DtoH (Device -> Pinned)", "device", 800.0, 900.0),
        ("Memset (Device)", "device", 1000.0, 1300.0),   # cut at the span
        ("grade_phase2", "device", 0.0, 50.0),           # before the span
    ]
    summary = tracing.summarize(events)
    assert summary.window_s == pytest.approx(1000e-6)
    # busy: 150-450, 800-900, 1000-1100
    assert summary.busy_s == pytest.approx(500e-6)
    assert summary.copy_s == pytest.approx(300e-6)
    assert summary.device_ops[0] == ["Memcpy HtoD (Pinned -> Device)",
                                     pytest.approx(200e-6)]
    # gaps: 100-150 (next), 450-800 (middle 625: aten::copy_), 900-1000
    # (middle 950: only the span)
    assert dict((name, s) for name, s in summary.idle_gaps) == {
        "aten::copy_": pytest.approx(350e-6), "next": pytest.approx(50e-6),
        tracing.SPAN: pytest.approx(100e-6)}


def test_summarize_needs_a_span_and_device_work():
    assert tracing.summarize([("x", "device", 0, 1)]) is None
    assert tracing.summarize([(tracing.SPAN, "host", 0, 1)]) is None


class _Cell:
    def __init__(self, entry):
        self.config = {"entry": entry}


def _run(entry, frame_in, frame_out, trace=None, clips=()):
    return Run(cell=_Cell(entry), setup_s=12.5, window_s=40.0,
               clips=list(clips), frame_in=frame_in, frame_out=frame_out,
               peaks=H100, trace=trace)


def _summary(busy_s, window_s, copy_s, frames):
    return tracing.TraceSummary(window_s=window_s, busy_s=busy_s,
                                copy_s=copy_s, device_ops=[], idle_gaps=[],
                                frames=frames, clips=3)


def test_grade_roofline_counts_six_bytes_a_pixel():
    run = _run("grade_stream", (2160, 3840), (2160, 3840),
               _summary(busy_s=1.5, window_s=3.0, copy_s=0.9, frames=1000))
    least = 6 * 2160 * 3840 / 3.35e12               # 14.86 us a frame
    assert metric_reader("grade_step_roofline")(run) == \
        pytest.approx(100 * least / 1.5e-3)
    assert metric_reader("enhance_step_roofline")(run) is None
    assert metric_reader("idle_share")(run) == pytest.approx(50.0)
    assert metric_reader("copy_ms_per_frame")(run) == pytest.approx(0.9)


def test_enhance_roofline_takes_the_larger_term():
    run = _run("enhance_stream", (720, 1280), (2160, 3840),
               _summary(busy_s=3.0, window_s=3.1, copy_s=0.5, frames=1000))
    flops = 2 * 8 * 3 * (2160 * 1280 + 2160 * 3840)  # 0.53 GFLOP
    nbytes = 3 * (720 * 1280 + 2160 * 3840)          # 27.6 MB
    assert flops == 530_841_600 and nbytes == 27_648_000
    least = max(nbytes / 3.35e12, flops / 67e12)     # bytes: 8.25 us
    assert least == nbytes / 3.35e12
    assert metric_reader("enhance_step_roofline")(run) == \
        pytest.approx(100 * least / 3e-3)
    assert metric_reader("grade_step_roofline")(run) is None


def test_readers_without_a_trace_give_nothing():
    run = _run("grade_stream", (36, 64), (36, 64))
    for name in ("idle_share", "copy_ms_per_frame", "grade_step_roofline",
                 "clip_setup_ms"):
        assert metric_reader(name)(run) is None


def test_end_to_end_readers():
    clips = []
    for k, seconds in enumerate([0.2, 0.4, 0.1, 0.3, 0.5, 0.25, 0.35, 0.45,
                                 0.15, 0.6, 0.05, 0.55]):
        clips.append(ClipRecord(clip=Clip(k, 10, 0, 0), start=k,
                                end=k + seconds, frames=10,
                                in_window=10 if k < 11 else 4,
                                setup_ms=2.0 + k, device_ms=5.0))
    run = _run("grade_stream", (36, 64), (36, 64),
               _summary(1.0, 2.0, 0.1, 20), clips)
    assert metric_reader("fps")(run) == pytest.approx(114 / 40.0)
    turnaround = [c.end - c.start for c in clips]
    p90 = statistics.quantiles(turnaround, n=10, method="inclusive")[-1]
    assert metric_reader("clip_s_p90")(run) == pytest.approx(p90)
    assert 0.5 < p90 < 0.6
    assert metric_reader("setup_s")(run) == 12.5
    assert metric_reader("device_ms_per_frame")(run) == pytest.approx(0.5)
    assert metric_reader("clip_setup_ms")(run) == pytest.approx(7.5)
