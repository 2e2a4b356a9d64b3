"""The port's eager grade stack with clarity and fine sharpen, as
``grade_video`` runs it and the benchmark's ``grade_eager_4k`` cell drives
it.

- ``api.appliers.grade_effect`` of the ``grade_eager`` configuration's
  stack through ``stream_graded_batches`` at its batch 8, on seeded random
  uint8 frames of 2 x 36 x 64 (clarity's 9-tap blur) and 1 x 7 x 5 (the
  blur shrinks to 5 taps), against the benchmark's float64 reference
  (``perfbench/reference/grade_eager.py``) within the configuration's
  limits.
- The same limits refuse the control (the reference in bfloat16) and each
  fault the stack can have in its spatial sliders: clarity left out,
  clarity's reflect pad replaced by edge padding, fine sharpen left out.
- The cell resolves from ``BENCHMARK.json``, and its two adjust metrics
  read the device time of the spans they name.
- The adjust stage's spans: under a profiler each ``grade.adjust`` holds
  ``grade.adjust.tone``, ``.clarity`` (counter ``kernel``), ``.sharpen``
  and ``.finish`` in order, each counting the batch's ``frames``; with the
  profiler off nothing is recorded.  On a card each also carries CUDA
  events (the ``cuda`` case, which skips here).

The limits are the configuration's own (``worst_frame_off``, the largest
share of a frame's values that differ; ``max_level_diff``, the largest
difference in levels), so these tests hold the port to what the benchmark
holds it to on the card.  They leave room for the port's float32 against
the reference's float64: a value near a level's edge can truncate one
level apart, and colour match's cube roots and the blurs' sums move values
by a few float32 ulps.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import cells, device_spans
from perfbench.reference import grade_eager
from perfbench.run import frame_numbers
from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.ops import adjust as adjust_ops
from vrgdg_tpu_torch.ops.color_match import lab_statistics
from vrgdg_tpu_torch.runtime import profiling
from vrgdg_tpu_torch.runtime.profiling import SPANS, SpanRecord, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "perfbench", "configs", "grade_eager.json")
SHAPES = [(2, 36, 64), (1, 7, 5)]
STAGES = ["grade.adjust.tone", "grade.adjust.clarity", "grade.adjust.sharpen",
          "grade.adjust.finish"]


def _config() -> dict:
    with open(CONFIG_PATH, encoding="utf-8") as handle:
        return json.load(handle)


def _frames(shape) -> np.ndarray:
    seed = 7 + shape[1]
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3),
                                                np.uint8)


def _reference_image() -> np.ndarray:
    """A seeded float32 colour-match reference, as the cell's traffic
    hands it over: ``(1, h, w, 3)`` in [0, 1]."""
    rng = np.random.default_rng(31)
    return rng.integers(0, 256, (1, 18, 32, 3)).astype(np.float32) / \
        np.float32(255.0)


def _stream(frames: np.ndarray, device="cpu") -> np.ndarray:
    """The frames through the configuration's stack, as the cell's entry
    (``perfbench/entries/grade_stream.py``) runs it."""
    config, s = _config(), _config()["stack"]
    lut = appliers.GLOBAL_LUT_CACHE.load(os.path.join(REPO, s["lut"]))
    ref_stats = lab_statistics(torch.from_numpy(_reference_image()).to(device))
    grade_config = appliers.grade_config(
        lut=lut, lut_strength=s["lut_strength"], adjust=s["adjust"],
        ref_stats=ref_stats, match_strength=s["match_strength"],
        sharpen_strength=s["sharpen_strength"], sharpen_kind=s["sharpen_kind"],
        sharpen_border=s["sharpen_border"],
        grain_intensity=s["grain_intensity"],
        saturation_mix=s["saturation_mix"], seed=s["seed"],
        fused_mode=s["fused_mode"])
    effect = appliers.grade_effect(grade_config, device, lut=lut,
                                   ref_stats=ref_stats)
    batch = int(config["batch_size"]["3840x2160"])
    return np.concatenate(list(appliers.stream_graded_batches(
        [(0, frames)], effect, batch_size=batch, device=device,
        dispatch_depth=config["dispatch_depth"])))


def _reference(frames: np.ndarray, control=None):
    inputs = types.SimpleNamespace(references=[_reference_image()],
                                   pool=frames)
    return grade_eager.Reference(_config(), inputs, REPO,
                                 torch.device("cpu"), control)


def _expected(frames: np.ndarray, reference) -> list:
    clip = types.SimpleNamespace(reference=0)
    return [reference.frame(clip, index, frames[index])
            for index in range(frames.shape[0])]


def _numbers(frames: np.ndarray, got: np.ndarray) -> dict:
    return frame_numbers(zip(got, _expected(frames, _reference(frames))))


def _within(numbers) -> bool:
    return all(numbers[name] <= limit
               for name, limit in _config()["limits"].items())


@pytest.mark.parametrize("shape", SHAPES)
def test_eager_stream_matches_the_reference(shape):
    frames = _frames(shape)
    got = _stream(frames)
    assert got.shape == frames.shape
    numbers = _numbers(frames, got)
    assert _within(numbers), numbers


def test_clarity_kernel_shrinks_as_the_port_does():
    for height, width in [(36, 64), (7, 5), (2160, 3840), (4, 4), (2, 9)]:
        assert grade_eager.clarity_kernel(height, width) == \
            adjust_ops._clarity_kernel(height, width)


def _no_clarity(monkeypatch):
    monkeypatch.setattr(adjust_ops, "_clarity",
                        lambda frames, clarity, kernel, rows: rows.own(frames))


def _clarity_edge_pad(monkeypatch):
    blur = adjust_ops._box_blur

    def edge(frames, kernel, pad_mode, rows=None):
        return blur(frames, kernel, "edge" if pad_mode == "reflect"
                    else pad_mode, rows)

    monkeypatch.setattr(adjust_ops, "_box_blur", edge)


def _no_sharpen(monkeypatch):
    monkeypatch.setattr(adjust_ops, "_fine_sharpen",
                        lambda frames, sharpen, rows: rows.own(frames))


FAULTS = {"no_clarity": _no_clarity, "clarity_edge_pad": _clarity_edge_pad,
          "no_sharpen": _no_sharpen}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fault", ["control", *FAULTS])
def test_control_and_faults_fail_the_limits(monkeypatch, fault, shape):
    frames = _frames(shape)
    if fault == "control":
        lower = _reference(frames, _config()["control"])
        numbers = frame_numbers(zip(_expected(frames, lower),
                                    _expected(frames, _reference(frames))))
    else:
        FAULTS[fault](monkeypatch)
        numbers = _numbers(frames, _stream(frames))
    assert not _within(numbers), (fault, numbers)


def test_the_cell_resolves():
    cell = cells.load_cell("grade_eager_4k")
    assert cell.chips == 1 and cell.config["name"] == "grade_eager"
    assert cell.config["entry"] == "grade_stream"
    assert cell.config["reference"] == "grade_eager"
    assert cell.config["reduced"] == [] and cell.config["control"] == {
        "dtype": "bfloat16"}
    assert cell.traffic["name"] == "clips_4k"
    assert cell.config["batch_size"] == {"3840x2160": 8}
    assert cell.config["stack"]["fused_mode"] == "eager"
    assert cells.code_module("reference", "grade_eager") is grade_eager
    assert {m["name"] for m in cell.end_to_end} == {"fps", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"adjust_ms_per_frame", "clarity_ms_per_frame", "lut_ms_per_frame",
            "device_ms_per_frame", "grade_step_roofline"} <= per_layer
    assert not per_layer & {"clip_setup_ms", "pad_ms_per_frame",
                            "pad_frame_share"}
    for name in per_layer:
        assert callable(cells.metric_reader(name))


class _Event:
    """A stand-in for a timed CUDA event pair's ends."""

    def __init__(self, ms=0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _record(name, start_ms=None, end_ms=None, **counts):
    events = None if start_ms is None else (_Event(start_ms), _Event(end_ms))
    return SpanRecord(0, name, 0, 1, None, 1, 0, counts, events)


@pytest.mark.parametrize("metric,name", [
    ("adjust_ms_per_frame", "grade.adjust"),
    ("clarity_ms_per_frame", "grade.adjust.clarity")])
def test_adjust_metrics_read_their_spans_device_time(monkeypatch, metric,
                                                     name):
    read = cells.metric_reader(metric)
    records = [_record("batch.enqueue", frames=8),
               _record(name, 1.0, 5.0, frames=8),
               _record("batch.enqueue", frames=1),
               _record(name, 6.0, 6.5, frames=1),
               _record("grade.lut", 0.0, 9.0, frames=8)]
    monkeypatch.setattr(device_spans, "window_spans", lambda run: records)
    assert read(None) == pytest.approx(4.5 / 9)
    # spans without events (the CPU), or none of the name: no reading
    monkeypatch.setattr(device_spans, "window_spans", lambda run: [
        records[0], _record(name, frames=8)])
    assert read(None) is None
    monkeypatch.setattr(device_spans, "window_spans",
                        lambda run: records[:1])
    assert read(None) is None


def _spans_of(fn):
    before = {record.id for record in SPANS}
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return [record for record in SPANS if record.id not in before]


@pytest.mark.parametrize("shape,kernel", [((2, 36, 64), 9), ((1, 7, 5), 5)])
def test_each_adjust_holds_its_four_stage_spans_in_order(shape, kernel):
    records = _spans_of(lambda: _stream(_frames(shape)))
    adjusts = [r for r in records if r.name == "grade.adjust"]
    assert len(adjusts) == 1
    children = sorted((r for r in records if r.parent == adjusts[0].id),
                      key=lambda r: r.start_ns)
    assert [r.name for r in children] == STAGES
    for record in children:
        assert record.counts == ({"frames": shape[0], "kernel": kernel}
                                 if record.name == "grade.adjust.clarity"
                                 else {"frames": shape[0]})
        assert (record.stream, record.batch) == (adjusts[0].stream,
                                                 adjusts[0].batch)
        assert record.events is None and profiling.device_ms(record) is None
        assert adjusts[0].start_ns <= record.start_ns <= record.end_ns \
            <= adjusts[0].end_ns


def test_adjust_spans_record_nothing_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    assert span("grade.adjust.clarity", device=torch.device("cpu"), frames=2,
                kernel=9) is span("batch.wait")
    before = (len(SPANS), SPANS.dropped)
    _stream(_frames(SHAPES[0]))
    assert (len(SPANS), SPANS.dropped) == before


@pytest.mark.cuda
def test_adjust_stage_spans_time_the_card():
    """On a card the eager stack's output is within the configuration's
    limits of the reference (computed on the CPU), and under a profiler
    each of the four stage spans carries CUDA events whose time is
    positive; the stages together take no longer than their
    ``grade.adjust`` span (they run inside it, in order, on one stream),
    give or take the events' 0.5 us resolution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    frames = np.random.default_rng(41).integers(0, 256, (2, 270, 480, 3),
                                                np.uint8)
    assert _within(_numbers(frames, _stream(frames, device)))
    records = _spans_of(lambda: _stream(frames, device))
    adjust = [r for r in records if r.name == "grade.adjust"]
    stages = [r for r in records if r.name in STAGES]
    assert len(adjust) == 1 and [r.name for r in stages] == STAGES
    assert all(r.parent == adjust[0].id and r.events is not None
               for r in stages)
    times = {r.name: profiling.device_ms(r) for r in stages}
    assert all(ms > 0.0 for ms in times.values()), times
    total = profiling.device_ms(adjust[0])
    assert times["grade.adjust.clarity"] <= total
    assert sum(times.values()) <= total + 2e-3, (times, total)
