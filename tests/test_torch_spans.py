"""The port's program spans (``vrgdg_tpu_torch.runtime.profiling.span``)
on the CPU.

- With no profiler on, a span records nothing and never enters
  ``record_function``; a stage of ``StageTimer`` still times.
- Under ``torch.profiler`` (CPU): the ``vrgdg.<name>`` ranges, parent
  links, the ``stream`` / ``batch`` numbers taken from the enclosing span,
  the counts; a span held open across a generator's ``yield`` leaves the
  parent stack straight.
- ``stream_graded_batches`` over a 5-frame clip at batch 2: the tail
  batch runs at its real length (no ``batch.pad``), its ``batch.enqueue``
  counts the one ``short_frames`` it lacks, ``frames`` sum to 5, the
  fused grade's phases under each enqueue.
- ``enhance_batches`` over the same clip: the same rule (no ``batch.pad``,
  the tail's enqueue counts its ``short_frames``, no staging or wait on
  the CPU), the step's parts under each enqueue.
- Staging ahead (``batch_stream.look_ahead`` with a scripted stager): each
  take is a ``batch.stage_wait`` counting ``ready``, and each staging is
  logged as a ``batch.stage`` from the copy's own times
  (``profiling.log_span``, which logs only while a profiler records).  On
  a card (marked ``cuda``): both streams' ``batch.stage`` once a batch
  with their ids, before the batch's enqueue, and their
  ``batch.stage_wait``.
- ``stage_seconds`` keeps exactly its keys with the profiler on.
- The log drops its oldest records at its bound and counts them.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vrgdg_tpu_torch.api.appliers import (grade_config, grade_effect,
                                          stream_graded_batches)
from vrgdg_tpu_torch.core.cube import build_palette_lut
from vrgdg_tpu_torch.core.params import EnhancerSettings
from vrgdg_tpu_torch.jobs.enhancer import enhance_batches
from vrgdg_tpu_torch.ops.color_match import lab_statistics
from vrgdg_tpu_torch.runtime import batch_stream, profiling
from vrgdg_tpu_torch.runtime.batch_stream import InFlight, look_ahead
from vrgdg_tpu_torch.runtime.profiling import (SPANS, SpanLog, SpanRecord,
                                               StageTimer, log_span, span)

CLIP = np.random.default_rng(3).integers(0, 256, (5, 12, 20, 3), np.uint8)
BATCHES = [(0, CLIP[0:2]), (2, CLIP[2:4]), (4, CLIP[4:5])]


def _profiler(cuda: bool = False):
    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


def _recorded(fn, cuda: bool = False):
    """The span records ``fn()`` adds, and the profiler's event names."""
    before = {record.id for record in SPANS}
    with _profiler(cuda) as prof:
        fn()
    return ([record for record in SPANS if record.id not in before],
            {event.name for event in prof.events()})


def _by_name(records):
    out: dict = {}
    for record in records:
        out.setdefault(record.name, []).append(record)
    return out


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    before = (len(SPANS), SPANS.dropped)
    timer = StageTimer()
    with span("batch.pad", 1, 2, pad_frames=3) as opened:
        with timer.stage("device", 1, 2):
            pass
    assert opened is None
    assert span("batch.wait") is span("batch.enqueue", frames=2)
    out = list(stream_graded_batches(BATCHES, lambda x, i: x, batch_size=2,
                                     device="cpu"))
    assert sum(o.shape[0] for o in out) == 5
    assert (len(SPANS), SPANS.dropped) == before
    assert set(timer.seconds()) == {"device"}


def test_names_parents_ids_and_counts():
    def run():
        with span("device", 7):
            with span("batch.enqueue", batch=3, frames=4):
                with span("grade.phase1"):
                    pass
            with span("batch.wait", 7, 5):
                pass

    records, names = _recorded(run)
    by = {record.name: record for record in records}
    assert set(by) == {"device", "batch.enqueue", "grade.phase1",
                       "batch.wait"}
    assert {"vrgdg." + name for name in by} <= names
    device, enqueue = by["device"], by["batch.enqueue"]
    assert device.parent is None and (device.stream, device.batch) == (7, None)
    assert enqueue.parent == device.id and enqueue.counts == {"frames": 4}
    assert (enqueue.stream, enqueue.batch) == (7, 3)
    phase = by["grade.phase1"]
    assert phase.parent == enqueue.id and (phase.stream, phase.batch) == (7, 3)
    assert phase.counts == {}
    assert by["batch.wait"].parent == device.id
    assert (by["batch.wait"].stream, by["batch.wait"].batch) == (7, 5)
    for record in records:
        assert record.start_ns <= record.end_ns
    assert device.start_ns <= enqueue.start_ns <= phase.start_ns
    assert phase.end_ns <= enqueue.end_ns <= device.end_ns


def test_span_open_across_a_yield_keeps_the_stack_straight():
    def stream():
        with span("encode", 1):
            yield 1
        with span("decode", 1):
            yield 2

    def run():
        items = stream()
        assert next(items) == 1                 # "encode" stays open
        with span("sink", 2):                   # opened inside "encode"
            assert next(items) == 2             # "encode" closes first,
            with span("inner", 2):              # "decode" stays open
                pass
        for _ in items:
            pass
        with span("after"):
            pass

    records, _ = _recorded(run)
    by = {record.name: record for record in records}
    assert by["sink"].parent == by["encode"].id
    assert by["decode"].parent == by["sink"].id     # not the closed "encode"
    assert by["inner"].parent == by["decode"].id
    assert by["after"].parent is None
    assert profiling._open.stack == []


def _fused_effect(device="cpu"):
    lut = build_palette_lut("#0b1d51, #1f6aa5, #f3d27a", 9)
    reference = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 8, 10, 3)).astype(np.float32))
    ref_stats = lab_statistics(reference.to(device))
    config = grade_config(lut=lut, lut_strength=8, ref_stats=ref_stats,
                          match_strength=0.7, sharpen_strength=1.5,
                          grain_intensity=0.05, seed=42, fused_mode="fused")
    return grade_effect(config, device, lut=lut, ref_stats=ref_stats)


def test_grade_stream_counts_pad_and_enqueued_frames():
    """The short tail batch runs at its real length, unpadded: its enqueue
    counts the frames it lacks, and the frames come out as at batch 1."""
    fused = _fused_effect()
    lengths: list = []

    def effect(batch, frame_index):
        lengths.append(int(batch.shape[0]))
        return fused(batch, frame_index)

    timer = StageTimer()
    out: list = []
    records, names = _recorded(lambda: out.extend(stream_graded_batches(
        BATCHES, effect, batch_size=2, device="cpu", timer=timer)))
    assert lengths == [2, 2, 1]
    assert [o.shape[0] for o in out] == [2, 2, 1]
    single = list(stream_graded_batches(
        [(i, CLIP[i:i + 1]) for i in range(5)], fused, batch_size=1,
        device="cpu"))
    assert np.array_equal(np.concatenate(out), np.concatenate(single))
    by = _by_name(records)
    assert "batch.pad" not in by
    enqueue = by["batch.enqueue"]
    assert [r.batch for r in enqueue] == [0, 1, 2]
    assert [r.counts for r in enqueue] == [
        {"frames": 2}, {"frames": 2}, {"frames": 1, "short_frames": 1}]
    assert sum(r.counts["frames"] for r in enqueue) == 5
    # the CPU path has no pinned staging and no wait
    assert "batch.stage" not in by and "batch.wait" not in by
    assert len({r.stream for r in records}) == 1
    devices = {r.id for r in by["device"]}
    assert all(r.parent in devices for r in enqueue)
    enqueue_ids = {r.id: r.batch for r in enqueue}
    for name in ("grade.phase1", "grade.stats", "grade.phase2"):
        assert [enqueue_ids[r.parent] for r in by[name]] == [0, 1, 2]
        assert "vrgdg." + name in names
    assert set(timer.seconds()) == {"decode", "device", "encode"}


def test_two_streams_get_their_own_numbers():
    def run():
        for _ in range(2):
            list(stream_graded_batches(BATCHES[:1], lambda x, i: x,
                                       batch_size=2, device="cpu"))

    records, _ = _recorded(run)
    streams = [r.stream for r in records if r.name == "batch.enqueue"]
    assert len(streams) == 2 and streams[0] != streams[1]


def test_enhance_batches_records_an_enqueue_a_batch():
    settings = EnhancerSettings.normalize({
        "upscale_resolution": "2k", "sharpen_strength": 1.0,
        "grain_enabled": True, "grain_intensity": 0.05, "seed": 42})
    written: list = []
    timer = StageTimer()
    records, _ = _recorded(lambda: enhance_batches(
        BATCHES, settings, 18, 30, device="cpu", batch_size=2,
        write=written.append, timer=timer))
    assert [w.shape[0] for w in written] == [2, 2, 1]
    by = _by_name(records)
    enqueue = by["batch.enqueue"]
    assert [r.batch for r in enqueue] == [0, 1, 2]
    assert [r.counts for r in enqueue] == [
        {"frames": 2}, {"frames": 2}, {"frames": 1, "short_frames": 1}]
    assert sum(r.counts["frames"] for r in enqueue) == 5
    # the CPU path has no pad, no pinned staging and no wait
    assert not {"batch.pad", "batch.stage", "batch.wait"} & set(by)
    assert len({r.stream for r in enqueue}) == 1
    enqueue_ids = {r.id for r in enqueue}
    for name in ("enhance.resample", "enhance.sharpen", "enhance.grain"):
        assert len(by[name]) == 3
        assert all(r.parent in enqueue_ids for r in by[name])
    assert set(timer.seconds()) == {"decode", "device", "encode"}


class _Scripted:
    """A stager whose copies are ready as scripted and take known times."""

    def __init__(self, ready):
        self.ready_at = list(ready)
        self.started = 0

    def start(self, frames):
        self.frames = frames

    def ready(self):
        return self.ready_at.pop(0)

    def finish(self):
        self.started += 1
        return self.frames, 1000 * self.started, 1000 * self.started + 400

    def close(self):
        pass


def test_staging_ahead_logs_its_stage_and_stage_wait_spans(monkeypatch):
    """Each take of a batch staged ahead is a ``batch.stage_wait``
    counting ``ready``, and its staging is logged as a ``batch.stage``
    from the copy's own times, with the batch's ids and no parent (it ran
    on native threads); with the profiler off nothing is logged."""
    monkeypatch.setattr(batch_stream, "Stager", lambda threads, device:
                        _Scripted([False, True, True]))

    def run():   # a stream on a card, which nothing here touches
        in_flight = InFlight(2, None, torch.device("cuda"))
        with span("decode", in_flight.stream):
            for _ in look_ahead(BATCHES, in_flight):
                in_flight.next_ids()   # as a stream submits it

    records, names = _recorded(run)
    by = _by_name(records)
    stages, waits = by["batch.stage"], by["batch.stage_wait"]
    assert [r.batch for r in stages] == [r.batch for r in waits] == [0, 1, 2]
    assert len({r.stream for r in stages + waits}) == 1
    assert [(r.start_ns, r.end_ns) for r in stages] == [
        (1000, 1400), (2000, 2400), (3000, 3400)]
    assert all(r.parent is None and r.counts == {} for r in stages)
    assert [r.counts for r in waits] == [{"ready": 0}, {"ready": 1},
                                         {"ready": 1}]
    assert all(r.parent == by["decode"][0].id for r in waits)
    assert "vrgdg.batch.stage_wait" in names
    before = (len(SPANS), SPANS.dropped)
    run()
    assert (len(SPANS), SPANS.dropped) == before


@pytest.mark.cuda
def test_staged_ahead_streams_record_their_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    u8 = np.random.default_rng(5).integers(0, 256, (5, 40, 70, 3), np.uint8)
    batches = [(0, u8[0:2]), (2, u8[2:4]), (4, u8[4:5])]
    settings = EnhancerSettings.normalize({
        "sharpen_strength": 1.0, "grain_enabled": True,
        "grain_intensity": 0.05, "seed": 42})
    written: list = []

    def run():
        graded = list(stream_graded_batches(
            batches, _fused_effect(device), batch_size=2, device=device))
        assert sum(g.shape[0] for g in graded) == 5
        enhance_batches(batches, settings, 80, 140, device=device,
                        batch_size=2, write=written.append)

    records, names = _recorded(run, cuda=True)
    assert sum(w.shape[0] for w in written) == 5
    streams = {r.stream for r in records if r.name == "batch.enqueue"}
    assert len(streams) == 2
    for stream in streams:
        by = _by_name([r for r in records if r.stream == stream])
        for name in ("batch.stage", "batch.stage_wait", "batch.enqueue",
                     "batch.wait"):
            assert [r.batch for r in by[name]] == [0, 1, 2], name
        # staged on the worker, before the batch's enqueue opened
        assert all(r.parent is None for r in by["batch.stage"])
        for staged, enqueued in zip(by["batch.stage"], by["batch.enqueue"]):
            assert staged.end_ns <= enqueued.start_ns
        assert all(set(r.counts) == {"ready"} and r.counts["ready"] in (0, 1)
                   for r in by["batch.stage_wait"])
    assert "vrgdg.batch.stage_wait" in names


def test_log_span_logs_only_while_the_profiler_records():
    before = (len(SPANS), SPANS.dropped)
    log_span("batch.stage", 5, 9, 3, 4)
    assert (len(SPANS), SPANS.dropped) == before

    def run():
        with span("device", 3, 4):
            log_span("batch.stage", 5, 9, 3, 4)

    records, _ = _recorded(run)
    logged = [r for r in records if r.name == "batch.stage"]
    assert [(r.start_ns, r.end_ns, r.stream, r.batch, r.parent, r.counts)
            for r in logged] == [(5, 9, 3, 4, None, {})]


def test_stage_seconds_keeps_its_keys_with_the_profiler_on():
    def stream(timer):
        return list(stream_graded_batches(BATCHES, lambda x, i: x,
                                          batch_size=2, device="cpu",
                                          timer=timer))

    off, on = StageTimer(), StageTimer()
    stream(off)
    with _profiler():
        stream(on)
    assert set(on.seconds()) == set(off.seconds()) == {
        "decode", "device", "encode"}
    assert on.counts() == off.counts()


def test_log_drops_the_oldest_at_its_bound_and_counts_them():
    log = SpanLog(maxlen=3)
    for index in range(1, 6):
        log.add(SpanRecord(index, "batch.wait", index, index + 1, None, 1,
                           index, {}))
    assert [record.id for record in log] == [3, 4, 5]
    assert log.dropped == 2
    assert SPANS.maxlen == profiling.SPAN_LOG_RECORDS == 65_536


def test_a_span_records_when_its_block_raises():
    def run():
        with pytest.raises(ValueError):
            with span("batch.pad", 4, 1, pad_frames=1):
                raise ValueError("inside")

    records, _ = _recorded(run)
    assert [(r.name, r.stream, r.counts) for r in records] == [
        ("batch.pad", 4, {"pad_frames": 1})]
    assert profiling._open.stack == []
