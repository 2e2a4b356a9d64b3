"""Tracing and per-stage telemetry.

Counterpart of :mod:`vrgdg_tpu.runtime.profiling`:

- :func:`maybe_trace`: a no-op unless ``VRGDG_TPU_TRACE=/path/to/dir`` is
  set; then the wrapped block runs under ``torch.profiler`` (CPU, plus
  CUDA when a card is present) and a Chrome trace lands in
  ``$VRGDG_TPU_TRACE/<label>/trace.json``.  Every applier wraps its
  device loop in it.
- :func:`span`: a named range around one piece of a batch stream's work
  (:mod:`vrgdg_tpu_torch.runtime.batch_stream`'s ``batch.stage``,
  ``batch.stage_wait``, ``batch.enqueue``, ``batch.wait``) and inside the
  enqueue
  (``grade.phase1`` / ``grade.stats`` / ``grade.phase2``, the eager
  stages ``grade.lut`` / ``grade.adjust`` / ``grade.match`` /
  ``grade.sharpen`` / ``grade.grain``, the enhancer's ``enhance.step``
  on a card's uint8 batch and its torch chain's ``enhance.resample`` /
  ``enhance.sharpen`` / ``enhance.grain`` everywhere else).  A
  span records only while a ``torch.profiler`` records in this process
  (``maybe_trace`` or any other); otherwise it is one check and a shared
  no-op context.  While one records, a span opens a ``record_function``
  range named ``vrgdg.<name>``, which lands in the trace on the clock of
  the device's events, and appends a :class:`SpanRecord`
  (``perf_counter_ns`` times, the enclosing span, the stream and batch it
  belongs to, its counts) to :data:`SPANS`.  A span given a CUDA
  ``device`` also records a timing event on that device's current stream
  as it opens and as it closes; :func:`device_ms` reads the device time
  between them.  :func:`log_span` logs a record of work that ran on
  threads the profiler does not see (a batch staged ahead on native
  threads), from that work's own times.
- :class:`StageTimer`: named wall-clock accumulators behind the appliers'
  ``stage_seconds`` breakdown (decode / device / encode); each stage is
  also a span, so the batch spans nest under ``device``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

import torch

TRACE_ENV = "VRGDG_TPU_TRACE"
SPAN_PREFIX = "vrgdg."
SPAN_LOG_RECORDS = 65_536


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; writes ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(os.fspath(log_dir), "trace.json"))


@contextlib.contextmanager
def maybe_trace(label: str = ""):
    """Trace into ``$VRGDG_TPU_TRACE/<label>`` when the env var is set,
    no-op otherwise."""
    root = os.environ.get(TRACE_ENV, "").strip()
    if not root:
        yield None
        return
    target = os.path.join(root, label) if label else root
    os.makedirs(target, exist_ok=True)
    with trace(target):
        yield target


@dataclass(frozen=True)
class SpanRecord:
    """One closed span.  ``parent`` is the ``id`` of the span that enclosed
    it on its thread when it opened; ``stream`` numbers a call of a batch
    stream and ``batch`` a batch in it (both taken from the enclosing span
    when not given); ``counts`` are the integers given to :func:`span`;
    ``events`` the opening and closing CUDA events of a span given a CUDA
    ``device``, else ``None``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    stream: int | None
    batch: int | None
    counts: dict
    events: tuple | None = None


class SpanLog(deque):
    """A bounded log of :class:`SpanRecord`: at its bound the oldest record
    goes, and ``dropped`` counts those that went."""

    def __init__(self, maxlen: int = SPAN_LOG_RECORDS):
        super().__init__(maxlen=maxlen)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self) == self.maxlen:
                self.dropped += 1
            self.append(record)


SPANS = SpanLog()
_ids = itertools.count(1)
_streams = itertools.count(1)
_open = threading.local()       # .stack: the thread's open spans
_OFF = contextlib.nullcontext()


def next_stream() -> int:
    """A fresh ``stream`` number for one call of a batch stream."""
    return next(_streams)


class _Span:
    __slots__ = ("name", "stream", "batch", "counts", "id", "parent",
                 "start_ns", "_range", "_stack", "events", "_cuda")

    def __init__(self, name, stream, batch, counts, device):
        self.name, self.stream, self.batch = name, stream, batch
        self.counts = counts
        self.events = self._cuda = None
        if device is not None and device.type == "cuda":
            self._cuda = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if outer is not None:
            if self.stream is None:
                self.stream = outer.stream
            if self.batch is None:
                self.batch = outer.batch
        self.id = next(_ids)
        self._stack = stack
        stack.append(self)
        self._range = torch.autograd.profiler.record_function(
            SPAN_PREFIX + self.name)
        self._range.__enter__()
        if self.events is not None:
            self.events[0].record(self._cuda)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self._cuda)
        self._range.__exit__(*exc)
        # a span held open across a generator's yield can close after spans
        # its consumer opened later: take out this one, not the newest
        stack = self._stack
        for index in range(len(stack) - 1, -1, -1):
            if stack[index] is self:
                del stack[index]
                break
        SPANS.add(SpanRecord(self.id, self.name, self.start_ns, end_ns,
                             self.parent, self.stream, self.batch,
                             self.counts, self.events))
        return False


def span(name: str, stream: int | None = None, batch: int | None = None,
         *, device: torch.device | None = None, **counts: int):
    """A context that records ``name`` while a profiler records, and does
    nothing else otherwise (see the module's docstring); on a CUDA
    ``device`` the record also carries a pair of timing events."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, stream, batch, counts, device)


def log_span(name: str, start_ns: int, end_ns: int,
             stream: int | None = None, batch: int | None = None,
             **counts: int) -> None:
    """While a profiler records on this thread, log a :class:`SpanRecord`
    of work that ran off this thread, on threads the profiler does not
    see, from ``start_ns`` to ``end_ns`` (``time.perf_counter_ns``'s
    clock); it has no parent and no range in the trace."""
    if torch.autograd._profiler_enabled():
        SPANS.add(SpanRecord(next(_ids), name, start_ns, end_ns, None,
                             stream, batch, counts))


def device_ms(record: SpanRecord) -> float | None:
    """The device time between a record's two CUDA events, in ms (waits
    for the closing one), or ``None`` for a record without events."""
    if record.events is None:
        return None
    start, end = record.events
    end.synchronize()
    return start.elapsed_time(end)


class StageTimer:
    """Named wall-clock accumulators for a stage breakdown; each stage is
    also a :func:`span` of the same name.

    >>> timer = StageTimer()
    >>> with timer.stage("decode"): ...
    >>> timer.seconds()  # {"decode": ...}
    """

    def __init__(self):
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, stream: int | None = None,
              batch: int | None = None):
        start = time.perf_counter()
        try:
            with span(name, stream, batch):
                yield
        finally:
            elapsed = time.perf_counter() - start
            self._totals[name] = self._totals.get(name, 0.0) + elapsed
            self._counts[name] = self._counts.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + float(seconds)
        self._counts[name] = self._counts.get(name, 0) + 1

    def seconds(self) -> dict[str, float]:
        return {name: round(total, 6) for name, total in self._totals.items()}

    def counts(self) -> dict[str, int]:
        return dict(self._counts)
