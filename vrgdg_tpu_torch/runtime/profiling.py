"""Tracing and per-stage telemetry.

Counterpart of :mod:`vrgdg_tpu.runtime.profiling`:

- :func:`maybe_trace`: a no-op unless ``VRGDG_TPU_TRACE=/path/to/dir`` is
  set; then the wrapped block runs under ``torch.profiler`` (CPU, plus
  CUDA when a card is present) and a Chrome trace lands in
  ``$VRGDG_TPU_TRACE/<label>/trace.json``.  Every applier wraps its
  device loop in it.
- :class:`StageTimer`: named wall-clock accumulators behind the appliers'
  ``stage_seconds`` breakdown (decode / device / encode).
"""

from __future__ import annotations

import contextlib
import os
import time

TRACE_ENV = "VRGDG_TPU_TRACE"


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; writes ``log_dir/trace.json``."""
    import torch
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


class StageTimer:
    """Named wall-clock accumulators for a stage breakdown.

    >>> timer = StageTimer()
    >>> with timer.stage("decode"): ...
    >>> timer.seconds()  # {"decode": ...}
    """

    def __init__(self):
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
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
