"""The program's own spans of a traced run's window.

``vrgdg_tpu_torch.runtime.profiling`` logs a record of each span the
program closes while a profiler records (``SPANS``).  In a traced run the
profiler records around set-up's last warm clip and around the window's
profiled clips, so the records that start at or after the window's first
clip are exactly the profiled clips'.  A program without the log gives
nothing.
"""

from __future__ import annotations


def window_spans(run) -> list | None:
    """The window's span records; ``None`` without any, or when the log
    dropped records (it keeps the newest at its bound)."""
    try:
        from vrgdg_tpu_torch.runtime import profiling
    except ImportError:
        return None
    log = getattr(profiling, "SPANS", None)
    if log is None or log.dropped or not run.clips:
        return None
    opened = round(run.clips[0].start * 1e9)
    records = [record for record in list(log) if record.start_ns >= opened]
    return records or None


def ms_per_real_frame(run, name: str) -> float | None:
    """The summed duration of the window's ``name`` spans, in ms, over the
    real frames the spans count: the ``frames`` of ``batch.enqueue`` less
    the ``pad_frames`` of ``batch.pad``; ``None`` without a ``name`` span."""
    records = window_spans(run)
    if records is None:
        return None
    frames = pad = total_ns = spans = 0
    for record in records:
        if record.name == "batch.enqueue":
            frames += record.counts.get("frames", 0)
        elif record.name == "batch.pad":
            pad += record.counts.get("pad_frames", 0)
        if record.name == name:
            total_ns += record.end_ns - record.start_ns
            spans += 1
    if not spans or frames - pad <= 0:
        return None
    return total_ns * 1e-6 / (frames - pad)
