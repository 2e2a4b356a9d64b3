"""The device time of the program's stage spans in a traced run's window.

On a card a stage span of ``vrgdg_tpu_torch`` (``runtime.profiling.span``
given a CUDA ``device``) records a CUDA event as it opens and as it
closes; ``runtime.profiling.device_ms`` reads the time between them.
"""

from __future__ import annotations

from perfbench.spans import window_spans


def ms_per_frame(run, name: str) -> float | None:
    """The summed device time of the window's ``name`` spans, in ms, over
    the frames the window's ``batch.enqueue`` spans count (the stream pads
    no batch, so these are real frames); ``None`` without a ``name`` span
    that carries events, or without the program's ``device_ms``."""
    records = window_spans(run)
    if records is None:
        return None
    try:
        from vrgdg_tpu_torch.runtime.profiling import device_ms
    except ImportError:
        return None
    frames, total_ms, spans = 0, 0.0, 0
    for record in records:
        if record.name == "batch.enqueue":
            frames += record.counts.get("frames", 0)
        elif record.name == name and record.events is not None:
            total_ms += device_ms(record)
            spans += 1
    if not spans or frames <= 0:
        return None
    return total_ms / frames
