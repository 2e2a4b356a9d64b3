"""enqueue_ms_per_frame: host time in the program's batch.enqueue spans,
the enqueue of a batch's step (upload, dequantize, the effect, quantize,
the output's pinned buffer and the download, queued; its child spans
included), over the real frames the window's spans count
(perfbench/spans.py)."""

from perfbench.spans import ms_per_real_frame


def read(run):
    return ms_per_real_frame(run, "batch.enqueue")
