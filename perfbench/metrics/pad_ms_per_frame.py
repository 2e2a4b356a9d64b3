"""pad_ms_per_frame: host time in the program's batch.pad spans, the tail
pad (repeating a clip's last frame up to the batch size, on the host),
over the real frames the window's spans count (perfbench/spans.py)."""

from perfbench.spans import ms_per_real_frame


def read(run):
    return ms_per_real_frame(run, "batch.pad")
