"""stage_ms_per_frame: host time in the program's batch.stage spans, the
pinned staging (the input's pinned buffer and the host copy into it),
over the real frames the window's spans count (perfbench/spans.py)."""

from perfbench.spans import ms_per_real_frame


def read(run):
    return ms_per_real_frame(run, "batch.stage")
