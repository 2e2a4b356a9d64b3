"""wait_ms_per_frame: host time in the program's batch.wait spans, the
host's wait for a batch's result (the synchronise on its last CUDA
event), over the real frames the window's spans count
(perfbench/spans.py)."""

from perfbench.spans import ms_per_real_frame


def read(run):
    return ms_per_real_frame(run, "batch.wait")
