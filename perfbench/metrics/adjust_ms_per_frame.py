"""adjust_ms_per_frame: the device time of the window's ``grade.adjust``
spans (the eager adjust stage of ``ops.grade.grade_prepared``), from the
CUDA events each records on the card, over the window's frames
(``perfbench/device_spans.py``).  Nothing without such a span."""

from perfbench.device_spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "grade.adjust")
