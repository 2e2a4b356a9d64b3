"""clarity_ms_per_frame: the device time of the window's
``grade.adjust.clarity`` spans (the clarity slider's reflect-padded box
blur and detail in ``ops.adjust.apply_adjust``), from the CUDA events each
records on the card, over the window's frames
(``perfbench/device_spans.py``).  Nothing without such a span: a program
whose adjust stage has no span of its own gives no reading."""

from perfbench.device_spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "grade.adjust.clarity")
