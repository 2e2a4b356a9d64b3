"""copy_ms_per_frame.enhance: copy_ms_per_frame (see copy_ms_per_frame.py) in the
enhancer's cells, where it moves enhance_fps."""

from perfbench.cells import metric_reader

read = metric_reader("copy_ms_per_frame")
