"""wait_ms_per_frame.enhance: wait_ms_per_frame (see wait_ms_per_frame.py) in the
enhancer's cells, where it moves enhance_fps."""

from perfbench.cells import metric_reader

read = metric_reader("wait_ms_per_frame")
