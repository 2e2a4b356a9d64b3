"""enqueue_ms_per_frame.enhance: enqueue_ms_per_frame (see enqueue_ms_per_frame.py) in the
enhancer's cells, where it moves enhance_fps."""

from perfbench.cells import metric_reader

read = metric_reader("enqueue_ms_per_frame")
