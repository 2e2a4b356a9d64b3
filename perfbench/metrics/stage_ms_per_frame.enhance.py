"""stage_ms_per_frame.enhance: stage_ms_per_frame (see stage_ms_per_frame.py) in the
enhancer's cells, where it moves enhance_fps."""

from perfbench.cells import metric_reader

read = metric_reader("stage_ms_per_frame")
