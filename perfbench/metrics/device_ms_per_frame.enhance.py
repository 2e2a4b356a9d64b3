"""device_ms_per_frame.enhance: device_ms_per_frame (see device_ms_per_frame.py) in the
enhancer's cells, where it moves enhance_fps."""

from perfbench.cells import metric_reader

read = metric_reader("device_ms_per_frame")
