"""idle_share.enhance: idle_share (see idle_share.py) in the
enhancer's cells, where it moves enhance_fps."""

from perfbench.cells import metric_reader

read = metric_reader("idle_share")
