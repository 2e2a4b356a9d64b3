"""lut_step_roofline: the least time the card could take for a frame of
Apply LUT over the time it is busy with one (the profiler's union of
device intervals over the profiled clips' real frames).

The least time is the step's own bytes at the card's peak bandwidth: a
uint8 RGB frame in and one out, 6 bytes a pixel, whatever implements the
LUT (a row gather, a column gather or a kernel of its own).  The LUT's
corner bundle (3.4 MB for 33^3, read from L2 once a batch) is left out,
and so is the arithmetic, whose count depends on how the lerps are
written: the share bounds the data movement alone.
"""

BYTES_PER_PIXEL = 6


def step_bytes(height: int, width: int) -> int:
    return BYTES_PER_PIXEL * height * width


def read(run):
    trace, peaks = run.trace, run.peaks
    if (trace is None or not trace.frames or peaks is None
            or run.cell.config.get("entry") != "lut_stream"):
        return None
    least_s = step_bytes(*run.frame_in) / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (trace.busy_s / trace.frames)
