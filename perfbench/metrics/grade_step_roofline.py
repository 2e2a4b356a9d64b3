"""grade_step_roofline: the least time the card could take for a graded
frame over the time it is busy with one (the profiler's union of device
intervals over the profiled clips' real frames).

The least time is the work's own bytes at the card's peak bandwidth: a
uint8 RGB frame in and one out, 6 bytes a pixel, whatever implements it;
the LUT (0.86 MB for 33^3, read once a batch) and the per-frame statistics
are left out.  The stack's arithmetic is left out too: its count depends
on how the math is written, so the share bounds the data movement alone.
"""

BYTES_PER_PIXEL = 6


def step_bytes(height: int, width: int) -> int:
    return BYTES_PER_PIXEL * height * width


def read(run):
    trace, peaks = run.trace, run.peaks
    if (trace is None or not trace.frames or peaks is None
            or run.cell.config.get("entry") != "grade_stream"):
        return None
    least_s = step_bytes(*run.frame_in) / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (trace.busy_s / trace.frames)
