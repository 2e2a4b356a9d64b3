"""copy_ms_per_frame: device time of host<->device copies (the profiler's
Memcpy HtoD and DtoH) over the real frames of the profiled clips."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    return run.trace.copy_s * 1e3 / run.trace.frames
