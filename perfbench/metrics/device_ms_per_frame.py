"""device_ms_per_frame: the program's own CUDA events (upload to the end
of download, summed over batches) over the real frames of the window's
clips."""


def read(run):
    events = [r.device_ms for r in run.clips]
    if not events or any(ms is None for ms in events):
        return None
    return sum(events) / sum(r.frames for r in run.clips)
