"""clip_setup_ms: the mean host time of a clip's operands (the reference
image's upload and lab_statistics, grade_config and grade_effect), ended
by a synchronise, over the window's clips of a traced run."""


def read(run):
    if run.trace is None:
        return None
    times = [r.setup_ms for r in run.clips]
    if not times or any(ms is None for ms in times):
        return None
    return sum(times) / len(times)
