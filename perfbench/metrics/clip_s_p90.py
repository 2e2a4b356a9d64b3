"""clip_s_p90: the 90th percentile (inclusive quantiles) of every clip's
turnaround in the window, from the clip's first call into the program to
its last frame received (host clock); clips that close after the window
count too."""

import statistics


def read(run):
    turnaround = [r.end - r.start for r in run.clips]
    if len(turnaround) < 2:
        return None
    return statistics.quantiles(turnaround, n=10, method="inclusive")[-1]
