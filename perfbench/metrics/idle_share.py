"""idle_share: the share of the profiled sub-window in which no kernel,
copy or set ran on the device (one minus the union of their intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
