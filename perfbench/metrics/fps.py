"""fps: real frames the client received inside the window, over the
window's length (host clock)."""


def read(run):
    return sum(r.in_window for r in run.clips) / run.window_s
