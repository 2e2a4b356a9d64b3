"""enhance_fps: fps (real frames the client received inside the window,
over the window's length; host clock) of the enhancer's cells, bounded
apart from the grade cells' ``fps``: the enhancer keeps the card busy,
and its runs spread far less than the host-paced grade cells'."""


def read(run):
    return sum(r.in_window for r in run.clips) / run.window_s
