"""``python3 -m perfbench``: one run of one cell (see :mod:`perfbench.run`)."""

import time

STARTED = time.perf_counter()   # set-up is timed from here, torch's import included

import sys  # noqa: E402

from perfbench.run import main  # noqa: E402

sys.exit(main(started=STARTED))
