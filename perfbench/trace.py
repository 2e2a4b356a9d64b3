"""Reduce a ``torch.profiler`` trace of the traced sub-window to numbers.

Events are plain ``(name, kind, start_us, end_us)`` tuples, ``kind``
``"device"`` for kernels, copies and sets on the card and ``"host"`` for
the rest.  The sub-window is the host event named :data:`SPAN`, which the
harness opens around the clips it profiles; device time outside it is
left out.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

SPAN = "perfbench.window"
TOP = 10


@dataclass
class TraceSummary:
    window_s: float      # the sub-window's length
    busy_s: float        # the union of device intervals in it
    copy_s: float        # device time of host<->device copies in it
    device_ops: list     # [name, seconds] of the device ops that took most
    idle_gaps: list      # [host op, seconds] of device idle time, by the
    #                      innermost host op running at each gap's middle
    frames: int = 0      # real frames yielded by the profiled clips
    clips: int = 0


def from_profiler(prof) -> list:
    """The events of a stopped ``torch.profiler.profile``; the device-side
    copies of ``record_function`` ranges (user annotations on the card's
    timeline) are left out: they mark time, they are not work."""
    from torch.autograd import DeviceType

    out = []
    for event in prof.events():
        on_device = event.device_type == DeviceType.CUDA
        if on_device and getattr(event, "is_user_annotation", False):
            continue
        out.append((event.name, "device" if on_device else "host",
                    float(event.time_range.start),
                    float(event.time_range.end)))
    return out


def merge(intervals) -> list:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(start, end) for start, end in merged]


def gaps(merged, start: float, end: float) -> list:
    """The parts of ``[start, end]`` that ``merged`` leaves uncovered."""
    out, cursor = [], start
    for lo, hi in merged:
        if lo > cursor:
            out.append((cursor, min(lo, end)))
        cursor = max(cursor, hi)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(lo, hi) for lo, hi in out if hi > lo]


def innermost(host_events, points) -> list:
    """For each point, the name of the shortest host event that holds it
    (``None`` where none does)."""
    events = sorted(host_events, key=lambda e: e[2])
    starts = [e[2] for e in events]
    order = sorted(range(len(points)), key=lambda k: points[k])
    names: list = [None] * len(points)
    active: list = []
    cursor = 0
    for k in order:
        point = points[k]
        stop = bisect.bisect_right(starts, point)
        active.extend(events[cursor:stop])
        cursor = max(cursor, stop)
        active = [e for e in active if e[3] >= point]
        if active:
            names[k] = min(active, key=lambda e: e[3] - e[2])[0]
    return names


def summarize(events) -> TraceSummary | None:
    """Numbers of the :data:`SPAN` sub-window; ``None`` without one or
    without device events."""
    spans = [e for e in events if e[0] == SPAN and e[1] == "host"]
    if not spans:
        return None
    lo, hi = spans[0][2], spans[0][3]
    device = [(name, max(s, lo), min(e, hi)) for name, kind, s, e in events
              if kind == "device" and e > lo and s < hi]
    if not device:
        return None
    merged = merge((s, e) for _, s, e in device)
    by_name: dict = defaultdict(float)
    copy_us = 0.0
    for name, s, e in device:
        by_name[name] += e - s
        if name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name):
            copy_us += e - s
    idle = gaps(merged, lo, hi)
    host = [e for e in events if e[1] == "host" and e[3] > lo and e[2] < hi]
    names = innermost(host, [(a + b) / 2.0 for a, b in idle])
    by_host: dict = defaultdict(float)
    for (a, b), name in zip(idle, names):
        by_host[name or "(none)"] += b - a

    def top(table):
        rows = sorted(table.items(), key=lambda item: -item[1])[:TOP]
        return [[name[:120], us * 1e-6] for name, us in rows]

    return TraceSummary(window_s=(hi - lo) * 1e-6,
                        busy_s=sum(e - s for s, e in merged) * 1e-6,
                        copy_s=copy_us * 1e-6, device_ops=top(by_name),
                        idle_gaps=top(by_host))
