"""One run of one cell: set-up, a measured window, the check against the
plain reference, one JSON line.

``python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

- Set-up (``setup_s``, from the process's start): torch's and the
  program's import, the cell's inputs made from the seed on the device,
  the entry, and warm clips of every batch shape the window uses, padded
  tail batches included; the kernels load from the program's build cache
  in the checkout (they build there on a checkout's first run).
- The window: one client sends clips back to back for ``--seconds``; the
  clip running when it closes is finished, and its frames after the close
  do not count toward ``fps``.  A reservoir drawn from the seed keeps two
  frames (one drawn, and the last, in the padded tail batch) of
  :data:`SAMPLED_CLIPS` clips.
- ``--trace 1`` runs the same window with ``torch.profiler`` on over whole
  clips from :data:`TRACE_LEAD_S` into it, for about :data:`TRACE_SECONDS`,
  and reports the per-layer metrics instead of the end-to-end ones.
- The check: once the window has closed, its peak memory been read and the
  program's state freed, the reference (:mod:`perfbench.reference`)
  computes the kept frames again; ``correct`` holds when every number is
  within the configuration's limit.

The run prints the numbers compared beside their limits as the last lines
of standard error, and the result as the last line of standard output.  It
exits with 2 and prints no result without the card(s) the cell asks for or
without the program in the checkout, and with 3 when ``jax``, ``jaxlib``,
``flax`` or ``vrgdg_tpu`` was imported.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import cells, trace as tracing
from .cells import ROOT
from .entries import launch_counts

FORBIDDEN = ("jax", "jaxlib", "flax", "vrgdg_tpu")
SAMPLED_CLIPS = 12
TRACE_LEAD_S = 1.0
TRACE_SECONDS = 3.0


@dataclass
class ClipRecord:
    clip: object
    start: float
    end: float = 0.0
    frames: int = 0            # real frames the sink received
    in_window: int = 0         # of them, before the window closed
    setup_ms: float | None = None
    device_ms: float | None = None
    batches: int = 0


@dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read."""

    cell: cells.Cell
    setup_s: float
    window_s: float
    clips: list                # ClipRecord of every clip the window sent
    frame_in: tuple            # (height, width) of the frames sent
    frame_out: tuple           # and of those received
    peaks: dict | None         # the card's entry in peaks.json
    trace: tracing.TraceSummary | None = None


class Sampler:
    """A reservoir of clips drawn from the seed (Algorithm R); each kept
    clip keeps frame ``pick`` and its last frame.  They are copied into
    buffers written once before the window, so a copy in the window
    touches no fresh memory."""

    def __init__(self, seed: int, size: int, frame_shape: tuple):
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
        self.size, self.seen = size, 0
        self.slots: dict = {}    # slot -> (clip, wanted indices, {i: frame})
        self.buffers = np.ones((size, 2, *frame_shape), np.uint8)

    def admit(self, clip) -> tuple | None:
        """``(wanted indices, dict they go to, their buffers)`` for a kept
        clip, else ``None``."""
        pick = int(self.rng.integers(clip.length))
        slot = self.seen if self.seen < self.size else int(
            self.rng.integers(self.seen + 1))
        self.seen += 1
        if slot >= self.size:
            return None
        wanted, frames = sorted({pick, clip.length - 1}), {}
        self.slots[slot] = (clip, wanted, frames)
        return wanted, frames, self.buffers[slot]


def forbidden_modules() -> list:
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def _peaks(device: torch.device, root: str) -> dict | None:
    if device.type != "cuda":
        return None
    with open(os.path.join(root, "perfbench", "peaks.json"),
              encoding="utf-8") as handle:
        table = json.load(handle)
    name = torch.cuda.get_device_name(device)
    for key, peaks in table.items():
        if key in name:
            return peaks
    return None


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def run_window(cell, entry, generator, seed: int, seconds: float,
               trace: bool, sampler: Sampler):
    """Run the window; returns its clip records and, traced, the profiled
    events (read once the window has closed) and the profiled records."""
    schedule = generator.clips(cell.traffic, seed)
    records: list = []
    profiled: list = []
    prof = span = None
    started = profiled_from = time.perf_counter()
    closes = started + seconds
    while time.perf_counter() < closes:
        clip = next(schedule)
        kept = sampler.admit(clip)
        if (trace and prof is None
                and time.perf_counter() >= started + TRACE_LEAD_S):
            prof = _profiler()
            prof.start()
            span = torch.autograd.profiler.record_function(tracing.SPAN)
            span.__enter__()
            profiled_from = time.perf_counter()
        record = ClipRecord(clip=clip, start=time.perf_counter())

        def sink(out, record=record, kept=kept):
            now = time.perf_counter()
            if kept is not None:
                wanted, frames, buffers = kept
                for index, buffer in zip(wanted, buffers):
                    if 0 <= index - record.frames < out.shape[0]:
                        if out.shape[1:] == buffer.shape:
                            np.copyto(buffer, out[index - record.frames])
                            frames[index] = buffer
                        else:   # a wrong shape: judged as such
                            frames[index] = np.array(out[index - record.frames])
            record.frames += out.shape[0]
            if now <= closes:
                record.in_window += out.shape[0]

        info = entry.run_clip(clip, sink, sync_setup=trace)
        record.end = time.perf_counter()
        record.setup_ms, record.device_ms = info["setup_ms"], info["device_ms"]
        record.batches = info["batches"]
        records.append(record)
        if span is not None:
            profiled.append(record)
            if record.end - profiled_from >= TRACE_SECONDS:
                span.__exit__(None, None, None)
                prof.stop()
                span = None
    if span is not None:
        span.__exit__(None, None, None)
        prof.stop()
    events = tracing.from_profiler(prof) if prof is not None else None
    return records, events, profiled


def frame_numbers(pairs) -> dict:
    """``worst_frame_off``: the largest share of a frame's uint8 values
    that differ from the expected frame's; ``max_level_diff``: the largest
    difference of a value, in levels.  ``pairs`` are ``(got, expected)``;
    a frame that never came (``got`` is ``None``) or came in another shape
    reads 1.0 and 255."""
    worst, widest = 0.0, 0
    for got, expected in pairs:
        if got is None or got.shape != expected.shape:
            worst, widest = 1.0, 255
            continue
        diff = np.abs(got.astype(np.int16) - expected.astype(np.int16))
        worst = max(worst, float(np.count_nonzero(diff)) / diff.size)
        widest = max(widest, int(diff.max()))
    return {"worst_frame_off": worst, "max_level_diff": float(widest)}


def kept_frames(sampler: Sampler, reference, generator, inputs) -> list:
    """``(clip, index, input frame, frame received or None, expected)`` of
    every frame the reservoir wanted."""
    out = []
    for clip, wanted, frames in sampler.slots.values():
        for index in wanted:
            source = generator.frame_at(inputs, clip, index)
            out.append((clip, index, source, frames.get(index),
                        reference.frame(clip, index, source)))
    return out


def judge(frames: list, records: list) -> dict:
    """:func:`frame_numbers` of the kept ``frames`` (from
    :func:`kept_frames`); a clip that gave another number of frames than
    it has reads as a frame that never came."""
    pairs = [(got, expected) for _, _, _, got, expected in frames]
    if any(r.frames != r.clip.length for r in records):
        pairs.append((None, None))
    return frame_numbers(pairs)


def build_reference(cell, inputs, root: str, device, control: bool = False):
    module = cells.code_module("reference", cell.config["reference"])
    return module.Reference(cell.config, inputs, root, device,
                            cell.config["control"] if control else None)


def set_up(cell, seed: int, device, root: str, trace: bool = False):
    """The cell's traffic generator, its inputs of ``seed`` and its entry,
    warmed up on every batch shape the window uses; resets the device's
    peak memory before the warm-up."""
    generator = cells.code_module("traffic", cell.traffic["generator"])
    inputs = generator.make_inputs(cell.traffic, seed, device)
    entry = cells.code_module("entries", cell.config["entry"]).Entry(
        cell.config, cell.traffic, inputs, device, generator, root)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    warm_reference = 0 if inputs.references else -1
    for n, length in enumerate(entry.warm_lengths()):
        entry.run_clip(generator.Clip(index=-1 - n, length=length, offset=n,
                                      reference=warm_reference),
                       lambda out: None, sync_setup=trace)
    if trace:
        # the profiler's first start brings up CUPTI, which takes seconds:
        # pay it here, around one more warm clip, not in the window
        prof = _profiler()
        prof.start()
        entry.run_clip(generator.Clip(index=-3, length=entry.warm_lengths()[0],
                                      offset=2, reference=warm_reference),
                       lambda out: None, sync_setup=True)
        prof.stop()
        tracing.from_profiler(prof)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return generator, inputs, entry


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             started: float, root: str = ROOT) -> tuple[dict, list]:
    """One run on ``device``; returns the result and the lines of the
    check.  ``started`` is when set-up began (``time.perf_counter``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    generator, inputs, entry = set_up(cell, seed, device, root, trace)
    sampler = Sampler(seed, SAMPLED_CLIPS, (*entry.frame_out, 3))
    launches_before = launch_counts()
    setup_s = time.perf_counter() - started

    records, events, profiled = run_window(cell, entry, generator, seed,
                                           seconds, trace, sampler)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {name: count - launches_before.get(name, 0)
                for name, count in launch_counts().items()}
    print(f"[perfbench] clips {len(records)} device batches "
          f"{sum(r.batches for r in records)} kernel launches {launches}",
          file=sys.stderr)
    run = Run(cell=cell, setup_s=setup_s, window_s=float(seconds),
              clips=records, frame_in=tuple(inputs.pool.shape[1:3]),
              frame_out=entry.frame_out, peaks=_peaks(device, root))
    if events is not None:
        run.trace = tracing.summarize(events)
        if run.trace is not None:
            run.trace.frames = sum(r.frames for r in profiled)
            run.trace.clips = len(profiled)
    del entry, events
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reference = build_reference(cell, inputs, root, device)
    numbers = judge(kept_frames(sampler, reference, generator, inputs),
                    records)
    limits = cell.config["limits"]
    checks = {name: {"value": numbers[name], "limit": float(limit)}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for metric in wanted:
        value = cells.metric_reader(metric["name"], root)(run)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value),
                                       "unit": metric["unit"]}
    result = {"correct": correct, "attempted": len(records),
              "failed": sum(r.frames != r.clip.length for r in records),
              "metrics": metrics,
              "device": {
                  "platform": "gpu" if cuda else device.type,
                  "kind": (torch.cuda.get_device_name(device) if cuda
                           else device.type),
                  "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if trace and run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}"
             for name, c in checks.items()]
    return result, lines


def main(argv=None, started: float | None = None) -> int:
    started = time.perf_counter() if started is None else started
    parser = argparse.ArgumentParser(prog="python3 -m perfbench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import vrgdg_tpu_torch
    except ImportError as exc:
        print(f"perfbench: the program is missing: {exc}", file=sys.stderr)
        return 2
    if not os.path.abspath(vrgdg_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"perfbench: vrgdg_tpu_torch comes from "
              f"{vrgdg_tpu_torch.__file__}, not from {ROOT}", file=sys.stderr)
        return 2

    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), started)
    print(f"[perfbench] card {card_line()}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"perfbench: imported {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"[perfbench] setup_s {result['metrics'].get('setup_s')} "
          f"memory_peak_bytes {result['device']['memory_peak_bytes']}",
          file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
