"""The streamed batch that the grade's stream
(:func:`vrgdg_tpu_torch.api.appliers.stream_graded_batches`) and the
enhancer's (:func:`vrgdg_tpu_torch.jobs.enhancer.enhance_batches`) share.

Each batch runs at its own length: every stage is frame-local, so no
stream pads.  On a CUDA device at a dispatch depth of 2 or more,
:func:`look_ahead` stages each host batch one ahead on a
:class:`Stager`: the pinned copy of batch n+1 runs on native threads
while the stream enqueues batch n and waits for batch n-1.  Spans:
``batch.stage`` (logged from the copy's own times when staged ahead),
``batch.stage_wait`` (counts ``ready``), ``batch.enqueue`` (counts
``frames`` and ``short_frames``) and ``batch.wait`` on CUDA; on the CPU,
where the step runs at once, ``batch.enqueue`` alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import logging
import os
import time
from collections import deque
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ..native import NativeUnavailable, load
from .profiling import log_span, next_stream, span

_LOG = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """``torch.device`` for a name; asking for CUDA without a visible card
    raises instead of carrying on on the CPU."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain versions on the CPU.")
    return resolved


def dispatch_depth(default: int = 2) -> int:
    """``VRGDG_DISPATCH_DEPTH`` when set (1: the synchronous loop of A/B
    runs), else ``default``; at least 1."""
    return max(1, int(os.environ.get("VRGDG_DISPATCH_DEPTH") or default))


def enqueue_counts(frames: int, batch_size: int) -> dict:
    """``batch.enqueue``'s counts for a batch of ``frames``."""
    counts = {"frames": frames}
    if 0 < frames < batch_size:
        counts["short_frames"] = batch_size - frames
    return counts


class PendingBatch:
    """A submitted batch: its result on the host once every CUDA event in
    ``events`` has passed, the count of frames submitted, and one pair of
    CUDA events per card around its upload .. download (``None`` on the
    CPU)."""

    def __init__(self, host: torch.Tensor, count: int, events=None):
        self.host = host
        self.count = count
        self.events = events

    def result(self) -> np.ndarray:
        for _, end in self.events or ():
            end.synchronize()
        return self.host.numpy()[:self.count]

    def device_ms(self) -> float:
        """CUDA-event ms from upload to the end of download (after
        :meth:`result`), the longest of the cards'; 0.0 on the CPU."""
        return max((start.elapsed_time(end)
                    for start, end in self.events or ()), default=0.0)


def submit(frames: np.ndarray, step: Callable[[torch.Tensor], torch.Tensor],
           device: torch.device, batch_size: int = 0,
           pinned: torch.Tensor | None = None) -> PendingBatch:
    """Queue ``step`` over the BHWC host batch ``frames`` on ``device``
    without waiting: on CUDA the batch in pinned memory (``pinned`` when it
    was staged ahead, else a fresh pinned buffer and a host copy into it
    here), a non-blocking upload, ``step`` and a pinned non-blocking
    download between two timing events.  The spans take their stream and
    batch from the enclosing span."""
    count = int(frames.shape[0])
    counts = enqueue_counts(count, batch_size)
    if device.type != "cuda":
        with span("batch.enqueue", **counts):
            host = torch.from_numpy(np.ascontiguousarray(frames))
            return PendingBatch(step(host.to(device)).cpu(), count)
    with torch.cuda.device(device):
        if pinned is None:
            with span("batch.stage"):
                host = torch.from_numpy(np.ascontiguousarray(frames))
                pinned = torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True)
                pinned.copy_(host)
        with span("batch.enqueue", **counts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(pinned.to(device, non_blocking=True))
            host_out = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            host_out.copy_(out, non_blocking=True)
            end.record()
    return PendingBatch(host_out, count, [(start, end)])


@functools.cache
def _stage_lib() -> ctypes.CDLL:
    """``native/stage.cpp``, built on first use, with its signatures."""
    lib = load("stage")
    lib.stage_open.argtypes = [ctypes.c_int32]
    lib.stage_open.restype = ctypes.c_void_p
    lib.stage_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int64]
    lib.stage_copy.restype = ctypes.c_int32
    for name in ("stage_done", "stage_wait", "stage_close"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.stage_done.restype = ctypes.c_int32
    lib.stage_wait.restype = ctypes.c_int64
    lib.stage_close.restype = None
    return lib


class Stager:
    """Stages one host batch at a time into a fresh buffer from torch's
    caching host allocator (pinned for a CUDA ``device``; a block is
    reused once the upload that read it has passed), the copy running on
    a pool of ``threads`` native threads (``native/stage.cpp``) that never
    take the interpreter lock, so the stream's thread goes on meanwhile.
    Raises :class:`~vrgdg_tpu_torch.native.NativeUnavailable` when the
    pool cannot be built or its threads cannot be started."""

    def __init__(self, threads: int, device):
        self._lib = _stage_lib()
        self._device = torch.device(device)
        self._pending = None
        self._pool = self._lib.stage_open(max(1, int(threads)))
        if not self._pool:
            raise NativeUnavailable(
                f"could not start {threads} staging threads")

    def start(self, frames: np.ndarray) -> None:
        """Start staging ``frames``; the caller leaves them as they are
        until :meth:`finish` returns."""
        started = time.perf_counter_ns()
        host = torch.from_numpy(np.ascontiguousarray(frames))
        pin = self._device.type == "cuda"
        with (torch.cuda.device(self._device) if pin
              else contextlib.nullcontext()):
            buffer = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=pin)
        status = self._lib.stage_copy(self._pool, buffer.data_ptr(),
                                      host.data_ptr(), host.nbytes)
        if status != 0:
            raise RuntimeError(f"the staging copy was refused ({status})")
        self._pending = (buffer, host, started)

    def ready(self) -> bool:
        """Whether the batch started last is staged."""
        return bool(self._lib.stage_done(self._pool))

    def finish(self) -> tuple[torch.Tensor, int, int]:
        """The batch started last, staged (this thread copies the parts
        no pool thread has taken yet, so a pool held back costs no more
        than staging inline), and when its staging started and ended
        (``time.perf_counter_ns``)."""
        ended = int(self._lib.stage_wait(self._pool))
        buffer, _, started = self._pending
        self._pending = None
        return buffer, started, ended

    def close(self) -> None:
        """Wait for a copy in flight and join the pool's threads."""
        if self._pool:
            self._lib.stage_close(self._pool)
            self._pool = None
        self._pending = None


class HostBatch(NamedTuple):
    """A batch pulled from a stream's input: the index of its first frame,
    the caller's host frames and their pinned copy when they were staged
    ahead (else ``None``)."""

    first: int
    frames: np.ndarray
    pinned: torch.Tensor | None = None


_warned_inline = False


def _stage_inline(reason: Exception) -> None:
    """Log, once a process, that a card's stream stages inline."""
    global _warned_inline
    if not _warned_inline:
        _warned_inline = True
        _LOG.warning("batches are staged inline, not one ahead: %s", reason)


def look_ahead(batches: Iterable[tuple[int, np.ndarray]], in_flight,
               ahead: bool = True) -> Iterator[HostBatch]:
    """``(first_frame_index, host batch)`` items of ``batches`` as
    :class:`HostBatch`, the input never pulled more than one batch ahead
    of the caller, so a decoder that reuses its output buffer is as safe
    as with inline staging.

    Where ``ahead`` holds (false for a caller that stages on its own) and
    ``in_flight`` runs on a CUDA device at a depth of 2 or more, each
    batch is staged one ahead on a :class:`Stager` as wide as torch's
    intra-op threads, made for the first batch: batch n+1 is pulled once
    batch n's staging has finished, and its copy starts before batch n is
    yielded, so it runs while the caller enqueues batch n.  Each take of a
    staged batch is a span ``batch.stage_wait`` whose counter ``ready`` is
    1 when its copy had finished, and its staging is logged as a
    ``batch.stage`` span from its start to the copy's end; both carry the
    ids ``in_flight`` gives the next batch submitted.  Otherwise, and
    where the stager cannot be made (logged once a process), each batch
    is yielded unstaged, the next pulled once the caller comes back for
    it, and :func:`submit` stages it.  An exception from the input (or
    from starting a copy) is raised after the batch before it has been
    yielded.  However the generator ends, it closes the stager first."""
    iterator = iter(batches)
    stage = (ahead and in_flight.depth > 1
             and in_flight.device.type == "cuda")
    stager = None

    def hand():
        nonlocal stage, stager
        try:
            item = next(iterator, None)
            if item is not None and stage and stager is None:
                try:
                    stager = Stager(torch.get_num_threads(),
                                    in_flight.device)
                except NativeUnavailable as exc:
                    stage = False
                    _stage_inline(exc)
            if item is not None and stage:
                stager.start(item[1])
        except Exception as exc:  # raised after the batch before it
            return exc
        return item

    try:
        queued = hand()
        while queued is not None:
            if isinstance(queued, Exception):
                raise queued
            first, frames = queued
            if not stage:   # submit stages it once the caller has it
                yield HostBatch(first, frames)
                queued = hand()
                continue
            ids = in_flight.peek_ids()
            with span("batch.stage_wait", *ids, ready=int(stager.ready())):
                pinned, started, ended = stager.finish()
            log_span("batch.stage", started, ended, *ids)
            queued = hand()
            yield HostBatch(first, frames, pinned)
    finally:
        if stager is not None:
            stager.close()


class InFlight(deque):
    """The in-order FIFO of one call of a batch stream, of
    ``(pending, ids, held)``: a :class:`PendingBatch`, its span ids and
    what its caller holds for it.  ``stats`` receives ``frames``,
    ``batches`` and, on a CUDA ``device``, ``device_ms`` (summed
    :meth:`PendingBatch.device_ms`)."""

    def __init__(self, depth: int, stats: dict | None, device):
        super().__init__()
        self.depth = max(1, int(depth))
        self.stream = next_stream()
        self._batches = 0
        self.stats = {} if stats is None else stats
        self.stats.update(frames=0, batches=0)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.stats["device_ms"] = 0.0

    def peek_ids(self) -> tuple[int, int]:
        """The stream and batch numbers the next batch submitted gets."""
        return self.stream, self._batches

    def next_ids(self) -> tuple[int, int]:
        """The stream and batch numbers of the next batch submitted."""
        ids = self.peek_ids()
        self._batches += 1
        return ids

    def push(self, pending: PendingBatch, ids: tuple, held=None) -> bool:
        """Queue ``pending``; true when the oldest batch is due."""
        self.append((pending, ids, held))
        return len(self) >= self.depth

    def wait(self, pending: PendingBatch, ids: tuple) -> np.ndarray:
        """``pending``'s host result, counted (a ``batch.wait`` on CUDA)."""
        if not pending.events:
            result = pending.result()
        else:
            with span("batch.wait", *ids):
                result = pending.result()
            self.stats["device_ms"] += pending.device_ms()
        self.count(len(result))
        return result

    def count(self, frames: int) -> None:
        """Count a batch of ``frames`` done."""
        self.stats["frames"] += frames
        self.stats["batches"] += 1
