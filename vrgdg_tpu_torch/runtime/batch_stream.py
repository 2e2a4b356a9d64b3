"""The streamed batch that the grade's stream
(:func:`vrgdg_tpu_torch.api.appliers.stream_graded_batches`) and the
enhancer's (:func:`vrgdg_tpu_torch.jobs.enhancer.enhance_batches`) share.

Each batch runs at its own length: every stage is frame-local, so no
stream pads.  Spans: ``batch.stage``, ``batch.enqueue`` (counts ``frames``
and ``short_frames``) and ``batch.wait`` on CUDA; on the CPU, where the
step runs at once, ``batch.enqueue`` alone.
"""

from __future__ import annotations

import itertools
import os
from collections import deque
from typing import Callable

import numpy as np
import torch

from .profiling import next_stream, span


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
           device: torch.device, batch_size: int = 0) -> PendingBatch:
    """Queue ``step`` over the BHWC host batch ``frames`` on ``device``
    without waiting: on CUDA a fresh pinned buffer, a non-blocking upload,
    ``step`` and a pinned non-blocking download between two timing events.
    The spans take their stream and batch from the enclosing span."""
    count = int(frames.shape[0])
    counts = enqueue_counts(count, batch_size)
    if device.type != "cuda":
        with span("batch.enqueue", **counts):
            host = torch.from_numpy(np.ascontiguousarray(frames))
            return PendingBatch(step(host.to(device)).cpu(), count)
    with torch.cuda.device(device):
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
        self._batches = itertools.count()
        self.stats = {} if stats is None else stats
        self.stats.update(frames=0, batches=0)
        if torch.device(device).type == "cuda":
            self.stats["device_ms"] = 0.0

    def next_ids(self) -> tuple[int, int]:
        """The stream and batch numbers of the next batch submitted."""
        return self.stream, next(self._batches)

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
