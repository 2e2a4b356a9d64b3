"""The Standalone Video Enhancer: a background-threaded, segment-checkpointed,
resumable render engine over torch on one device or a mesh of them.

Counterpart of :mod:`vrgdg_tpu.jobs.enhancer`, with the same semantics:

- settings schema + clamping (:class:`vrgdg_tpu_torch.core.params.EnhancerSettings`,
  ``VRGDG_StandaloneVideoEnhancerNodes.py:142-180``),
- "fake upscale" output dimensions and auto batch size (``:183-210``),
- sharpen -> seeded grain effects order (``:278-294``), with per-frame
  seeding so output is invariant to batch boundaries (``:261-275``),
- per-segment render loop with ``.partial.mp4`` -> ``os.replace`` commit,
  manifest fingerprint + pruning, resume/cancel with ``can_resume``
  (``:513-655``),
- single-active-job guard, daemon worker thread, snapshot copies that strip
  live handles (``:20-23, 327-340, 658-711``),
- preview endpoint math (``:714-753``).

The device step is dequantize -> lanczos4 resample -> clamp -> unsharp ->
seeded grain -> quantize.  On a card, for a uint8 batch that comes back as
uint8 and is not split by height, it is one launch of the ``enhance_step``
CUDA kernel (:func:`_enhance_step_uint8`,
:mod:`vrgdg_tpu_torch.kernels.enhance_cuda`): uint8 in and out, no float32
frame at the output size in device memory.  Everywhere else (the CPU, the
float-output path such as :func:`preview_frame`, height shards) it is the
torch chain :func:`_enhance_step`: two dense float32 products per frame
(:mod:`vrgdg_tpu_torch.ops.resize`), then the grain through
:func:`~vrgdg_tpu_torch.kernels.grain_cuda.film_grain_kernel`, the
``film_grain`` CUDA kernel on a card (it raises if it cannot build or
launch) and its plain version on the CPU.  Both paths draw the port's one
Philox stream.  Batches, each at its own length, go through the streamed batch
the grade also runs on (:mod:`vrgdg_tpu_torch.runtime.batch_stream`), up
to ``VRGDG_DISPATCH_DEPTH`` (default 2) in flight.  An out-of-memory error
surfaces when torch allocates, that is when a batch is submitted; both
the submit and the force branch bisect the batch and keep frame order.

On more than one card (:func:`mesh_for_settings`) a batch is padded to
the mesh's data axis on the host while still uint8, each data row's block
of frames is uploaded to its card and stepped with its own absolute
``frame_start``, and the results come back in order: bit-identical to one
card.  With a space axis, each frame is also split by height over the
row's cards when its height divides the axis (the JAX package's rule):
lanczos4 reads the source rows in the support of a shard's output rows as
its halo, the unsharp exchanges one row, and ``film_grain`` draws the
shard's rows of the whole frame's grain; that matches one card within
1e-5.  :func:`render_job_shards` spreads a job's segments over processes
that share a job folder.  Not here: the XLA compile cache.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import threading
import time
import uuid
from typing import Callable, Iterable

import numpy as np
import torch

from ..core.params import EnhancerSettings, auto_batch_size, output_dimensions
from ..kernels import enhance_cuda
from ..kernels.grain_cuda import film_grain_kernel
from ..ops.resize import lanczos_support, resample, resample_rows
from ..ops.sharpen import unsharp
from ..parallel.distributed import local_devices
from ..parallel.mesh import DATA_AXIS, SPACE_AXIS, make_mesh, pad_to_multiple
from ..parallel.spatial import HeightShards, place, row_starts
from ..runtime import video_io
from ..runtime.batch_stream import (InFlight, PendingBatch, dispatch_depth,
                                    enqueue_counts, look_ahead,
                                    resolve_device, submit)
from ..runtime.profiling import StageTimer, span
from . import manifest as mf

_DEFAULT_ROOT = os.environ.get(
    "VRGDG_TPU_OUTPUT", os.path.join(os.getcwd(), "vrgdg_output"))


def root_folder(base: str | None = None) -> str:
    path = os.path.join(base or _DEFAULT_ROOT, "VRGDG_VideoEnhancer")
    os.makedirs(path, exist_ok=True)
    return path


def upload_folder(base: str | None = None) -> str:
    path = os.path.join(root_folder(base), "uploads")
    os.makedirs(path, exist_ok=True)
    return path


def preview_folder(base: str | None = None) -> str:
    path = os.path.join(root_folder(base), "previews")
    os.makedirs(path, exist_ok=True)
    return path


def jobs_folder(base: str | None = None) -> str:
    path = os.path.join(root_folder(base), "jobs")
    os.makedirs(path, exist_ok=True)
    return path


# --------------------------------------------------------------------------
# Device pipeline
# --------------------------------------------------------------------------

def _effects(settings: EnhancerSettings) -> tuple[float, str, float]:
    """``(sharpen strength, border, grain intensity)`` of the step; a
    strength or intensity of 0 leaves its stage out.  use_accelerator maps
    to the reference's use_gpu border convention (zero-padded avg_pool on
    GPU, edge-replicate on CPU) so outputs are comparable for equal
    settings."""
    sharpen = (float(settings.sharpen_strength) if settings.sharpen_enabled
               and settings.sharpen_strength > 0 else 0.0)
    grain = (float(settings.grain_intensity) if settings.grain_enabled
             and settings.grain_intensity > 0 else 0.0)
    return sharpen, "zero" if settings.use_accelerator else "edge", grain


def _enhance_step(frames: torch.Tensor, settings: EnhancerSettings,
                  out_height: int, out_width: int,
                  frame_start: int) -> torch.Tensor:
    """Resize (lanczos4) -> unsharp -> seeded grain on ``frames``' device,
    float in and float out: the torch chain, spans ``enhance.resample``,
    ``enhance.sharpen`` and ``enhance.grain``."""
    sharpen, border, grain = _effects(settings)
    with span("enhance.resample"):
        out = torch.clamp(resample(frames, out_height, out_width,
                                   "lanczos4"), 0.0, 1.0)
    if sharpen:
        with span("enhance.sharpen"):
            out = unsharp(out, sharpen, border)
    if grain:
        with span("enhance.grain"):
            out = film_grain_kernel(out.contiguous(), grain,
                                    settings.saturation_mix, settings.seed,
                                    frame_start=frame_start)
    return out


def _enhance_step_uint8(frames: torch.Tensor, settings: EnhancerSettings,
                        out_height: int, out_width: int,
                        frame_start: int) -> torch.Tensor:
    """The whole step on a card's uint8 batch, uint8 out: one launch of
    the ``enhance_step`` kernel under the span ``enhance.step`` (counter
    ``frames``, timed by CUDA events while a profiler records)."""
    sharpen, border, grain = _effects(settings)
    with span("enhance.step", device=frames.device,
              frames=int(frames.shape[0])):
        return enhance_cuda.enhance_step(
            frames.contiguous(), out_height, out_width,
            sharpen_strength=sharpen, border=border, grain_intensity=grain,
            saturation_mix=settings.saturation_mix, seed=settings.seed,
            frame_start=frame_start)


def _enhance_rows(shards: HeightShards, settings: EnhancerSettings,
                  out_height: int, out_width: int,
                  frame_start: int) -> HeightShards:
    """:func:`_enhance_step` over height shards of the source frames: each
    shard resamples its share of the output rows from the source rows in
    their lanczos4 support, then unsharp (one halo row) and grain (the
    shard's rows of the whole frame's grain)."""
    src_h, space = shards.height, len(shards.tiles)
    starts = row_starts(int(out_height), space)
    tiles = []
    for index, (start, stop) in enumerate(zip(starts, starts[1:])):
        lo, hi = lanczos_support(src_h, out_height, start, stop)
        window = shards.window(index, lo, hi)
        tiles.append(torch.clamp(resample_rows(
            window, src_h, lo, start, stop, out_height, out_width), 0.0, 1.0))
    out = HeightShards(tiles, starts)
    sharpen, border, grain = _effects(settings)
    if sharpen:
        out = out.stencil(1, lambda x, rows: unsharp(
            x, sharpen, border, rows=rows))
    if grain:
        out = out.map(lambda tile, rows: film_grain_kernel(
            tile.contiguous(), grain, settings.saturation_mix,
            settings.seed, frame_start=frame_start, row_start=rows.start,
            frame_height=rows.height))
    return out


def mesh_for_settings(settings: EnhancerSettings, device="cuda"):
    """Build the mesh the job will run on, or ``None`` for one device.

    ``data_parallel`` cards (0: every card this process owns, counted by
    :func:`~vrgdg_tpu_torch.parallel.distributed.local_devices`: the
    visible cards or ``VRGDG_TPU_LOCAL_DEVICE_IDS``) times
    ``spatial_parallel``, as many as there are; ``None`` when that leaves
    one card, on the CPU, and for a ``device`` that names one card
    (``cuda:N``).  Every op in the enhance step is frame-local and grain
    is per-frame seeded, so frame-axis sharding is bit-identical to one
    card."""
    want = int(getattr(settings, "data_parallel", 0))
    spatial = max(1, int(getattr(settings, "spatial_parallel", 1)))
    if want == 1 and spatial == 1:
        return None
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return None
    cards = local_devices()
    n_use = len(cards) if want == 0 else min(want * spatial, len(cards))
    n_use = (n_use // spatial) * spatial
    if n_use <= 1:
        return None
    return make_mesh(n_use, spatial=spatial, devices=cards,
                     span_processes=False)


def _submit_on_mesh(host: torch.Tensor, count: int, step, spatial_step,
                    mesh) -> PendingBatch:
    """Pad ``host`` (uint8 or float32 BHWC) to the mesh's data axis, run
    ``step`` (or ``spatial_step`` on height shards) on each data row's
    block with its absolute first frame, and queue the results' downloads
    in order."""
    data, space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    host, _ = pad_to_multiple(host, data)
    per = host.shape[0] // data
    # the JAX package's rule: split the height only where it divides
    spatial = space > 1 and host.shape[1] % space == 0
    cuda = mesh.lead.type == "cuda"
    if cuda:
        host = torch.empty(host.shape, dtype=host.dtype,
                           pin_memory=True).copy_(host)
    events: dict = {}

    def mark(device) -> None:
        if device.type == "cuda" and device not in events:
            with torch.cuda.device(device):
                events[device] = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                events[device][0].record()

    host_out = None
    for row_index, row in enumerate(mesh.devices):
        for device in (row if spatial else row[:1]):
            mark(device)
        block = host[row_index * per:(row_index + 1) * per]
        start = row_index * per
        if spatial:
            out = spatial_step(HeightShards.split(block, row),
                               start).gather(row[0])
        else:
            out = step(place(block, row[0]), start)
        if host_out is None:
            host_out = torch.empty((host.shape[0], *out.shape[1:]),
                                   dtype=out.dtype, pin_memory=cuda)
        host_out[row_index * per:(row_index + 1) * per].copy_(
            out, non_blocking=cuda)
    for device, (_, end) in events.items():
        with torch.cuda.device(device):
            end.record()
    return PendingBatch(host_out, count, list(events.values()) or None)


def submit_effects_batch(frames: np.ndarray, settings: EnhancerSettings,
                         out_height: int | None = None,
                         out_width: int | None = None,
                         frame_start: int = 0, mesh=None,
                         as_uint8: bool = False, *, device="cuda",
                         batch_size: int = 0,
                         pinned: torch.Tensor | None = None) -> PendingBatch:
    """Queue the device step on ``device`` (or over ``mesh``) WITHOUT
    waiting for it.

    ``frames`` is a BHWC uint8 (or float32 [0,1]) host batch, run by
    :func:`~vrgdg_tpu_torch.runtime.batch_stream.submit`: dequantized,
    enhanced and quantized when ``as_uint8`` (4x less to download;
    bit-identical to quantizing on the host).  A uint8 batch on a card
    with ``as_uint8`` runs as one ``enhance_step`` launch
    (:func:`_enhance_step_uint8`); any other batch, and height shards, run
    the torch chain.  ``batch_size``: the stream's, for the
    ``short_frames`` count of ``batch.enqueue``; ``pinned``: ``frames``
    already staged (see ``submit``; not with ``mesh``).

    With ``mesh`` the batch runs over the mesh's cards instead
    (:func:`_submit_on_mesh`: padded to divide its data axis, on the host,
    still uint8; the padding is trimmed after)."""
    if out_height is None:
        out_height = int(frames.shape[1])
    if out_width is None:
        out_width = int(frames.shape[2])

    def finish(out: torch.Tensor) -> torch.Tensor:
        return video_io.quantize_on_device(out) if as_uint8 else out

    def step(on_device: torch.Tensor, offset: int = 0) -> torch.Tensor:
        start = int(frame_start) + offset
        if (as_uint8 and on_device.dtype == torch.uint8
                and on_device.device.type == "cuda"):
            return _enhance_step_uint8(on_device, settings, int(out_height),
                                       int(out_width), start)
        out = _enhance_step(video_io.dequantize_on_device(on_device),
                            settings, int(out_height), int(out_width), start)
        return finish(out)

    def spatial_step(shards: HeightShards, offset: int) -> HeightShards:
        shards = shards.map(
            lambda tile, rows: video_io.dequantize_on_device(tile))
        out = _enhance_rows(shards, settings, int(out_height),
                            int(out_width), int(frame_start) + offset)
        return out.map(lambda tile, rows: finish(tile))

    if mesh is None:
        return submit(frames, step, resolve_device(device), batch_size,
                      pinned)
    count = int(frames.shape[0])
    with span("batch.enqueue", **enqueue_counts(count, batch_size)):
        host = torch.from_numpy(np.ascontiguousarray(frames))
        return _submit_on_mesh(host, count, step, spatial_step, mesh)


def apply_effects_batch(frames: np.ndarray, settings: EnhancerSettings,
                        out_height: int | None = None,
                        out_width: int | None = None,
                        frame_start: int = 0, mesh=None,
                        as_uint8: bool = False, *,
                        device="cuda") -> np.ndarray:
    """Host wrapper: BHWC host batch in, enhanced BHWC host batch out
    (synchronous; see :func:`submit_effects_batch`)."""
    return submit_effects_batch(frames, settings, out_height, out_width,
                                frame_start, device=device, mesh=mesh,
                                as_uint8=as_uint8).result()


def _is_oom(exc: BaseException) -> bool:
    return (isinstance(exc, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(exc).lower())


def process_with_retry(frames: np.ndarray, settings: EnhancerSettings,
                       out_height: int, out_width: int,
                       frame_start: int, mesh=None, as_uint8: bool = False,
                       *, device="cuda") -> tuple[np.ndarray, int]:
    """Bisect the batch on device OOM, like the reference's CUDA retry
    (``VRGDG_StandaloneVideoEnhancerNodes.py:297-308``); returns
    ``(frames, smallest_successful_batch)``."""
    try:
        out = apply_effects_batch(frames, settings, out_height, out_width,
                                  frame_start, device=device, mesh=mesh,
                                  as_uint8=as_uint8)
        return out, len(frames)
    except RuntimeError as exc:
        if not _is_oom(exc) or len(frames) <= 1:
            raise
        midpoint = max(1, len(frames) // 2)
        left, left_n = process_with_retry(frames[:midpoint], settings,
                                          out_height, out_width, frame_start,
                                          device=device, mesh=mesh,
                                          as_uint8=as_uint8)
        right, right_n = process_with_retry(frames[midpoint:], settings,
                                            out_height, out_width,
                                            frame_start + midpoint,
                                            device=device, mesh=mesh,
                                            as_uint8=as_uint8)
        return np.concatenate([left, right], axis=0), min(left_n, right_n)


# --------------------------------------------------------------------------
# Job registry
# --------------------------------------------------------------------------

class JobRegistry:
    """Thread-safe job state store with cancel events
    (``VRGDG_StandaloneVideoEnhancerNodes.py:20-23, 327-340``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._jobs: dict[str, dict] = {}
        self._cancel: dict[str, threading.Event] = {}

    def update(self, job_id: str, **values) -> None:
        with self._lock:
            job = self._jobs.setdefault(job_id, {"job_id": job_id})
            job.update(values)
            job["updated_at"] = time.time()

    def snapshot(self, job_id: str) -> dict:
        with self._lock:
            job = dict(self._jobs.get(job_id) or {})
        job.pop("thread", None)
        job.pop("process", None)
        return job

    def all_snapshots(self) -> list[dict]:
        with self._lock:
            ids = list(self._jobs)
        return [self.snapshot(job_id) for job_id in ids]

    def cancel_event(self, job_id: str) -> threading.Event:
        with self._lock:
            return self._cancel.setdefault(job_id, threading.Event())

    def get_cancel(self, job_id: str) -> threading.Event | None:
        with self._lock:
            return self._cancel.get(job_id)

    def active_job(self, excluding: str = "") -> dict | None:
        with self._lock:
            for job in self._jobs.values():
                if (job.get("job_id") != excluding
                        and job.get("status") in {"queued", "running",
                                                  "encoding"}):
                    return dict(job)
        return None

    def attach(self, job_id: str, key: str, value) -> None:
        with self._lock:
            self._jobs.setdefault(job_id, {"job_id": job_id})[key] = value


JOBS = JobRegistry()


# --------------------------------------------------------------------------
# Render engine
# --------------------------------------------------------------------------

def enhance_batches(batches: Iterable[tuple[int, np.ndarray]],
                    settings: EnhancerSettings, out_h: int, out_w: int, *,
                    device, batch_size: int, mesh=None,
                    write: Callable[[np.ndarray], object],
                    timer: StageTimer | None = None,
                    cancel_event: threading.Event | None = None,
                    on_batch: Callable[[int, int, int], object] | None = None,
                    stats: dict | None = None) -> tuple[int, int]:
    """Enhance ``(first_frame_index, uint8 (B, H, W, 3))`` host batches and
    hand the uint8 results to ``write`` in frame order; returns
    ``(frames_done, smallest_batch)``.

    The device is fed in chunks of the current OOM-proven batch size, so
    each batch triggers at most one bisection per job (the reference reads
    ``min(smallest_batch, remaining)`` per step,
    ``VRGDG_StandaloneVideoEnhancerNodes.py:410-418``), each at its own
    length, through the FIFO of :mod:`vrgdg_tpu_torch.runtime.batch_stream`:
    upload and compute of one batch overlap download and encode of the one
    before, and on a card each decoded batch is staged one ahead on
    native threads
    (:func:`~vrgdg_tpu_torch.runtime.batch_stream.look_ahead`; a chunk is
    then a slice of its pinned copy).  On an OOM at submit, the
    older chunks in flight are written first, then this one is bisected.

    ``mesh`` (from :func:`mesh_for_settings`) spreads each batch over its
    cards.  ``on_batch(count, frames_done, smallest_batch)`` runs after each
    decoded batch is submitted; ``stats`` (optional) is filled as
    :class:`~vrgdg_tpu_torch.runtime.batch_stream.InFlight` says."""
    timer = timer or StageTimer()
    lead = mesh.lead if mesh is not None else resolve_device(device)
    in_flight = InFlight(dispatch_depth(), stats, lead)
    smallest_batch = max(1, int(batch_size))
    frames_done = 0

    def retry(chunk: np.ndarray, start: int) -> np.ndarray:
        nonlocal smallest_batch
        enhanced, ok_batch = process_with_retry(
            chunk, settings, out_h, out_w, start, device=device, mesh=mesh,
            as_uint8=True)
        smallest_batch = max(1, min(smallest_batch, ok_batch))
        in_flight.count(len(enhanced))
        return enhanced

    def force() -> None:
        pending, ids, (chunk, start) = in_flight.popleft()
        with timer.stage("device"):
            try:
                enhanced = in_flight.wait(pending, ids)
            except RuntimeError as exc:
                if not _is_oom(exc):
                    raise
                enhanced = retry(chunk, start)
        with timer.stage("encode"):
            write(enhanced)

    # the mesh stages on its own (_submit_on_mesh)
    with contextlib.closing(
            look_ahead(batches, in_flight, mesh is None)) as pulled:
        while True:
            with timer.stage("decode", in_flight.stream):
                item = next(pulled, None)
            if item is None:
                break
            if cancel_event is not None and cancel_event.is_set():
                raise InterruptedError("Render canceled.")
            count = item.frames.shape[0]
            offset = 0
            while offset < count:
                # a staged batch's chunks (and their retries) read its
                # pinned copy, which the input cannot overwrite
                end = offset + smallest_batch
                pinned = (None if item.pinned is None
                          else item.pinned[offset:end])
                chunk = (item.frames[offset:end] if pinned is None
                         else pinned.numpy())
                start = item.first + offset
                offset += len(chunk)
                ids = in_flight.next_ids()
                with timer.stage("device", *ids):
                    try:
                        pending = submit_effects_batch(
                            chunk, settings, out_h, out_w, start,
                            device=device, mesh=mesh, as_uint8=True,
                            batch_size=smallest_batch, pinned=pinned)
                    except RuntimeError as exc:
                        if not _is_oom(exc):
                            raise
                        pending = None
                if pending is not None:
                    if in_flight.push(pending, ids, (chunk, start)):
                        force()
                    continue
                # Outside the device stage: force and the write open their
                # own stages, and StageTimer is a plain accumulator.
                while in_flight:
                    force()
                with timer.stage("device", *ids):
                    enhanced = retry(chunk, start)
                with timer.stage("encode"):
                    write(enhanced)
            frames_done += count
            if on_batch is not None:
                on_batch(count, frames_done, smallest_batch)
    while in_flight:  # drain the dispatch pipeline
        force()
    return frames_done, smallest_batch


def _render_segment(source_path: str, segment_path: str, start_frame: int,
                    end_frame: int, metadata: dict,
                    settings: EnhancerSettings, job_id: str,
                    cancel_event: threading.Event,
                    registry: JobRegistry, device="cuda",
                    mesh=None) -> tuple[int, int, dict]:
    out_w, out_h = output_dimensions(metadata["width"], metadata["height"],
                                     settings.upscale_resolution)
    batch = settings.batch_size or auto_batch_size(out_w, out_h)
    n_chips = 1 if mesh is None else mesh.size
    if mesh is not None:
        # Keep whole device-batches busy: at least one frame per card.
        batch = max(batch, n_chips)
    started = time.time()
    timer = StageTimer()

    def progress(count: int, frames_done: int, smallest_batch: int) -> None:
        current = int(registry.snapshot(job_id).get(
            "frames_processed") or 0) + count
        total = max(1, int(metadata["frame_count"]))
        elapsed = max(1e-6, time.time() - started)
        registry.update(
            job_id,
            frames_processed=current,
            progress=min(0.94, current / total * 0.94),
            batch_size=smallest_batch,
            mesh_devices=n_chips,
            fps_per_chip=round(frames_done / elapsed / n_chips, 3),
            stage_seconds=timer.seconds(),
            message=(f"Upscaling and enhancing frames "
                     f"{current:,}/{total:,}"),
        )

    # Parallel chunked decode is opt-in (decode_workers > 1): chunk seeks
    # can land off-by-one on some OpenCV backends for open-GOP/B-frame/
    # VFR sources (see ParallelVideoReader), so "auto" (0) is sequential.
    workers = int(getattr(settings, "decode_workers", 0)) or 1
    writer = video_io.VideoWriter(segment_path, metadata["fps"], out_w, out_h)
    try:
        if workers > 1:
            reader = video_io.ParallelVideoReader(
                source_path, batch_size=batch, start_frame=start_frame,
                end_frame=end_frame, workers=workers, as_float=False)
        else:
            reader = video_io.VideoReader(source_path, batch_size=batch,
                                          start_frame=start_frame,
                                          end_frame=end_frame, as_float=False)
        # PrefetchingReader.close() stops and joins the pump thread before
        # releasing the capture, so it owns reader shutdown on every path.
        with video_io.PrefetchingReader(reader) as prefetch:
            frames_done, smallest_batch = enhance_batches(
                prefetch, settings, out_h, out_w, device=device,
                batch_size=batch, mesh=mesh, write=writer.write_array,
                timer=timer, cancel_event=cancel_event, on_batch=progress)
        if frames_done <= 0:
            raise RuntimeError(
                "The source video ended before this segment could be rendered.")
    finally:
        writer.close()
    return frames_done, smallest_batch, timer.seconds()


def render_job(job_id: str, payload: dict, resume: bool = False,
               registry: JobRegistry = JOBS, base_folder: str | None = None,
               device="cuda"):
    """Full job flow (``VRGDG_StandaloneVideoEnhancerNodes.py:513-655``) on
    ``device``; a failure lands in the job's status, not in an
    exception."""
    cancel_event = registry.cancel_event(job_id)
    job_folder = os.path.join(jobs_folder(base_folder), job_id)
    segments_folder = os.path.join(job_folder, "segments")
    os.makedirs(segments_folder, exist_ok=True)
    try:
        device = resolve_device(device)
        source_path = video_io.normalize_video_path(payload.get("source_path"))
        metadata = video_io.probe_video(source_path)
        settings = EnhancerSettings.normalize(payload.get("settings"))
        out_w, out_h = output_dimensions(metadata["width"],
                                         metadata["height"],
                                         settings.upscale_resolution)
        fingerprint = mf.settings_fingerprint(source_path, settings.to_dict(),
                                              metadata["frame_count"])
        manifest = mf.read_manifest(job_folder) if resume else {}
        if manifest and manifest.get("fingerprint") != fingerprint:
            raise ValueError(
                "The source video or enhancement settings changed, so this "
                "job cannot resume.")

        mesh = mesh_for_settings(settings, device)
        frames_per_segment = max(1, int(round(
            float(metadata["fps"]) * settings.segment_seconds)))
        total_segments = max(1, int(math.ceil(
            metadata["frame_count"] / frames_per_segment)))
        completed = mf.prune_completed(manifest.get("completed_segments"),
                                       total_segments, segments_folder)
        completed_frames = sum(
            max(0, min(metadata["frame_count"],
                       (i + 1) * frames_per_segment) - i * frames_per_segment)
            for i in completed)

        manifest = {
            "version": 1,
            "job_id": job_id,
            "fingerprint": fingerprint,
            "source_path": source_path,
            "settings": settings.to_dict(),
            "metadata": metadata,
            "completed_segments": sorted(completed),
        }
        mf.write_manifest(job_folder, manifest)
        registry.update(
            job_id, status="running", stage="enhancing",
            source_path=source_path, metadata=metadata,
            settings=settings.to_dict(), output_width=out_w,
            output_height=out_h, frames_processed=completed_frames,
            total_frames=metadata["frame_count"],
            segment_index=len(completed), total_segments=total_segments,
            progress=(completed_frames / max(1, metadata["frame_count"])) * 0.94,
            can_resume=False, error="", device=str(device),
            message=f"Starting {out_w}×{out_h} batched enhancement…",
        )

        # ``stage_seconds`` in the live status is the current segment's
        # split (reset per checkpoint); ``stage_seconds_total`` accumulates
        # across the whole job so the final snapshot carries the full
        # decode/device/encode breakdown.
        stage_totals: dict[str, float] = {}
        for segment_index in range(total_segments):
            if segment_index in completed:
                continue
            if cancel_event.is_set():
                raise InterruptedError("Render canceled.")
            start = segment_index * frames_per_segment
            end = min(metadata["frame_count"], start + frames_per_segment)
            segment_path = os.path.join(
                segments_folder, mf.segment_file_name(segment_index))
            partial_path = segment_path + ".partial.mp4"
            if os.path.isfile(partial_path):
                os.remove(partial_path)
            registry.update(
                job_id, segment_index=segment_index + 1,
                message=(f"Enhancing checkpoint {segment_index + 1}/"
                         f"{total_segments}"))
            frames_done, _, segment_stages = _render_segment(
                source_path, partial_path, start, end, metadata, settings,
                job_id, cancel_event, registry, device=device, mesh=mesh)
            os.replace(partial_path, segment_path)
            completed.add(segment_index)
            manifest["completed_segments"] = sorted(completed)
            mf.write_manifest(job_folder, manifest)
            for stage, seconds in segment_stages.items():
                stage_totals[stage] = round(
                    stage_totals.get(stage, 0.0) + seconds, 6)
            registry.update(
                job_id,
                frames_processed=min(metadata["frame_count"],
                                     start + frames_done),
                stage_seconds_total=dict(stage_totals),
                segment_index=segment_index + 1)

        segment_paths = [
            os.path.join(segments_folder, mf.segment_file_name(i))
            for i in range(total_segments)
        ]
        stem = os.path.splitext(settings.output_name)[0] or "enhanced_video"
        output_name = f"{stem}_{time.strftime('%Y%m%d_%H%M%S')}.mp4"
        output_path = os.path.join(root_folder(base_folder), output_name)
        registry.update(job_id, stage="encoding", progress=0.95,
                        message="Joining segments and restoring audio…")
        concat_started = time.time()
        concat_result = video_io.concat_videos(
            segment_paths, output_path, metadata["fps"], out_w, out_h,
            source_audio_path=source_path,
            preserve_audio=settings.preserve_audio,
            crf=settings.encode_crf, preset=settings.encode_preset,
            cancel_event=cancel_event,
            log_path=os.path.join(job_folder, "ffmpeg.log"))
        stage_totals["concat"] = round(time.time() - concat_started, 6)
        output_metadata = video_io.probe_video(output_path)
        manifest.update(output_path=output_path, status="complete",
                        completed_segments=[], checkpoints_cleaned=True)
        mf.write_manifest(job_folder, manifest)
        shutil.rmtree(segments_folder, ignore_errors=True)
        registry.update(
            job_id, status="complete", stage="complete", progress=1.0,
            frames_processed=metadata["frame_count"],
            output_path=output_path, output_metadata=output_metadata,
            encode_backend=concat_result["backend"],
            audio_preserved=concat_result["audio"],
            stage_seconds_total=dict(stage_totals),
            checkpoints_cleaned=True, can_resume=False,
            message="Enhancement complete.")
    except InterruptedError as exc:
        registry.update(job_id, status="canceled", stage="canceled",
                        can_resume=True, error="", message=str(exc))
    except Exception as exc:  # noqa: BLE001 — the job thread's boundary
        registry.update(job_id, status="failed", stage="failed",
                        can_resume=True, error=str(exc),
                        message=f"Render failed: {exc}")


def render_job_shards(job_id: str, payload: dict, process_index: int,
                      process_count: int, registry: JobRegistry = JOBS,
                      base_folder: str | None = None,
                      wait_timeout: float = 900.0, device="cuda") -> dict:
    """Distributed segment scheduler: shard *segments across processes*.

    Every participating process computes the same segment plan from the
    shared payload; rank ``i`` renders segments ``i::process_count`` into
    the SHARED job folder with the same ``.partial.mp4`` -> ``os.replace``
    commit protocol as :func:`render_job` (its partial files carry the
    rank: ``.rank{i}.partial.mp4``), and rank 0, whose scan of committed
    files is the completion barrier, concatenates and finalizes once every
    segment file exists.  Within each rank's device step the frame axis
    may additionally be mesh-sharded (:func:`mesh_for_settings`), so the
    two sharding levels compose.

    Coordination is entirely filesystem-based (atomic renames in one
    shared folder): segments are independent and grain is seeded per
    absolute frame, so the output bytes do not depend on which process
    rendered which segment.  Resume works per rank by skipping committed
    files; a dead worker surfaces as rank 0's stall timeout with the
    missing segment list, and a job folder rendered under other settings
    is refused.  Rank 0 alone writes the manifest.

    Returns the final snapshot (rank 0) or a per-rank summary.
    """
    if process_count < 1 or not 0 <= process_index < process_count:
        raise ValueError("process_index/process_count are inconsistent.")
    device = resolve_device(device)
    cancel_event = registry.cancel_event(job_id)
    job_folder = os.path.join(jobs_folder(base_folder), job_id)
    segments_folder = os.path.join(job_folder, "segments")
    os.makedirs(segments_folder, exist_ok=True)

    source_path = video_io.normalize_video_path(payload.get("source_path"))
    metadata = video_io.probe_video(source_path)
    settings = EnhancerSettings.normalize(payload.get("settings"))
    out_w, out_h = output_dimensions(metadata["width"], metadata["height"],
                                     settings.upscale_resolution)
    fingerprint = mf.settings_fingerprint(source_path, settings.to_dict(),
                                          metadata["frame_count"])
    mesh = mesh_for_settings(settings, device)
    frames_per_segment = max(1, int(round(
        float(metadata["fps"]) * settings.segment_seconds)))
    total_segments = max(1, int(math.ceil(
        metadata["frame_count"] / frames_per_segment)))

    # Resume guard (same contract as render_job): a shared job folder
    # holding segments rendered under a DIFFERENT source/settings must
    # refuse, not silently mix old and new segments into one output.
    existing = mf.read_manifest(job_folder)
    if existing and existing.get("fingerprint") not in (None, fingerprint):
        raise ValueError(
            "The source video or enhancement settings changed, so this "
            "distributed job cannot resume; use a fresh job id.")

    if process_index == 0:
        # One manifest writer (rank 0) avoids read-modify-write races;
        # completion truth is the committed segment files themselves.
        mf.write_manifest(job_folder, {
            "version": 1, "job_id": job_id, "fingerprint": fingerprint,
            "source_path": source_path, "settings": settings.to_dict(),
            "metadata": metadata, "process_count": process_count,
            "total_segments": total_segments, "completed_segments": [],
        })

    def _committed(index: int) -> str:
        return os.path.join(segments_folder, mf.segment_file_name(index))

    mine = list(range(process_index, total_segments, process_count))
    rendered = []
    registry.update(job_id, status="running", stage="enhancing",
                    process_index=process_index,
                    process_count=process_count,
                    total_segments=total_segments,
                    segments_assigned=len(mine), device=str(device))
    for segment_index in mine:
        if cancel_event.is_set():
            raise InterruptedError("Render canceled.")
        segment_path = _committed(segment_index)
        if os.path.isfile(segment_path):
            continue  # resume: another run already committed it
        start = segment_index * frames_per_segment
        end = min(metadata["frame_count"], start + frames_per_segment)
        partial_path = (segment_path
                        + f".rank{process_index}.partial.mp4")
        if os.path.isfile(partial_path):
            os.remove(partial_path)
        _render_segment(source_path, partial_path, start, end, metadata,
                        settings, job_id, cancel_event, registry,
                        device=device, mesh=mesh)
        os.replace(partial_path, segment_path)
        rendered.append(segment_index)

    if process_index != 0:
        registry.update(job_id, status="complete", stage="complete",
                        message=f"rank {process_index} rendered "
                                f"{len(rendered)} segment(s)")
        return {"job_id": job_id, "process_index": process_index,
                "segments_rendered": rendered}

    # Rank 0: completion barrier = every segment file committed on disk.
    # ``wait_timeout`` is a STALL timeout, not a whole-job deadline: the
    # clock restarts every time another segment commits, so an
    # arbitrarily long job survives as long as workers keep making
    # progress and only a genuinely dead/stuck worker trips it.
    stall_started = time.time()
    missing_before = None
    while True:
        missing = [i for i in range(total_segments)
                   if not os.path.isfile(_committed(i))]
        if not missing:
            break
        if cancel_event.is_set():
            raise InterruptedError("Render canceled.")
        if missing_before is None or len(missing) < missing_before:
            missing_before = len(missing)
            stall_started = time.time()
        if time.time() - stall_started > float(wait_timeout):
            raise TimeoutError(
                f"Distributed render stalled for {wait_timeout:.0f}s "
                f"waiting for segments "
                f"{missing[:8]}{'...' if len(missing) > 8 else ''} — a "
                "worker process likely died; re-run to resume.")
        time.sleep(0.2)

    stem = os.path.splitext(settings.output_name)[0] or "enhanced_video"
    output_name = f"{stem}_{time.strftime('%Y%m%d_%H%M%S')}.mp4"
    output_path = os.path.join(root_folder(base_folder), output_name)
    concat_result = video_io.concat_videos(
        [_committed(i) for i in range(total_segments)], output_path,
        metadata["fps"], out_w, out_h, source_audio_path=source_path,
        preserve_audio=settings.preserve_audio, crf=settings.encode_crf,
        preset=settings.encode_preset, cancel_event=cancel_event,
        log_path=os.path.join(job_folder, "ffmpeg.log"))
    output_metadata = video_io.probe_video(output_path)
    mf.write_manifest(job_folder, {
        "version": 1, "job_id": job_id, "fingerprint": fingerprint,
        "source_path": source_path, "settings": settings.to_dict(),
        "metadata": metadata, "process_count": process_count,
        "total_segments": total_segments, "completed_segments": [],
        "output_path": output_path, "status": "complete",
        "checkpoints_cleaned": True,
    })
    shutil.rmtree(segments_folder, ignore_errors=True)
    registry.update(job_id, status="complete", stage="complete",
                    progress=1.0, output_path=output_path,
                    output_metadata=output_metadata,
                    encode_backend=concat_result["backend"],
                    audio_preserved=concat_result["audio"])
    return registry.snapshot(job_id)


def start_render(payload: dict, resume_job_id: str = "",
                 registry: JobRegistry = JOBS,
                 base_folder: str | None = None, device="cuda") -> dict:
    """Queue a render job on a daemon thread with the reference's
    single-active-job and resume-rehydration semantics
    (``VRGDG_StandaloneVideoEnhancerNodes.py:658-711``).  A CUDA
    ``device`` without a visible card raises here."""
    device = resolve_device(device)
    resume_job_id = str(resume_job_id or "").strip()
    active = registry.active_job(excluding=resume_job_id)
    if active:
        raise ValueError(
            f"Enhancement job {active.get('job_id')} is already running. "
            "Wait for it to finish or cancel it first.")
    if resume_job_id:
        job_id = resume_job_id
        existing = registry.snapshot(job_id)
        if existing.get("status") in {"running", "encoding"}:
            raise ValueError("That enhancement job is already running.")
        if not existing or not (payload or {}).get("source_path"):
            # job lost from memory (process restart) or the caller sent no
            # payload: rehydrate from the on-disk manifest
            job_folder = os.path.join(jobs_folder(base_folder), job_id)
            manifest = mf.read_manifest(job_folder)
            if not manifest:
                raise ValueError(
                    "The requested render checkpoint was not found.")
            payload = {"source_path": manifest.get("source_path"),
                       "settings": manifest.get("settings")}
    else:
        job_id = (f"enhancer_{time.strftime('%Y%m%d_%H%M%S')}_"
                  f"{uuid.uuid4().hex[:8]}")
    cancel = registry.cancel_event(job_id)
    cancel.clear()
    registry.update(job_id, status="queued", stage="queued", progress=0.0,
                    created_at=time.time(), can_resume=False,
                    message="Queued…")
    thread = threading.Thread(
        target=render_job, args=(job_id, payload, bool(resume_job_id)),
        kwargs={"registry": registry, "base_folder": base_folder,
                "device": device},
        daemon=True, name=f"VRGDGTorchEnhancer-{job_id}")
    registry.attach(job_id, "thread", thread)
    thread.start()
    return registry.snapshot(job_id)


def cancel_render(job_id: str, registry: JobRegistry = JOBS) -> dict:
    event = registry.get_cancel(job_id)
    if event is None:
        raise ValueError("Enhancement job was not found.")
    event.set()
    return registry.snapshot(job_id)


def preview_frame(source_path: str, timestamp: float, settings,
                  base_folder: str | None = None, device="cuda") -> dict:
    """Render a before/after PNG pair for one frame
    (``VRGDG_StandaloneVideoEnhancerNodes.py:714-753``)."""
    import cv2

    settings = (settings if isinstance(settings, EnhancerSettings)
                else EnhancerSettings.normalize(settings))
    source_path = video_io.normalize_video_path(source_path)
    metadata = video_io.probe_video(source_path)
    capture = cv2.VideoCapture(source_path)
    try:
        # ms-accurate seek first, then fall back to the first frame
        seeks = ((cv2.CAP_PROP_POS_MSEC,
                  max(0.0, float(timestamp)) * 1000.0),
                 (cv2.CAP_PROP_POS_FRAMES, 0.0))
        for prop, position in seeks:
            capture.set(prop, position)
            ok, frame = capture.read()
            if ok:
                break
        else:
            raise RuntimeError("Could not decode the selected preview frame.")
    finally:
        capture.release()
    frame_index = max(0, min(metadata["frame_count"] - 1,
                             int(round(float(timestamp) * metadata["fps"]))))
    out_w, out_h = output_dimensions(metadata["width"], metadata["height"],
                                     settings.upscale_resolution)
    batch = video_io.frames_to_array([frame])
    enhanced = apply_effects_batch(batch, settings, out_h, out_w, frame_index,
                                   device=device)
    after = video_io.array_to_frames(enhanced)[0]

    token = f"preview_{uuid.uuid4().hex}"
    before_path = os.path.join(preview_folder(base_folder),
                               f"{token}_before.png")
    after_path = os.path.join(preview_folder(base_folder),
                              f"{token}_after.png")
    if not cv2.imwrite(before_path, frame) or not cv2.imwrite(after_path, after):
        raise RuntimeError("Could not save the preview images.")
    return {
        "before_path": before_path,
        "after_path": after_path,
        "timestamp": max(0.0, float(timestamp)),
        "frame_index": frame_index,
        "metadata": metadata,
        "output_width": out_w,
        "output_height": out_h,
    }
