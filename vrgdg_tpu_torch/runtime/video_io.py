"""Host-side media I/O: probing, batched decode, codec-fallback encode, and
the uint8 <-> float conversions on the device.

Counterpart of the parts of :mod:`vrgdg_tpu.runtime.video_io` that the
appliers use.  OpenCV handles decode/encode on the CPU and is imported
lazily, so the package imports (and the in-memory main path runs) on a
machine without it.  Frames cross the host/device boundary as uint8 both
ways (4x fewer bytes than float32); :func:`dequantize_on_device` and
:func:`quantize_on_device` convert on the device.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import subprocess
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

VIDEO_EXTENSIONS = {".mp4", ".mov", ".mkv", ".webm", ".avi", ".m4v"}

# Preference order from the reference (VRGDG_LUTVideoTools.py:26-31).
CODEC_CANDIDATES = ("avc1", "H264", "X264", "mp4v")


def normalize_video_path(value) -> str:
    path = os.path.normpath(os.path.abspath(str(value or "").strip().strip('"')))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Video file was not found: {path}")
    if os.path.splitext(path)[1].lower() not in VIDEO_EXTENSIONS:
        raise ValueError(
            "Unsupported video type. Use MP4, MOV, MKV, WEBM, AVI, or M4V.")
    return path


def find_ffmpeg() -> str | None:
    return shutil.which("ffmpeg")


def media_has_audio(path: str) -> bool | None:
    """True/False when ffprobe is available, None otherwise."""
    ffprobe = shutil.which("ffprobe")
    if not ffprobe:
        return None
    try:
        result = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=index", "-of", "csv=p=0", path],
            capture_output=True, text=True, errors="replace", timeout=30,
            check=False)
        return bool(result.returncode == 0 and (result.stdout or "").strip())
    except (OSError, subprocess.SubprocessError):
        return None


def probe_video(path) -> dict:
    """Metadata dict with the same fields as the reference's ``_probe_video``
    (``VRGDG_StandaloneVideoEnhancerNodes.py:107-139``)."""
    import cv2

    path = normalize_video_path(path)
    capture = cv2.VideoCapture(path)
    try:
        if not capture.isOpened():
            raise ValueError("The video could not be opened.")
        width, height, frame_count = (
            int(capture.get(prop) or 0)
            for prop in (cv2.CAP_PROP_FRAME_WIDTH, cv2.CAP_PROP_FRAME_HEIGHT,
                         cv2.CAP_PROP_FRAME_COUNT))
        fps = float(capture.get(cv2.CAP_PROP_FPS) or 0)
        if width < 1 or height < 1 or fps <= 0:
            raise ValueError(
                "The video does not contain readable dimensions or frame-rate "
                "metadata.")
        fourcc = int(capture.get(cv2.CAP_PROP_FOURCC) or 0)
        codec = "".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)).strip()
    finally:
        capture.release()
    stat = os.stat(path)
    return {
        "path": path, "name": os.path.basename(path),
        "width": width, "height": height,
        "fps": fps, "frame_count": frame_count,
        "duration": frame_count / fps if frame_count > 0 else 0.0,
        "codec": codec, "has_audio": media_has_audio(path),
        "size": int(stat.st_size), "mtime": float(stat.st_mtime),
    }


def array_to_frames(array: np.ndarray) -> list[np.ndarray]:
    """BHWC RGB -> list of BGR uint8 frames.  Accepts float [0,1]
    (quantized here as ``clip(x*255).astype(uint8)``) or uint8 (already
    quantized on the device)."""
    array = np.asarray(array)
    if array.dtype == np.uint8:
        u8 = array
    else:
        u8 = np.clip(array * 255.0, 0, 255).astype(np.uint8)
    return [np.ascontiguousarray(frame[..., ::-1]) for frame in u8]


def frames_to_rgb_u8(frames: list[np.ndarray]) -> np.ndarray:
    """BGR uint8 frame list -> BHWC uint8 RGB (no float conversion)."""
    stacked = np.stack(frames, axis=0)
    return np.ascontiguousarray(stacked[..., ::-1])


def quantize_on_device(frames: torch.Tensor) -> torch.Tensor:
    """[0,1] float tensor -> uint8 on its device; the cast truncates like
    numpy's ``astype(uint8)`` in :func:`array_to_frames`."""
    return torch.clamp(frames * 255.0, 0, 255).to(torch.uint8)


def dequantize_on_device(frames: torch.Tensor) -> torch.Tensor:
    """uint8 tensor -> [0,1] float32 on its device; float input passes
    through."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) / 255.0
    return frames


class VideoReader:
    """Batched frame reader over a video file.

    Yields ``(first_frame_index, batch)`` with BHWC uint8 RGB batches of
    ``batch_size`` frames (the final batch may be short); the appliers
    convert to float on the device.
    """

    def __init__(self, path, batch_size: int = 8,
                 start_frame: int = 0, end_frame: int | None = None):
        import cv2

        self.path = normalize_video_path(path)
        self.batch_size = max(1, int(batch_size))
        self._capture = cv2.VideoCapture(self.path)
        if not self._capture.isOpened():
            raise RuntimeError(f"Could not open video: {self.path}")
        self.start_frame = max(0, int(start_frame))
        if self.start_frame:
            self._capture.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
        self.end_frame = end_frame
        self._position = self.start_frame

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        while True:
            limit = self.batch_size
            if self.end_frame is not None:
                limit = min(limit, self.end_frame - self._position)
                if limit <= 0:
                    return
            frames = []
            for _ in range(limit):
                ok, frame = self._capture.read()
                if not ok:
                    break
                frames.append(frame)
            if not frames:
                return
            start = self._position
            self._position += len(frames)
            yield start, frames_to_rgb_u8(frames)

    def close(self):
        self._capture.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _try_open_writer(path: str, codec: str, fps: float,
                     width: int, height: int):
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec),
                             float(fps), (int(width), int(height)))
    if writer.isOpened():
        return writer
    writer.release()
    return None


def validate_video_readable(path: str) -> bool:
    """Read-back check used by the codec fallback chain
    (``VRGDG_LUTVideoTools.py:761-771``)."""
    import cv2

    if not os.path.isfile(path) or os.path.getsize(path) <= 0:
        return False
    capture = cv2.VideoCapture(path)
    try:
        if not capture.isOpened():
            return False
        ok, _ = capture.read()
        return bool(ok)
    finally:
        capture.release()


class VideoWriter:
    """cv2 writer with the reference's codec preference order; the first
    codec that opens is used."""

    def __init__(self, path, fps: float, width: int, height: int,
                 codecs: tuple[str, ...] = CODEC_CANDIDATES):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = os.fspath(path)
        self.codec = None
        self._writer = None
        for codec in codecs:
            writer = _try_open_writer(self.path, codec, fps, width, height)
            if writer is not None:
                self._writer, self.codec = writer, codec
                break
        if self._writer is None:
            raise RuntimeError(
                f"No available codec could encode {self.path} "
                f"(tried {', '.join(codecs)}).")
        self.frames_written = 0

    def write_array(self, array: np.ndarray):
        for frame in array_to_frames(array):
            self._writer.write(frame)
            self.frames_written += 1

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video_with_fallback(path, fps: float, width: int, height: int,
                              produce_batches: Callable[[], Iterator[np.ndarray]],
                              codecs: tuple[str, ...] = CODEC_CANDIDATES) -> str:
    """Encode with each candidate codec until the output validates on
    read-back, re-running the producer per attempt
    (``VRGDG_LUTVideoTools.py:966-1023`` semantics)."""
    last_error = None
    for codec in codecs:
        try:
            with VideoWriter(path, fps, width, height, (codec,)) as writer:
                for batch in produce_batches():
                    writer.write_array(batch)
            if validate_video_readable(path):
                return codec
            last_error = RuntimeError(f"Codec {codec} produced unreadable output.")
        except RuntimeError as exc:
            last_error = exc
        with contextlib.suppress(OSError):
            os.remove(path)
    raise RuntimeError(f"All codecs failed for {path}: {last_error}")


class PrefetchingReader:
    """Decode-ahead wrapper: a background thread keeps ``depth`` decoded
    batches queued so device compute overlaps host decode."""

    _SENTINEL = object()

    def __init__(self, reader: VideoReader, depth: int = 2):
        self._reader = reader
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts when :meth:`close` sets the stop flag
        (so the pump never deadlocks against a departed consumer)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self):
        try:
            for item in self._reader:
                if not self._put(item):
                    return
        except BaseException as exc:  # propagated on next __iter__ step
            if not self._stop.is_set():
                self._error = exc
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def close(self):
        # cv2 capture release is not safe concurrent with capture.read(),
        # so stop the pump, unblock any pending put, and join it before
        # releasing the underlying reader.  If the pump refuses to exit
        # (a wedged decoder read), leak the capture rather than release
        # it under a live reader.
        self._stop.set()
        deadline = time.time() + 60.0
        while True:
            with contextlib.suppress(queue.Empty):
                while True:
                    self._queue.get_nowait()
            self._thread.join(timeout=2)
            if not self._thread.is_alive():
                self._reader.close()
                return
            if time.time() >= deadline:
                return

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
