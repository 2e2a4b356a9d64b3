"""Host-side audio utilities: silent-WAV synthesis and peak envelopes.

A copy of :mod:`vrgdg_tpu.runtime.audio` (numpy and ``wave``, no device
work), held equal to it by ``tests/test_torch_host_copies.py``.

Parity targets: ``VRGDG_SilentAudioRoutes.py:20-95`` (silence generator
with project/scene scoping) and the peak-envelope shape its responses
carry from the music builder's ``_read_audio_peaks``.  Peaks here are
computed with the stdlib ``wave`` module (16-bit PCM), no audio ML — the
Demucs/Whisper stacks are out of scope (SURVEY.md section 2.5).
"""

from __future__ import annotations

import os
import wave

import numpy as np


def clean_duration(value) -> float:
    try:
        duration = float(value)
    except (TypeError, ValueError):
        duration = 0.0
    if duration <= 0:
        raise ValueError("Silence duration must be greater than 0 seconds.")
    return max(0.1, min(duration, 24 * 60 * 60))


def duration_label(duration: float) -> str:
    text = f"{duration:.2f}".rstrip("0").rstrip(".")
    return text.replace(".", "_")


def write_silent_wav(path: str, duration: float, sample_rate: int = 44100,
                     channels: int = 2) -> str:
    """Chunked 16-bit PCM silence writer
    (``VRGDG_SilentAudioRoutes.py:42-57``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    total_frames = int(round(float(duration) * sample_rate))
    frame = b"\x00\x00" * channels
    with wave.open(path, "wb") as handle:
        handle.setnchannels(channels)
        handle.setsampwidth(2)
        handle.setframerate(sample_rate)
        remaining = total_frames
        while remaining > 0:
            count = min(sample_rate, remaining)
            handle.writeframes(frame * count)
            remaining -= count
    if not os.path.isfile(path) or os.path.getsize(path) <= 0:
        raise ValueError("Silent WAV file was not created.")
    return path


def read_audio_peaks(path: str, target_peaks: int = 600) -> dict:
    """Downsampled absolute-peak envelope normalized to [0, 1]; the
    payload shape the builder UI draws waveforms from.

    16-bit PCM WAV takes the original fast stdlib path; anything else
    (24-bit/float WAV, mp3/m4a/... when ffmpeg exists) decodes through
    :mod:`vrgdg_tpu_torch.runtime.audio_toolkit` — the reference computes
    peaks from arbitrary media, not just 16-bit WAV."""
    magnitudes, sample_rate, frame_count = None, 0, 0
    try:
        with wave.open(path, "rb") as handle:
            if handle.getsampwidth() == 2:
                channels = handle.getnchannels()
                sample_rate = handle.getframerate()
                frame_count = handle.getnframes()
                raw = handle.readframes(frame_count)
                samples = np.frombuffer(raw, dtype="<i2")
                # abs BEFORE the channel collapse: a loud negative
                # excursion on one channel must register as a peak.
                # Clip: abs(-32768)/32767 is 1.00003, outside the
                # normalized [0, 1] payload contract.
                magnitudes = np.minimum(
                    np.abs(samples.astype(np.int32)) / 32767.0, 1.0)
                if channels > 1:
                    magnitudes = magnitudes.reshape(-1, channels).max(axis=1)
    except wave.Error:
        pass
    if magnitudes is None:
        from .audio_toolkit import decode_audio_file

        channels_t, sample_rate = decode_audio_file(path)
        frame_count = channels_t.shape[-1]
        # IEEE-float sources can carry inter-sample peaks beyond 1.0;
        # the payload contract is normalized [0, 1].
        magnitudes = np.clip(np.abs(channels_t).max(axis=0), 0.0, 1.0)

    duration = frame_count / float(sample_rate) if sample_rate else 0.0
    target_peaks = max(1, int(target_peaks))
    if magnitudes.size == 0:
        peaks = [0.0] * target_peaks
    else:
        bucket = max(1, magnitudes.size // target_peaks)
        usable = (magnitudes.size // bucket) * bucket
        blocks = magnitudes[:usable].reshape(-1, bucket)
        peaks = np.round(blocks.max(axis=1), 4).tolist()
    return {"duration": duration, "sample_rate": sample_rate,
            "peaks": peaks, "beats": []}


def create_silent_audio(payload: dict) -> dict:
    """Project/scene-scoped silence generator with the reference's naming
    and response schema (``VRGDG_SilentAudioRoutes.py:60-95``)."""
    raw_folder = str(payload.get("project_folder", "") or "").strip() \
        .strip('"')
    if not raw_folder:
        raise ValueError("Project folder is empty.")
    project_folder = os.path.abspath(raw_folder)
    os.makedirs(project_folder, exist_ok=True)

    duration = clean_duration(payload.get("duration"))
    scope = str(payload.get("scope") or "project").strip().lower()
    if scope != "scene":
        scope = "project"
    try:
        scene_number = max(1, int(payload.get("scene_number") or 1))
    except (TypeError, ValueError):
        scene_number = 1
    if scope != "scene":
        scene_number = 0

    # (subfolder, filename, display label, envelope resolution) per scope
    variants = {
        "scene": ("scene_audio", f"audio_{scene_number:04d}.wav",
                  f"Silence {duration:.2f}s", 600),
        "project": ("project_audio",
                    f"project_silence_{duration_label(duration)}s.wav",
                    f"Silent timeline {duration:.2f}s", 1600),
    }
    subfolder, filename, display_name, target_peaks = variants[scope]
    folder = os.path.join(project_folder, subfolder)
    path = os.path.join(folder, filename)

    write_silent_wav(path, duration)
    info = read_audio_peaks(path, target_peaks)
    return {
        "audio_path": path,
        "saved_path": path,
        "audio_folder": folder,
        "audio_name": display_name,
        "scope": scope,
        "scene_number": scene_number,
        **info,
    }
