"""Audio toolkit: load, split (duration- and SRT-driven), delay, concat.

A copy of :mod:`vrgdg_tpu.runtime.audio_toolkit` (numpy and ``wave``, no
device work), held equal to it by ``tests/test_torch_host_copies.py``.

Re-derivation of the reference pack's waveform plumbing without librosa
or torchaudio:

- :func:`load_audio` mirrors ``nodes.py:594-625`` (``load_audio``): file
  -> ``{"waveform": (1, C, T) float32, "sample_rate": int}`` with
  offset/duration windows and mono->stereo duplication.  Decoding is a
  self-contained RIFF/WAV parser (PCM 8/16/24/32 and IEEE float 32/64);
  other containers fall back to an ``ffmpeg`` pipe when the binary
  exists and raise a clear error otherwise.
- :func:`split_audio_by_durations` mirrors ``VRGDG_LoadAudioSplitDynamic``
  (``nodes.py:426-585``): cumulative per-scene starts from an offset,
  optional InfiniteTalk padding mode (load at most the 8 s internal
  chunk, zero-pad up to it), per-segment gain, and the meta dict.
- :func:`parse_srt` + :func:`split_audio_srt` mirror the timing core of
  ``VRGDG_LoadAudioSplit_SRTOnly`` (``GeneralVideoNodes2.py:29-620``):
  SRT (or fixed-duration) segments, frame-snapped boundaries, preroll /
  tail-loss frames, the LTX 8N+1 frame padding, final-only resample to
  44.1 kHz, and exact sample-count forcing.
- :func:`delay_audio_by_index` mirrors ``VRGDG_AudioDelayByIndex``
  (``GeneralVideoNodes2.py:827-866``): front-pad (or trim) every chunk
  except index 0.

Waveforms are numpy ``(1, C, T)`` float32 in [-1, 1] — the reference's
AUDIO tensor contract with numpy in place of torch.  Resampling uses
scipy's polyphase resampler (windowed sinc) when scipy is available and
linear interpolation otherwise.
"""

from __future__ import annotations

import math
import os
import re
import shutil
import struct
import subprocess
import wave

import numpy as np

INTERNAL_CHUNK_DURATION = 8.0
LTX_TARGET_SR = 44100


def db_to_scalar(db: float) -> float:
    """Decibel gain to linear scalar (``nodes.py:590-592``)."""
    return 10.0 ** (float(db) / 20.0)


def round_up_8n1(n: int) -> int:
    """Round a frame count up to the next ``8N+1``
    (``GeneralVideoNodes2.py:16-19``, the LTX conditioning constraint)."""
    n = max(1, int(n))
    return ((n - 1 + 7) // 8) * 8 + 1


def adjust_frames_humo(frames: int) -> int:
    """Quantize a scene frame count to HuMo's ``4N+1`` constraint
    (``HumoAutomationExtra2.py:148-153``): the nearest 4N+1 value,
    rounding .5 cases up (``4*((frames+2)//4)+1``)."""
    return 4 * ((int(frames) + 2) // 4) + 1


# --------------------------------------------------------------------------
# decode / encode
# --------------------------------------------------------------------------

def _decode_wav(path: str) -> tuple[np.ndarray, int]:
    """RIFF/WAV -> ``(channels, samples)`` float32 in [-1, 1].

    Handles PCM 8 (unsigned) / 16 / 24 / 32-bit and IEEE float 32/64 —
    wider coverage than the stdlib ``wave`` module (which rejects float
    and mishandles nothing but also exposes no 24-bit decode).
    """
    with open(path, "rb") as handle:
        riff = handle.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        audio_format = channels = rate = bits = None
        data = None
        while True:
            header = handle.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = header[:4], \
                struct.unpack("<I", header[4:])[0]
            if chunk_id == b"fmt ":
                fmt = handle.read(chunk_size)
                if len(fmt) < 16:  # struct.error would escape ValueError
                    raise ValueError(f"Truncated WAV fmt chunk: {path}")
                audio_format, channels, rate = \
                    struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
                if audio_format == 0xFFFE and chunk_size >= 40:  # extensible
                    audio_format = struct.unpack("<H", fmt[24:26])[0]
            elif chunk_id == b"data":
                data = handle.read(chunk_size)
            else:
                handle.seek(chunk_size + (chunk_size & 1), os.SEEK_CUR)
            if data is not None and audio_format is not None:
                break
    if data is None or audio_format is None:
        raise ValueError(f"WAV file has no fmt/data chunks: {path}")

    if audio_format == 1:  # integer PCM
        if bits == 8:
            samples = (np.frombuffer(data, np.uint8).astype(np.float32)
                       - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8)
            raw = raw[: raw.size - raw.size % 3].reshape(-1, 3)
            as_int = (raw[:, 0].astype(np.int32)
                      | raw[:, 1].astype(np.int32) << 8
                      | raw[:, 2].astype(np.int32) << 16)
            as_int -= (as_int & 0x800000) << 1  # sign-extend
            samples = as_int.astype(np.float32) / 8388608.0
        elif bits == 32:
            samples = np.frombuffer(data, "<i4").astype(np.float32) \
                / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM width: {bits} bits")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(data, dtype).astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format code: {audio_format}")

    channels = max(1, int(channels))
    samples = samples[: samples.size - samples.size % channels]
    return samples.reshape(-1, channels).T.copy(), int(rate)


def _decode_via_ffmpeg(path: str, target_sr: int | None = None
                       ) -> tuple[np.ndarray, int]:
    """Decode any container ffmpeg understands to float32 PCM via a pipe.
    Raises with a clear message when no ffmpeg binary exists (this image
    ships none; WAV stays fully supported without it)."""
    binary = shutil.which("ffmpeg")
    if not binary:
        raise ValueError(
            f"Cannot decode '{os.path.basename(path)}': not a WAV file and "
            "no ffmpeg binary is available on this host.")
    probe = shutil.which("ffprobe")
    rate, channels = 44100, 2
    if probe:
        out = subprocess.run(
            [probe, "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=sample_rate,channels",
             "-of", "csv=p=0", path],
            capture_output=True, text=True, timeout=60)
        parts = (out.stdout or "").strip().split(",")
        if len(parts) == 2 and parts[0].isdigit():
            rate, channels = int(parts[0]), max(1, int(parts[1]))
    rate = int(target_sr) if target_sr else rate
    cmd = [binary, "-v", "error", "-i", path, "-f", "f32le",
           "-acodec", "pcm_f32le", "-ar", str(rate),
           "-ac", str(channels), "pipe:1"]
    out = subprocess.run(cmd, capture_output=True, timeout=600)
    if out.returncode != 0:
        raise ValueError(
            f"ffmpeg decode failed: {out.stderr.decode()[-300:]}")
    samples = np.frombuffer(out.stdout, "<f4")
    samples = samples[: samples.size - samples.size % channels]
    return samples.reshape(-1, channels).T.copy(), rate


def decode_audio_file(path: str) -> tuple[np.ndarray, int]:
    """``(channels, samples) float32, sample_rate`` from any supported
    file: native WAV parse first, ffmpeg pipe for everything else."""
    path = str(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Audio file was not found: {path}")
    try:
        return _decode_wav(path)
    except ValueError:
        if path.lower().endswith(".wav"):
            raise
    return _decode_via_ffmpeg(path)


def resample_waveform(wave_ct: np.ndarray, source_sr: int,
                      target_sr: int) -> np.ndarray:
    """Polyphase (windowed-sinc) resample of a ``(..., T)`` waveform;
    linear interpolation fallback when scipy is unavailable."""
    source_sr, target_sr = int(source_sr), int(target_sr)
    if source_sr == target_sr or wave_ct.shape[-1] == 0:
        return wave_ct
    try:
        from scipy.signal import resample_poly

        gcd = math.gcd(target_sr, source_sr)
        return resample_poly(wave_ct, target_sr // gcd, source_sr // gcd,
                             axis=-1).astype(np.float32)
    except ImportError:
        length = wave_ct.shape[-1]
        new_length = int(round(length * target_sr / source_sr))
        old_t = np.arange(length) / source_sr
        new_t = np.arange(new_length) / target_sr
        flat = wave_ct.reshape(-1, length)
        out = np.stack([np.interp(new_t, old_t, row) for row in flat])
        return out.reshape(*wave_ct.shape[:-1], new_length) \
            .astype(np.float32)


def save_wav(path: str, audio: dict, bits: int = 16) -> str:
    """Write an AUDIO dict to a 16-bit PCM WAV."""
    waveform, rate = as_waveform(audio)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    clipped = np.clip(waveform[0].T, -1.0, 1.0)  # (T, C)
    pcm = (clipped * 32767.0).round().astype("<i2")
    with wave.open(path, "wb") as handle:
        handle.setnchannels(pcm.shape[1])
        handle.setsampwidth(2)
        handle.setframerate(int(rate))
        handle.writeframes(pcm.tobytes())
    return path


# --------------------------------------------------------------------------
# AUDIO dict plumbing
# --------------------------------------------------------------------------

def as_waveform(audio) -> tuple[np.ndarray, int]:
    """Normalize any accepted audio form to ``((1, C, T) float32, sr)``."""
    if isinstance(audio, dict):
        waveform, rate = audio.get("waveform"), audio.get("sample_rate")
    elif isinstance(audio, (tuple, list)) and len(audio) == 2:
        waveform, rate = audio
    else:
        raise ValueError("Expected an AUDIO dict or (waveform, rate) pair.")
    if hasattr(waveform, "detach"):
        waveform = waveform.detach().cpu().numpy()
    waveform = np.asarray(waveform, np.float32)
    if waveform.ndim == 1:
        waveform = waveform[None, None]
    elif waveform.ndim == 2:
        waveform = waveform[None]
    elif waveform.ndim != 3:
        raise ValueError(f"Waveform rank {waveform.ndim} is not 1/2/3.")
    return waveform, int(rate or 0)


def make_audio(waveform: np.ndarray, sample_rate: int) -> dict:
    return {"waveform": np.asarray(waveform, np.float32),
            "sample_rate": int(sample_rate)}


def load_audio(path: str, offset: float = 0.0,
               duration: float | None = None, make_stereo: bool = True,
               target_sr: int | None = None) -> dict:
    """File -> AUDIO dict (``nodes.py:594-625`` contract): optional
    offset/duration window in seconds, mono duplicated to stereo, >2
    channels rejected when ``make_stereo``."""
    channels_t, rate = decode_audio_file(path)
    if target_sr and int(target_sr) != rate:
        channels_t = resample_waveform(channels_t, rate, int(target_sr))
        rate = int(target_sr)
    start = max(0, int(round(float(offset) * rate)))
    end = channels_t.shape[-1]
    if duration is not None:
        end = min(end, start + max(0, int(round(float(duration) * rate))))
    window = channels_t[:, start:end]
    if make_stereo:
        if window.shape[0] == 1:
            window = np.repeat(window, 2, axis=0)
        elif window.shape[0] != 2:
            raise ValueError(
                f"Unsupported channel count: {window.shape[0]}")
    return make_audio(window[None], rate)


def audio_duration(audio) -> float:
    waveform, rate = as_waveform(audio)
    return waveform.shape[-1] / float(max(1, rate))


def concat_audio(segments) -> dict:
    """Concatenate AUDIO segments along time (equal rates/channels)."""
    waves, rates = zip(*(as_waveform(s) for s in segments))
    if len(set(rates)) != 1:
        raise ValueError(f"Sample rates differ: {sorted(set(rates))}")
    channels = max(w.shape[1] for w in waves)
    waves = [np.repeat(w, channels, axis=1) if w.shape[1] == 1 else w
             for w in waves]
    return make_audio(np.concatenate(waves, axis=-1), rates[0])


# --------------------------------------------------------------------------
# splitters
# --------------------------------------------------------------------------

def split_audio_by_durations(audio, durations, offset_seconds: float = 0.0,
                             pad_to_chunk: bool = False,
                             chunk_duration: float = INTERNAL_CHUNK_DURATION,
                             gain_db: float = 0.0) -> dict:
    """Scene-duration splitter (``VRGDG_LoadAudioSplitDynamic.split_audio``,
    ``nodes.py:478-585``).

    Starts are cumulative from ``offset_seconds``.  ``pad_to_chunk`` is
    the InfiniteTalk mode: each segment loads at most ``chunk_duration``
    seconds (clamped to the audio tail) and is zero-padded up to exactly
    ``chunk_duration``.  Returns ``{"meta", "total_duration",
    "segments"}`` with the reference's meta fields.
    """
    waveform, rate = as_waveform(audio)
    total_samples = waveform.shape[-1]
    total_duration = total_samples / float(max(1, rate))
    durations = [max(0.0, float(d)) for d in durations]
    starts = np.concatenate(
        [[float(offset_seconds)],
         float(offset_seconds) + np.cumsum(durations)[:-1]]).tolist() \
        if durations else []
    gain = db_to_scalar(gain_db) if gain_db else 1.0
    target_length = int(chunk_duration * rate)

    segments = []
    for start_time, requested in zip(starts, durations):
        load_duration = requested if not pad_to_chunk else \
            min(chunk_duration, max(0.0, total_duration - start_time))
        start = max(0, int(round(start_time * rate)))
        end = min(total_samples,
                  start + int(round(load_duration * rate)))
        segment = waveform[..., start:end].copy()
        if gain != 1.0:
            segment *= gain
        if pad_to_chunk and segment.shape[-1] < target_length:
            pad = target_length - segment.shape[-1]
            segment = np.pad(segment, [(0, 0), (0, 0), (0, pad)])
        segments.append(make_audio(segment, rate))

    meta = {"scene_count": len(durations), "durations": durations,
            "offset_seconds": float(offset_seconds), "starts": starts,
            "sample_rate": rate,
            "internal_chunk_duration": float(chunk_duration),
            "audio_total_duration": total_duration,
            "outputs_count": len(segments), "used_padding": pad_to_chunk}
    return {"meta": meta, "total_duration": total_duration,
            "segments": segments}


def parse_srt(source: str) -> list[tuple[float, float]]:
    """``(start, end)`` seconds per SRT block; accepts a path or raw text
    (``GeneralVideoNodes2.py:281-310``)."""
    text = source
    if "\n" not in str(source) and os.path.isfile(str(source)):
        with open(source, "r", encoding="utf-8") as handle:
            text = handle.read()

    def seconds(stamp: str) -> float:
        hours, minutes, rest = stamp.strip().split(":")
        secs, millis = rest.replace(".", ",").split(",")
        return (int(hours) * 3600 + int(minutes) * 60 + int(secs)
                + int(millis) / 1000.0)

    segments = []
    for block in str(text).strip().split("\n\n"):
        lines = block.splitlines()
        if len(lines) >= 2 and "-->" in lines[1]:
            start_txt, end_txt = lines[1].split("-->")
            segments.append((seconds(start_txt), seconds(end_txt)))
    if not segments:
        raise ValueError("No valid SRT entries found")
    return segments


def srt_segments_for_audio(audio, srt_source: str | None = None,
                           fixed_duration: float = 0.0) -> list[tuple]:
    """Segment list for a chunked run: fixed-length windows over the full
    duration, or SRT entries with the final scene extended to the audio
    end (``GeneralVideoNodes2.py:346-368``)."""
    total = audio_duration(audio)
    if fixed_duration and float(fixed_duration) > 0:
        dur = float(fixed_duration)
        count = int(math.ceil(total / dur))
        return [(i * dur, min((i + 1) * dur, total)) for i in range(count)]
    segments = parse_srt(srt_source)
    last_start, last_end = segments[-1]
    if last_end < total:
        segments[-1] = (last_start, total)
    return segments


def split_audio_srt(audio, chunk_index: int, srt_source: str | None = None,
                    fixed_duration: float = 0.0, fps: int = 24,
                    tail_loss_frames: int = 5, pre_frames: int = 0,
                    target_sr: int = LTX_TARGET_SR) -> dict:
    """Frame-locked SRT chunk extraction — the timing core of
    ``VRGDG_LoadAudioSplit_SRTOnly.run`` (``GeneralVideoNodes2.py:
    464-620``).

    Boundaries snap to frame indices (``round(sec * fps)``), the window
    grows by ``pre_frames`` of preroll (skipped for a chunk-0 SRT that
    starts at zero) and ``tail_loss_frames`` at the back, the LTX frame
    count rounds up to 8N+1, the slice is resampled to ``target_sr``
    *after* cutting, and the sample count is forced to exactly
    ``frames_for_ltx / fps`` seconds so LTX padding cannot drift.
    """
    waveform, rate = as_waveform(audio)
    segments = srt_segments_for_audio(audio, srt_source, fixed_duration)
    total_sets = len(segments)
    chunk_index = int(chunk_index)
    if not 0 <= chunk_index < total_sets:
        raise ValueError(
            f"Chunk index {chunk_index} out of range (total {total_sets}).")

    fps = max(1, int(fps))
    start_sec, end_sec = segments[chunk_index]
    start_frame = int(round(start_sec * fps))
    end_frame = int(round(end_sec * fps))
    frames_per_scene = max(1, end_frame - start_frame)

    preroll = max(0, int(pre_frames))
    if chunk_index == 0 and start_frame <= 0:
        preroll = 0
    base_frames = frames_per_scene + preroll + max(0, int(tail_loss_frames))
    frames_for_ltx = round_up_8n1(base_frames)

    samples_per_frame = rate / fps
    start_samp = max(0, int(round(start_frame * samples_per_frame))
                     - int(round(preroll * samples_per_frame)))
    end_samp = min(waveform.shape[-1],
                   start_samp + int(round(base_frames * samples_per_frame)))
    segment = waveform[..., start_samp:end_samp].copy()

    out_rate = int(target_sr) if target_sr else rate
    if out_rate != rate:
        segment = resample_waveform(segment, rate, out_rate)

    desired = int(round(frames_for_ltx * out_rate / fps))
    if segment.shape[-1] < desired:
        segment = np.pad(
            segment, [(0, 0), (0, 0), (0, desired - segment.shape[-1])])
    else:
        segment = segment[..., :desired]

    return {
        "audio": make_audio(segment, out_rate),
        "chunk_index": chunk_index,
        "total_sets": total_sets,
        "start_time": f"{start_frame / fps:.3f}",
        "end_time": f"{end_frame / fps:.3f}",
        "frames_per_scene": frames_per_scene,
        "preroll_frames": preroll,
        "frames_for_ltx": frames_for_ltx,
        "total_duration": audio_duration(audio),
        "sample_rate": out_rate,
    }


def delay_audio_by_index(audio, chunk_index: int,
                         delay_ms: float = 40.0) -> dict:
    """Front-pad (positive delay) or trim (negative) every chunk except
    index 0 (``VRGDG_AudioDelayByIndex.run``,
    ``GeneralVideoNodes2.py:843-866``)."""
    waveform, rate = as_waveform(audio)
    if int(chunk_index) != 0:
        delay_samples = int(round(float(delay_ms) * rate / 1000.0))
        if delay_samples > 0:
            waveform = np.pad(waveform,
                              [(0, 0), (0, 0), (delay_samples, 0)])
        elif delay_samples < 0:
            cut = min(-delay_samples, waveform.shape[-1])
            waveform = waveform[..., cut:]
    return make_audio(waveform, rate)


# --------------------------------------------------------------------------
# Timecodes, cropping, cleanup, set math (HuMo automation audio helpers)
# --------------------------------------------------------------------------

def parse_timecode(value) -> float:
    """``"m:ss(.xx)"`` (or bare seconds) -> seconds. A missing colon is
    treated as seconds-only, the contract of the reference's crop parser
    (HumoAutomation.py:770-786)."""
    if isinstance(value, (int, float)):
        return max(0.0, float(value))
    text = str(value or "0").strip()
    if ":" not in text:
        text = f"00:{text}"
    minutes, seconds = text.split(":", 1)
    return max(0.0, 60.0 * int(minutes or 0) + float(seconds or 0.0))


def format_timecode(seconds: float, decimals: int = 2) -> str:
    """Seconds -> ``"m:ss.xx"`` (``HumoAutomation.py:196-201``)."""
    seconds = max(0.0, float(seconds))
    minutes = int(seconds // 60)
    return f"{minutes}:{seconds % 60:0{3 + decimals}.{decimals}f}" \
        if decimals else f"{minutes}:{int(seconds % 60):02d}"


def set_start_timecode(index: int, frames_per_group: int = 97,
                       fps: float = 25.0, groups_per_set: int = 16) -> str:
    """Start timecode of set ``index`` in the HuMo chunking scheme: one
    set is ``groups_per_set`` groups of ``frames_per_group`` frames
    (``HumoAutomation.py:177-201``, VRGDG_TimecodeFromIndex)."""
    set_duration = frames_per_group * groups_per_set / float(fps)
    return format_timecode(max(0, int(index)) * set_duration)


def crop_audio(audio, start_time="0:00", end_time="1:00") -> dict:
    """Trim audio to a ``[start, end)`` timecode window
    (``HumoAutomation.py:734-820``, VRGDG_AudioCrop): sample indices are
    clamped into the waveform and ``start > end`` is an error."""
    waveform, rate = as_waveform(audio)
    total = waveform.shape[-1]
    start = min(max(0, int(parse_timecode(start_time) * rate)), total - 1)
    end = min(max(0, int(parse_timecode(end_time) * rate)), total - 1)
    if start > end:
        raise ValueError(
            f"Invalid crop range: start {start / rate:.2f}s must come "
            f"before end {end / rate:.2f}s within the "
            f"{total / rate:.2f}s audio.")
    return make_audio(waveform[..., start:end], rate)


def clean_audio(audio, target_sr: int = 48000, fps: int = 25) -> dict:
    """Normalize audio for video muxing (``HumoAutomation.py:2472-2545``,
    VRGDG_CleanAudio): resample to ``target_sr``, force stereo, snap to
    the 16-bit PCM grid, and zero-pad the tail to a whole video frame
    (1920 samples at 48 kHz / 25 fps)."""
    waveform, rate = as_waveform(audio)
    channels = waveform[0]  # (C, T)
    if rate != target_sr:
        channels = resample_waveform(channels, rate, target_sr)
    if channels.shape[0] == 1:
        channels = np.repeat(channels, 2, axis=0)
    elif channels.shape[0] > 2:
        channels = np.repeat(channels.mean(axis=0, keepdims=True), 2,
                             axis=0)
    channels = np.clip(channels, -1.0, 1.0)
    # trunc, not round: torch's .short() truncates toward zero and the
    # reference quantizes with it (HumoAutomation.py:2524)
    channels = np.trunc(channels * 32767.0).astype(np.int16) \
        .astype(np.float32) / 32767.0
    samples_per_frame = int(target_sr // fps)
    remainder = channels.shape[-1] % samples_per_frame
    if remainder:
        pad = np.zeros((channels.shape[0], samples_per_frame - remainder),
                       np.float32)
        channels = np.concatenate([channels, pad], axis=-1)
    return make_audio(channels[None], target_sr)


def calculate_sets_frames(audio, groups_per_set: int = 16) -> dict:
    """Frame-quantized set calculator for the HuMo queue driver
    (``HumoAutomation.py:1172-1292``, VRGDG_CalculateSetsFromAudio_Queue).

    Reproduces the reference's two-pass quirk exactly: ``total_sets``
    and ``groups_in_last_set`` come from a 3.88 s × 25 fps grouping of
    the ROUNDED total frame count, while the returned
    ``durations_frames`` list is recomputed from 97-frame groups of
    the FLOORED sample-exact frame count — the two can disagree on
    short tails, and downstream nodes rely on each side separately.
    """
    waveform, rate = as_waveform(audio)
    num_samples = waveform.shape[-1]
    duration = num_samples / float(rate) if rate else 0.0
    fps = 25
    scene_duration = 3.88

    end_time = f"{int(duration // 60)}:{int(duration % 60):02d}"

    # pass 1: rounded-duration grouping drives the set counts
    frames_per_scene = int(round(scene_duration * fps))
    total_audio_frames = int(round(duration * fps))
    total_groups = 0
    if total_audio_frames > 0:
        total_groups = total_audio_frames // frames_per_scene
        if total_audio_frames % frames_per_scene:
            total_groups += 1
    total_sets = math.ceil(total_groups / groups_per_set) \
        if total_groups > 0 else 0
    remainder = total_groups % groups_per_set
    groups_in_last_set = remainder if remainder else \
        (groups_per_set if total_groups > 0 else 0)

    # pass 2: sample-exact 97-frame durations list
    frames_per_scene = 97
    samples_per_frame = round(rate / fps) if rate else 1
    exact_frames = num_samples // samples_per_frame
    durations_frames: list[int] = []
    if exact_frames > 0:
        full = exact_frames // frames_per_scene
        leftover = exact_frames % frames_per_scene
        durations_frames.extend([frames_per_scene] * full)
        if leftover:
            durations_frames.append(leftover)

    if total_sets == 0:
        note = "audio too short — no runs required"
    elif groups_in_last_set == groups_per_set:
        note = f"{total_sets} full run(s) needed"
    else:
        note = (f"{total_sets} run(s); enable groups 1-"
                f"{groups_in_last_set} on the last run")
    return {"instructions": note, "end_time": end_time,
            "total_sets": total_sets,
            "groups_in_last_set": groups_in_last_set,
            "frames_per_scene": frames_per_scene,
            "audio_meta": {"durations_frames": durations_frames}}


def adjust_frames_mult9(frames: int) -> int:
    """Round a frame count up to a multiple of 9 — the general video
    models' pad alignment (``GeneralVideoNodes.py:1300-1303``)."""
    return ((int(frames) + 8) // 9) * 9


def parse_duration_list(text) -> list[float]:
    """Scene-duration text → float list, commas/newlines/spaces all
    separating, bad entries as 0.0 (``GeneralVideoNodes.py:2006-2041``,
    VRGDG_DurationIndexFloat — which persists the list to a temp JSON
    for the splitter; here the list is returned for direct passing)."""
    raw = str(text or "").replace("\n", ",").replace(" ", ",")
    durations = []
    for part in raw.split(","):
        if not part.strip():
            continue
        try:
            durations.append(float(part))
        except ValueError:
            durations.append(0.0)
    return durations


def duration_at_index(text, index: int) -> tuple[float, int]:
    """The indexed duration with end-clamping (reference
    :2021-2029)."""
    durations = parse_duration_list(text)
    if not durations:
        return 0.0, 0
    clamped = max(0, min(int(index), len(durations) - 1))
    return durations[clamped], len(durations)


def general_chunk_index(folder: str) -> int:
    """Resume index for the general single-chunk-per-run splitter
    (``GeneralVideoNodes.py:1100-1117``): the highest first 4-digit
    group among ``*_NNNN_M-audio.mp4`` finals, plus one."""
    if not os.path.isdir(folder):
        return 0
    indices = [int(hit.group(1)) for name in os.listdir(folder)
               if (hit := re.match(r".*?_(\d{4})_\d+-audio\.mp4$",
                                   name))]
    return max(indices) + 1 if indices else 0


def split_general_chunk(audio, chunk_index: int = 0,
                        scene_duration_seconds: float = 4.0,
                        fps: int = 24,
                        use_humo_alignment: bool = False,
                        durations=None,
                        preroll_frames: int = 6,
                        tail_loss_frames: int = 8) -> dict:
    """One chunk of the general single-chunk-per-run audio splitter
    (``GeneralVideoNodes.py:1312-1665``, VRGDG_LoadAudioSplit_General,
    minus the ComfyUI queue/popup/folder-timestamp glue).

    Frames per chunk quantize to HuMo ``4N+1`` (fps must be 25) or a
    multiple of 9; non-first chunks add ``preroll_frames`` of lead-in
    video and LTX over-generates ``tail_loss_frames`` more
    (``frames_for_ltx``).  ``durations`` switches to custom-duration
    mode: each chunk's length comes from the list and offsets
    accumulate (reference :1476-1499).  The audio chunk is sliced
    sample-exact with preroll compensation, zero-padded or silence-
    filled to full length.  Callers needing the reference's forced
    44.1 kHz input resample first (``resample_waveform``).
    """
    waveform, rate = as_waveform(audio)
    total_samples = waveform.shape[-1]
    total_duration = float(total_samples) / float(rate) if rate else 0.0

    def _frames_for(seconds):
        raw = int(round(int(fps) * float(seconds)))
        if use_humo_alignment:
            if int(fps) != 25:
                raise ValueError("HuMo alignment requires fps=25")
            return adjust_frames_humo(raw)
        return adjust_frames_mult9(raw)

    chunk_index = int(chunk_index)
    if durations:
        durations = [float(value) for value in durations]
        frames_per_scene = _frames_for(durations[chunk_index])
        offset_samples = int(sum(durations[:chunk_index]) * rate + 0.5)
        total_sets = len(durations)
    else:
        frames_per_scene = _frames_for(scene_duration_seconds)
        samples_per_scene = int(frames_per_scene * rate
                                / float(fps) + 0.5)
        offset_samples = samples_per_scene * chunk_index
        real_scene = frames_per_scene / float(fps)
        total_sets = max(1, math.ceil(total_duration / real_scene)) \
            if real_scene else 1
    samples_per_scene = int(frames_per_scene * rate / float(fps) + 0.5)

    # preroll: non-first chunks lead in (video_preroll.py:1-11)
    preroll = 0 if chunk_index == 0 else max(0, int(preroll_frames))
    frames_for_ltx = frames_per_scene + preroll \
        + max(0, int(tail_loss_frames))
    preroll_samples = int(preroll * rate / float(fps) + 0.5)

    start = max(0, offset_samples - preroll_samples)
    if start >= total_samples:
        chunk = np.zeros(waveform.shape[:-1] + (samples_per_scene,),
                         waveform.dtype)
    else:
        chunk = waveform[..., start:min(total_samples,
                                        start + samples_per_scene)]
        short = samples_per_scene - chunk.shape[-1]
        if short > 0:
            pad = [(0, 0)] * (chunk.ndim - 1) + [(0, short)]
            chunk = np.pad(chunk, pad)

    # reference :1624-1646 — per-chunk time strings, final clamped
    actual_scene = frames_per_scene / float(fps)
    start_sec = offset_samples / float(rate) if rate else 0.0
    end_sec = start_sec + actual_scene
    reported = actual_scene
    if chunk_index == total_sets - 1:
        end_sec = min(end_sec, total_duration)
        reported = end_sec - start_sec

    def _fmt(seconds):
        return f"{int(seconds // 60)}:{seconds % 60:06.3f}"

    return {"audio": make_audio(chunk, rate),
            "meta": {"durations": [actual_scene],
                     "offset_seconds": offset_samples / float(rate)
                     if rate else 0.0,
                     "starts": [offset_samples], "sample_rate": rate,
                     "audio_total_duration": total_duration,
                     "outputs_count": 1},
            "chunk_index": chunk_index, "total_sets": total_sets,
            "frames_per_scene": frames_per_scene,
            "frames_for_ltx": frames_for_ltx,
            "preroll_frames": preroll,
            "audio_meta": {"durations_frames": [frames_per_scene]},
            "start_time": _fmt(start_sec), "end_time": _fmt(end_sec),
            "reported_duration": reported}


def count_completed_sets(folder: str) -> int:
    """Sets already rendered = ``*-audio.mp4`` finals in the output
    folder (``HumoAutomation.py:812-846`` VRGDG_GetIndexNumber,
    ``:2958-2968``)."""
    if not os.path.isdir(folder):
        return 0
    return len([name for name in os.listdir(folder)
                if name.lower().endswith(".mp4")
                and "-audio" in name.lower()])


def calculate_wan22_sets(audio, index: int = 0,
                         scene_duration_seconds: float = 4.0,
                         groups_per_set: int = 16) -> dict:
    """The Wan22/FMML set planner (``HumoAutomation.py:2970-3104``,
    ``_calculate_sets``): scene frames quantized to HuMo 4N+1, total
    frames from half-up sample rounding, a first-group fixup forcing a
    short leading group to full length, and the per-set 16-group slice
    of the durations list for the CURRENT index."""
    waveform, rate = as_waveform(audio)
    num_samples = waveform.shape[-1]
    duration = num_samples / float(rate) if rate else 0.0
    fps = 25
    frames_per_scene = adjust_frames_humo(
        int(round(fps * float(scene_duration_seconds))))

    durations_full: list[int] = []
    total_sets = 0
    groups_in_last_set = 0
    total_frames = int(num_samples / (rate / fps) + 0.5) \
        if num_samples > 0 and rate else 0
    if total_frames > 0:
        full = math.floor(total_frames / frames_per_scene)
        leftover = total_frames - full * frames_per_scene
        durations_full.extend([frames_per_scene] * full)
        if leftover > 0:
            durations_full.append(leftover)
        if durations_full and durations_full[0] != frames_per_scene:
            durations_full[0] = frames_per_scene
        total_groups = len(durations_full)
        total_sets = math.ceil(total_groups / groups_per_set)
        remainder = total_groups % groups_per_set
        groups_in_last_set = remainder if remainder else \
            (groups_per_set if total_groups else 0)

    start = int(index) * groups_per_set
    this_set = durations_full[start:start + groups_per_set] \
        if durations_full else []

    if total_sets == 0:
        note = "audio too short — no runs required"
    elif int(index) + 1 >= total_sets:
        note = f"final run ({min(int(index) + 1, total_sets)} of " \
               f"{total_sets}); {groups_in_last_set} group(s) active"
    else:
        note = f"run {int(index) + 1} of {total_sets}"
    return {"instructions": note,
            "end_time": f"{int(duration // 60)}:"
                        f"{int(duration % 60):02d}",
            "total_sets": total_sets,
            "groups_in_last_set": groups_in_last_set,
            "frames_per_scene": frames_per_scene,
            "audio_meta": {"durations_frames": this_set},
            "durations_frames_full": durations_full}


def split_audio_humo_set(audio, set_index: int = 0,
                         scene_count: int = 16,
                         frames_per_scene: int = 97,
                         fps: int = 25,
                         rounded_scene_samples: bool = False) -> dict:
    """Slice one HuMo render set into 16 sample-exact 97-frame scene
    chunks (``HumoAutomation.py:547-612``, the deterministic core of
    LoadAudioSplit_HUMO_TranscribeV2/V3 — the Whisper transcription
    stays external).

    Scenes past the end of the audio come back as pure silence, short
    final scenes are zero-padded to the full length, so every chunk is
    exactly ``frames_per_scene * round(rate/fps)`` samples — the HuMo
    conditioning contract.  ``rounded_scene_samples`` switches to the
    Wan22 variant's scene-level half-up rounding
    (``int(frames * rate / fps + 0.5)``, ``HumoAutomation.py:3181``) —
    one sample different at non-divisible rates.  Returns
    ``{segments, meta, total_duration}`` with the reference's meta
    schema.
    """
    waveform, rate = as_waveform(audio)
    total_samples = waveform.shape[-1]
    total_duration = float(total_samples) / float(rate) if rate else 0.0
    if rounded_scene_samples:
        samples_per_scene = int(int(frames_per_scene) * rate
                                / float(fps) + 0.5)
    else:
        samples_per_scene = int(frames_per_scene) \
            * int(round(rate / float(fps)))
    offset = int(set_index) * scene_count * samples_per_scene

    starts = [offset + i * samples_per_scene
              for i in range(scene_count)]
    segments = []
    for start in starts:
        if start >= total_samples:
            chunk = np.zeros(waveform.shape[:-1] + (samples_per_scene,),
                             waveform.dtype)
        else:
            chunk = waveform[..., start:min(total_samples,
                                            start + samples_per_scene)]
            short = samples_per_scene - chunk.shape[-1]
            if short > 0:
                pad = [(0, 0)] * (chunk.ndim - 1) + [(0, short)]
                chunk = np.pad(chunk, pad)
        segments.append(make_audio(chunk, rate))

    meta = {"durations": [frames_per_scene / float(fps)] * scene_count,
            "offset_seconds": 0.0, "starts": starts,
            "sample_rate": rate,
            "audio_total_duration": total_duration,
            "outputs_count": len(segments), "used_padding": False}
    return {"segments": segments, "meta": meta,
            "total_duration": total_duration}


def enrich_lyric_lines(lyrics, contexts=None, fallback_words=None,
                       scene_count: int = 16) -> str:
    """Join per-scene lyric lines into the pipe string the HuMo prompt
    stack consumes (``HumoAutomation.py:668-681``): empty lines take a
    fallback action word, a scene's context prefixes its lyric as
    ``context, lyric``.  The reference picks fallbacks with
    ``random.choice``; here the rotation is index-deterministic so
    reruns reproduce."""
    fallbacks = [word.strip() for word
                 in (fallback_words or "").split(",")
                 if word.strip()] if isinstance(fallback_words, str) \
        else list(fallback_words or [])
    if not fallbacks:
        fallbacks = ["standing", "sitting", "laying", "resting",
                     "waiting", "walking", "dancing", "looking",
                     "thinking"]
    lines = list(lyrics or [])
    lines += [""] * (scene_count - len(lines))
    contexts = list(contexts or [])
    contexts += [""] * (scene_count - len(contexts))
    enriched = []
    for pos in range(scene_count):
        line = str(lines[pos] or "").strip() \
            or fallbacks[pos % len(fallbacks)]
        prefix = str(contexts[pos] or "").strip()
        enriched.append(f"{prefix}, {line}" if prefix else line)
    return " | ".join(enriched)


def calculate_sets(audio, set_duration: float = 62.0,
                   group_duration: float = 3.88,
                   groups_per_set: int = 16) -> dict:
    """How many render sets an audio track needs
    (``HumoAutomation.py:312-365``, VRGDG_CalculateSetsFromAudio):
    full 62 s sets plus a partial set whose enabled group count is
    ``ceil(remainder / group_duration)`` capped at ``groups_per_set``."""
    waveform, rate = as_waveform(audio)
    duration = waveform.shape[-1] / float(rate) if rate else 0.0
    full_sets = int(duration // set_duration)
    remainder = duration - full_sets * set_duration
    if remainder > 0:
        total_sets = full_sets + 1
        groups_in_last_set = min(math.ceil(remainder / group_duration),
                                 groups_per_set)
    else:
        total_sets = full_sets
        groups_in_last_set = groups_per_set
    return {"total_sets": total_sets,
            "groups_in_last_set": groups_in_last_set,
            "duration": duration,
            "end_time": format_timecode(duration, decimals=0)}
