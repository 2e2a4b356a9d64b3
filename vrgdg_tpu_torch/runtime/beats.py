"""Beat analysis and beat-aligned scene durations.

A copy of :mod:`vrgdg_tpu.runtime.beats` (numpy only), held equal to it
by ``tests/test_torch_host_copies.py``.

Re-derivation of the reference's music-timing subsystem without librosa:

- :func:`analyze_beats` reproduces ``BeatImpactAnalysisNode``
  (``GeneralVideoNodes.py:2160-2374``): beat tracking over the final mix
  with stem-usability RMS gating, the drums > other > mix source
  preference, and per-beat impact scores blended from stem onset
  envelopes (drums 0.45 / bass 0.25 / vocals 0.15 / other 0.15 with mix
  fallback), returning the reference's ``beat_data`` JSON schema
  (``bpm`` / ``source_used_for_beats`` / ``duration`` / ``beats``).
- :func:`generate_scene_srt` reproduces ``BeatSceneDurationNode``
  (``GeneralVideoNodes.py:2375-2753``): seeded beat-aligned SRT scene
  durations with the three presets, intro alignment, forced windows,
  tail chunking, and the short-first-scene merge.

The DSP replaces librosa with a self-contained numpy pipeline:
Hann-windowed STFT -> mel filterbank -> dB spectral-flux onset envelope
-> autocorrelation tempo estimate under a log-normal prior -> the
classic dynamic-programming beat tracker (Ellis, "Beat Tracking by
Dynamic Programming", J. New Music Research 2007).  Parity with librosa
is distributional, not bitwise: tests lock BPM and beat positions on
synthetic click tracks (`tests/test_beats.py` for the original).

Analysis is host-side numpy by design — it runs once per song on the
CPU while the card streams frames; there is nothing accelerator-shaped
in a few thousand FFT frames.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

HOP_LENGTH = 512
N_FFT = 2048
N_MELS = 128


# --------------------------------------------------------------------------
# audio plumbing
# --------------------------------------------------------------------------

def extract_mono(audio) -> tuple[np.ndarray | None, int | None]:
    """Mono float32 waveform + sample rate from any accepted audio form.

    Accepts the reference's AUDIO dict ``{"waveform": (B, C, T),
    "sample_rate": int}`` (``GeneralVideoNodes.py`` `extract_mono`
    contract), a ``(waveform, sample_rate)`` tuple, or a bare array with
    no rate (returns ``(array, None)``).  Channel axes are averaged.
    """
    if audio is None:
        return None, None
    rate = None
    wave = audio
    if isinstance(audio, dict):
        wave = audio.get("waveform")
        rate = audio.get("sample_rate")
    elif isinstance(audio, (tuple, list)) and len(audio) == 2:
        wave, rate = audio
    if wave is None:
        return None, None
    if hasattr(wave, "detach"):  # torch tensor
        wave = wave.detach().cpu().numpy()
    wave = np.asarray(wave, np.float32)
    while wave.ndim > 1:
        wave = wave.mean(axis=0)
    return wave, (int(rate) if rate else None)


def frame_rms(y: np.ndarray, frame_length: int = N_FFT,
              hop_length: int = HOP_LENGTH) -> np.ndarray:
    """Center-padded frame-wise RMS envelope (librosa.feature.rms twin)."""
    y = np.asarray(y, np.float32)
    if y.size == 0:
        return np.zeros(0, np.float32)
    pad = frame_length // 2
    padded = np.pad(y, pad, mode="constant")
    frames = np.lib.stride_tricks.sliding_window_view(
        padded, frame_length)[::hop_length]
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2,
                           axis=1)).astype(np.float32)


# --------------------------------------------------------------------------
# onset envelope
# --------------------------------------------------------------------------

def _hz_to_mel(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int = N_FFT,
                   n_mels: int = N_MELS) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, n_fft//2 + 1)`` (HTK scale)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_points = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                             n_mels + 2)
    hz_points = _mel_to_hz(mel_points)
    lower, center, upper = hz_points[:-2], hz_points[1:-1], hz_points[2:]
    up = (fft_freqs[None, :] - lower[:, None]) \
        / np.maximum(center - lower, 1e-9)[:, None]
    down = (upper[:, None] - fft_freqs[None, :]) \
        / np.maximum(upper - center, 1e-9)[:, None]
    bank = np.maximum(0.0, np.minimum(up, down))
    # area-normalize so every filter integrates the same energy
    bank /= np.maximum(bank.sum(axis=1, keepdims=True), 1e-9)
    return bank.astype(np.float32)


def stft_magnitude(y: np.ndarray, n_fft: int = N_FFT,
                   hop_length: int = HOP_LENGTH) -> np.ndarray:
    """Center-padded Hann STFT magnitude, shape ``(frames, bins)``."""
    y = np.asarray(y, np.float32)
    padded = np.pad(y, n_fft // 2, mode="reflect") \
        if y.size >= n_fft // 2 + 1 else np.pad(y, n_fft // 2,
                                                mode="constant")
    if padded.size < n_fft:
        padded = np.pad(padded, (0, n_fft - padded.size))
    frames = np.lib.stride_tricks.sliding_window_view(
        padded, n_fft)[::hop_length]
    window = np.hanning(n_fft).astype(np.float32)
    return np.abs(np.fft.rfft(frames * window, axis=1)).astype(np.float32)


def onset_envelope(y: np.ndarray, sr: int) -> np.ndarray:
    """Spectral-flux onset strength: mel power in dB, half-wave-rectified
    first difference, averaged over bands.  One value per STFT frame."""
    if y is None or np.size(y) == 0:
        return np.zeros(0, np.float32)
    mag = stft_magnitude(y)
    mel = mag ** 2 @ mel_filterbank(sr).T          # (frames, mels)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    flux = np.maximum(0.0, np.diff(db, axis=0))
    onset = flux.mean(axis=1)
    return np.concatenate([[0.0], onset]).astype(np.float32)


def frames_to_time(frames, sr: int, hop_length: int = HOP_LENGTH):
    return np.asarray(frames, np.float64) * hop_length / float(sr)


# --------------------------------------------------------------------------
# tempo + beat tracking
# --------------------------------------------------------------------------

def estimate_tempo(onset: np.ndarray, sr: int,
                   hop_length: int = HOP_LENGTH,
                   start_bpm: float = 120.0) -> float:
    """Tempo from the onset autocorrelation under a log-normal prior
    centered at ``start_bpm`` (one octave std)."""
    if onset.size < 4:
        return float(start_bpm)
    env = onset - onset.mean()
    n = int(2 ** np.ceil(np.log2(2 * env.size)))
    spectrum = np.fft.rfft(env, n)
    ac = np.fft.irfft(spectrum * np.conj(spectrum), n)[:env.size]
    ac = ac / max(ac[0], 1e-9)

    fps = sr / hop_length
    max_lag = min(env.size - 1, int(fps * 60.0 / 30.0))   # >= 30 BPM
    min_lag = max(1, int(fps * 60.0 / 300.0))             # <= 300 BPM
    if max_lag <= min_lag:
        return float(start_bpm)
    lags = np.arange(min_lag, max_lag + 1)
    bpms = 60.0 * fps / lags
    prior = np.exp(-0.5 * (np.log2(bpms / start_bpm)) ** 2)
    best = lags[int(np.argmax(ac[min_lag:max_lag + 1] * prior))]
    return float(60.0 * fps / best)


def track_beats(y: np.ndarray, sr: int, hop_length: int = HOP_LENGTH,
                tightness: float = 100.0) -> tuple[float, np.ndarray]:
    """Dynamic-programming beat tracker (Ellis 2007).

    Returns ``(bpm, beat_times_seconds)``.  The DP maximizes summed
    onset strength at beat positions minus ``tightness`` times the
    squared log-deviation of each inter-beat interval from the tempo
    period, then backtracks from the best final beat.
    """
    onset = onset_envelope(y, sr)
    if onset.size == 0:
        return 0.0, np.zeros(0)
    bpm = estimate_tempo(onset, sr, hop_length)
    fps = sr / hop_length
    period = max(1, int(round(60.0 * fps / max(bpm, 1e-6))))

    # local score: onset smoothed with a gaussian of ~1/32 beat width
    sigma = max(1.0, period / 32.0)
    radius = int(4 * sigma)
    kernel = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    local = np.convolve(onset, kernel / kernel.sum(), mode="same")
    local = local / max(local.std(), 1e-9)

    n = local.size
    score = local.copy()
    backlink = np.full(n, -1, np.int64)
    window = np.arange(-2 * period, -period // 2 + 1)
    penalty = -tightness * (np.log(-window / float(period))) ** 2
    for i in range(period // 2, n):
        prev = i + window
        valid = prev >= 0
        if not np.any(valid):
            continue
        candidates = np.where(valid, score[np.maximum(prev, 0)] +
                              penalty, -np.inf)
        k = int(np.argmax(candidates))
        best = candidates[k]
        if best > -np.inf:
            score[i] = local[i] + best
            backlink[i] = prev[k]

    # start from the best-scoring frame near the end with a real chain
    tail = score[max(0, n - period):]
    end = int(np.argmax(tail)) + max(0, n - period)
    beats = [end]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1], np.int64)
    # drop silent leading "beats" the DP padded in before the music
    keep = local[beats] >= 0.25 * np.median(local[beats])
    if np.any(keep):
        beats = beats[np.argmax(keep):]
    return bpm, frames_to_time(beats, sr, hop_length)


# --------------------------------------------------------------------------
# Node A: analysis
# --------------------------------------------------------------------------

def stem_usable(stem: np.ndarray | None, mix: np.ndarray | None,
                sr: int) -> bool:
    """Stem gating (``GeneralVideoNodes.py:2201-2220``): a stem is only
    trusted for beat tracking when it spans the mix (within 1 s) and its
    last-10-seconds median RMS holds >= 10% of its overall median RMS
    (rejects silence-trimmed stems)."""
    if stem is None or mix is None:
        return False
    if (len(mix) - len(stem)) / sr > 1.0:
        return False
    rms = frame_rms(stem)
    if rms.size == 0:
        return False
    overall = float(np.median(rms))
    if overall <= 1e-8:
        return False
    tail_frames = max(1, int(10.0 * sr / HOP_LENGTH))
    return float(np.median(rms[-tail_frames:])) >= overall * 0.1


_IMPACT_WEIGHTS = (("drums", 0.45), ("bass", 0.25), ("vocals", 0.15),
                   ("other", 0.15))


def analyze_beats(final_mix, drums=None, bass=None, vocals=None,
                  other=None) -> dict:
    """Full beat & impact analysis (``GeneralVideoNodes.py:2189-2374``).

    Returns the reference's ``beat_data`` dict: ``bpm``,
    ``source_used_for_beats``, ``duration``, and ``beats`` — a list of
    ``{"time", "beat_index", "downbeat", "impact"}`` with ``downbeat``
    every 4th beat and ``impact`` the stem-weighted onset strength at
    the nearest onset frame.
    """
    y_mix, sr = extract_mono(final_mix)
    if y_mix is None or not sr:
        raise ValueError("Final mix audio input is invalid")
    stems = {name: extract_mono(a)[0]
             for name, a in (("drums", drums), ("bass", bass),
                             ("vocals", vocals), ("other", other))}

    source = "final_mix"
    track_on = y_mix
    if stem_usable(stems["drums"], y_mix, sr):
        source, track_on = "drums", stems["drums"]
    elif stem_usable(stems["other"], y_mix, sr):
        source, track_on = "other", stems["other"]
    bpm, beat_times = track_beats(track_on, sr)

    def normalized_onset(y):
        if y is None:
            return None
        env = onset_envelope(y, sr)
        return env / (env.max() + 1e-6) if env.size else None

    onset_mix = normalized_onset(y_mix)
    onsets = {name: normalized_onset(y) for name, y in stems.items()}
    onset_times = (frames_to_time(np.arange(onset_mix.size), sr)
                   if onset_mix is not None and onset_mix.size else
                   np.zeros(0))

    beats = []
    for i, t in enumerate(beat_times):
        impact = 0.0
        if onset_times.size:
            idx = int(np.argmin(np.abs(onset_times - t)))
            weighted, weight_sum = 0.0, 0.0
            for name, weight in _IMPACT_WEIGHTS:
                env = onsets[name]
                if env is not None and 0 <= idx < env.size:
                    weighted += float(env[idx]) * weight
                    weight_sum += weight
            if weight_sum > 0.0:
                impact = weighted / weight_sum
            elif idx < onset_mix.size:
                impact = float(onset_mix[idx])
        beats.append({"time": round(float(t), 4), "beat_index": i,
                      "downbeat": i % 4 == 0,
                      "impact": round(impact, 4)})

    return {"bpm": round(float(bpm), 2), "source_used_for_beats": source,
            "duration": float(len(y_mix) / sr), "beats": beats}


# --------------------------------------------------------------------------
# Node B: beat-aligned scene durations
# --------------------------------------------------------------------------

def format_srt_time(seconds: float) -> str:
    whole = int(seconds)
    ms = int((seconds - whole) * 1000)
    return (f"{whole // 3600:02}:{(whole % 3600) // 60:02}:"
            f"{whole % 60:02},{ms:03}")


def _srt_text_roundtrip(seconds: float) -> float:
    """``to_seconds(format_time(seconds))`` — format to SRT text and
    parse back, exactly like the reference's merge helper
    (``GeneralVideoNodes.py:2448-2451``)."""
    clock, ms = format_srt_time(seconds).split(",")
    hours, minutes, secs = (int(part) for part in clock.split(":"))
    return hours * 3600 + minutes * 60 + secs + int(ms) / 1000.0


def _render_srt(blocks: list[tuple[float, float]]) -> str:
    lines = []
    for index, (start, end) in enumerate(blocks, 1):
        lines += [str(index),
                  f"{format_srt_time(start)} --> {format_srt_time(end)}",
                  f"SCENE {index}", ""]
    return "\n".join(lines)


SCENE_PRESETS = ("impact_weighted", "varied_no_repeat",
                 "clustered_no_repeat")


def generate_scene_blocks(beat_data: dict | str, min_duration: float = 2.0,
                          max_duration: float = 10.0, bias: float = 0.7,
                          duration_preset: str = "impact_weighted",
                          seed: int = 0) -> tuple[list, dict]:
    """Beat-aligned scene ``(start, end)`` blocks + stats.

    Behavior of ``GeneralVideoNodes.py:2423-2718``: intro scenes chunked
    by ``max_duration`` when the first beat starts late; per-window
    candidate beats in ``[start + min, start + max]`` weighted by
    ``impact^bias`` (downbeats x1.2 pre-bias) with the preset modifiers
    (varied: favor large duration jumps and band switches; clustered:
    favor deltas <= 1.5 s), a 0.2 s non-repeat constraint relaxed only
    when no candidate differs enough, a seeded weighted choice, forced
    cuts at ``max`` when no beat lands in the window, and tail chunks to
    song end; finally an opening scene shorter than 1.5 s is merged into
    the second.
    """
    data = json.loads(beat_data) if isinstance(beat_data, str) else beat_data
    beats = data["beats"]
    if not beats:
        raise ValueError("beat_data contains no beats")
    if duration_preset not in SCENE_PRESETS:
        raise ValueError(f"Unknown duration preset '{duration_preset}'.")
    song_end = float(data.get("duration", beats[-1]["time"]))
    min_duration = max(0.1, float(min_duration))
    max_duration = max(min_duration + 1e-6, float(max_duration))
    bias = min(1.0, max(0.0, float(bias)))
    rng = random.Random(int(seed))

    blocks: list[tuple[float, float]] = []
    stats = {"beat_aligned": 0, "forced": 0, "no_candidate_windows": 0,
             "intro_scenes": 0, "tail_chunks": 0, "merged_short_first": False}

    clock = 0.0
    first_beat = float(beats[0]["time"])
    if first_beat > 1e-6:
        while clock < first_beat - 1e-6:
            end = min(clock + max_duration, first_beat)
            if end - clock <= 1e-6:
                break
            blocks.append((clock, end))
            stats["intro_scenes"] += 1
            clock = end
        clock = first_beat

    index = 0
    prev_duration = None
    mid_band = (min_duration + max_duration) * 0.5
    while index < len(beats) - 1:
        anchor = float(beats[index]["time"])
        window = [(i, float(b["time"]),
                   float(b["impact"]) * (1.2 if b.get("downbeat") else 1.0),
                   float(b["time"]) - anchor)
                  for i, b in enumerate(beats[index + 1:], index + 1)
                  if anchor + min_duration <= float(b["time"])
                  <= anchor + max_duration]

        if not window:
            stats["no_candidate_windows"] += 1
            forced_end = min(anchor + max_duration, song_end)
            if forced_end <= anchor:
                break
            duration = forced_end - anchor
            blocks.append((clock, clock + duration))
            stats["forced"] += 1
            clock += duration
            prev_duration = duration
            index += 1
            while index < len(beats) and \
                    float(beats[index]["time"]) <= forced_end:
                index += 1
            if index >= len(beats):
                break
            continue

        pool = window
        if prev_duration is not None:
            distinct = [c for c in window
                        if abs(c[3] - prev_duration) >= 0.20]
            if distinct:
                pool = distinct

        weights = []
        for _, _, base_weight, duration in pool:
            w = base_weight ** bias + 1e-6
            if prev_duration is not None:
                delta = abs(duration - prev_duration)
                if duration_preset == "varied_no_repeat":
                    w *= 0.6 + min(2.0, delta / 0.8)
                    switched = (prev_duration >= mid_band) \
                        != (duration >= mid_band)
                    w *= 1.20 if switched else 0.85
                elif duration_preset == "clustered_no_repeat":
                    w *= 1.30 if delta <= 1.5 else 0.75
            weights.append(max(w, 1e-9))

        chosen, chosen_time, _, duration = \
            rng.choices(pool, weights=weights, k=1)[0]
        blocks.append((clock, clock + duration))
        stats["beat_aligned"] += 1
        clock += duration
        prev_duration = duration
        index = chosen

    while song_end - clock > max_duration:
        blocks.append((clock, clock + max_duration))
        stats["tail_chunks"] += 1
        clock += max_duration
    if clock < song_end:
        blocks.append((clock, song_end))

    # Short-first-scene merge. The reference implements this by parsing
    # its own rendered SRT text back into seconds
    # (``GeneralVideoNodes.py:2453-2489``), so whenever the merge runs,
    # EVERY boundary is quantized through the truncating millisecond
    # format — which is not idempotent (2.0571 -> "02,057" -> 2.057 ->
    # "02,056"). Reproduced faithfully: the merge decision uses the
    # text-derived duration and a triggered merge rewrites all blocks
    # with text-derived values (caught by the round-4 oracle fuzz).
    if len(blocks) >= 2:
        quantized = [(_srt_text_roundtrip(s), _srt_text_roundtrip(e))
                     for s, e in blocks]
        if quantized[0][1] - quantized[0][0] < 1.5:
            blocks = [(quantized[0][0], quantized[1][1])] + quantized[2:]
            stats["merged_short_first"] = True
    return blocks, stats


def generate_scene_srt(beat_data: dict | str, min_duration: float = 2.0,
                       max_duration: float = 10.0, bias: float = 0.7,
                       duration_preset: str = "impact_weighted",
                       seed: int = 0, output_path: str | None = None,
                       output_dir: str | None = None,
                       output_filename: str = "beats_output") -> dict:
    """SRT text (and optional file) for beat-aligned scene durations.

    Mirrors ``BeatSceneDurationNode.generate``'s contract: returns the
    SRT text plus the written path (``""`` when no output location was
    given) and the window statistics the reference logs.
    """
    blocks, stats = generate_scene_blocks(
        beat_data, min_duration, max_duration, bias, duration_preset, seed)
    text = _render_srt(blocks)

    path = ""
    if output_path:
        path = str(output_path)
    elif output_dir:
        name = str(output_filename).strip() or "beats_output"
        if not name.lower().endswith(".srt"):
            name += ".srt"
        path = os.path.join(str(output_dir), name)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as handle:
            handle.write(text)

    return {"srt_text": text, "srt_path": path, "scenes": len(blocks),
            **stats}
