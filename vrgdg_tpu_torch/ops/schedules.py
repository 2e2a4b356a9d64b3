"""Sigma-transition schedules and the first/last-frame blend guide.

Counterpart of :mod:`vrgdg_tpu.ops.schedules`.  The scheduling math
(per-transition CFG/strength ramps, schedule offsets and indices, the
per-tile strength lists, the guide's frame count) is the original's numpy
and plain Python, copied; :func:`apply_curve` and
:func:`first_last_blend` are torch ops on the frames' device.

A "transition" is the interval between consecutive sigmas: ``N`` sigmas
give ``N - 1`` transitions, and the active window is expressed in
percentages of the transition count.
"""

from __future__ import annotations

import numpy as np
import torch

INTERPOLATIONS = ("linear", "ease_in", "ease_out")


def _as_sigmas(sigmas) -> np.ndarray:
    array = np.asarray(sigmas, np.float64).reshape(-1)
    if array.size < 2:
        raise ValueError("sigmas must contain at least two values")
    if not np.isfinite(array).all():
        raise ValueError("every sigma value must be finite")
    return array


def interpolation_factor(interpolation: str, amount: float) -> float:
    """Ramp shaping (``CustomLTXNodes.py:33-40``): linear, quadratic
    ease-in, or quadratic ease-out."""
    if interpolation == "linear":
        return float(amount)
    if interpolation == "ease_in":
        return float(amount * amount)
    if interpolation == "ease_out":
        return float(amount * (2.0 - amount))
    raise ValueError(f"Unsupported interpolation: {interpolation}")


def build_transition_values(sigmas, value_start: float, value_end: float,
                            interpolation: str = "linear",
                            start_percent: float = 0.0,
                            end_percent: float = 1.0, *,
                            outside_value: float | None = None
                            ) -> tuple[np.ndarray, tuple[float, ...]]:
    """One scheduled value per sigma transition
    (``CustomLTXNodes.py:44-83``).

    With ``outside_value=None`` the start value holds before the ramp
    and the end value after it; otherwise the neutral ``outside_value``
    fills everything outside the ``[start_percent, end_percent]``
    window.  Ramp values are rounded to 4 decimals like the reference.
    Returns ``(sigmas_f64, values)``.
    """
    sigma_array = _as_sigmas(sigmas)
    if start_percent > end_percent:
        raise ValueError(
            "start_percent must be less than or equal to end_percent")
    transitions = sigma_array.size - 1
    start_index = min(int(transitions * start_percent), transitions - 1)
    end_index = min(int(transitions * end_percent), transitions - 1)

    if outside_value is None:
        values = [float(value_start)] * transitions
        for index in range(end_index + 1, transitions):
            values[index] = float(value_end)
    else:
        values = [float(outside_value)] * transitions

    for index in range(start_index, end_index + 1):
        amount = 0.0 if end_index == start_index else \
            (index - start_index) / (end_index - start_index)
        factor = interpolation_factor(interpolation, amount)
        values[index] = round(
            float(value_start + factor * (value_end - value_start)), 4)
    return sigma_array, tuple(values)


def runtime_schedule_offset(expected_sigmas, runtime_sigmas) -> int:
    """Locate the sampler's (possibly truncated) sigma range inside the
    full expected schedule (``CustomLTXNodes.py:86-99``); raises when the
    runtime range is not a contiguous slice of it."""
    expected = _as_sigmas(expected_sigmas)
    runtime = _as_sigmas(runtime_sigmas)
    if runtime.size <= expected.size:
        for offset in range(expected.size - runtime.size + 1):
            window = expected[offset:offset + runtime.size]
            if np.allclose(runtime, window, rtol=1e-5, atol=1e-7):
                return offset
    raise ValueError(
        "The sampler's sigma range is not part of the expected schedule. "
        "Pass the same sigmas to the schedule and the sampler.")


def current_transition_index(sample_sigmas, timestep) -> int:
    """Which transition a live sampler timestep falls in
    (``CustomLTXNodes.py:102-121``): exact sigma match first, then the
    bracketing interval, then nearest."""
    sigmas = _as_sigmas(sample_sigmas)
    current = float(np.asarray(timestep, np.float64).reshape(-1)[0])
    left_edges = sigmas[:-1]

    exact = np.nonzero(np.isclose(left_edges, current,
                                  rtol=1e-5, atol=1e-7))[0]
    if exact.size:
        return int(exact[0])
    for index in range(sigmas.size - 1):
        lo = min(sigmas[index], sigmas[index + 1])
        hi = max(sigmas[index], sigmas[index + 1])
        if lo <= current <= hi:
            return index
    return int(np.argmin(np.abs(left_edges - current)))


def schedule_index(expected_sigmas, runtime_sigmas, timestep) -> int:
    """Index into the full schedule for a live timestep of a (possibly
    truncated) runtime sigma range (``CustomLTXNodes.py:124-127``)."""
    return runtime_schedule_offset(expected_sigmas, runtime_sigmas) \
        + current_transition_index(runtime_sigmas, timestep)


# ---------------------------------------------------------------------------
# Per-temporal-tile strength schedules (looping sampler)
# ---------------------------------------------------------------------------

def parse_strength_schedule(value, fallback: float,
                            field_name: str = "schedule") -> list[float]:
    """Parse a comma-separated per-tile strength list.

    Empty input falls back to ``[fallback]``; every item must be a float
    in [0, 1], with the failing 1-based position named in the error —
    the contract of ``VRGDG_LTXLoopingSampler.py:133-157``.
    """
    text = str(value or "").strip()
    if not text:
        return [float(fallback)]
    out: list[float] = []
    for position, item in enumerate(text.split(","), start=1):
        item = item.strip()
        if not item:
            raise ValueError(f"{field_name} item {position} is empty.")
        try:
            strength = float(item)
        except ValueError as exc:
            raise ValueError(f"{field_name} item {position} is not a "
                             f"number: {item!r}") from exc
        if not 0.0 <= strength <= 1.0:
            raise ValueError(f"{field_name} values must be between 0.0 and "
                             f"1.0; item {position} was {strength}.")
        out.append(strength)
    return out


def scheduled_strength(schedule, index: int, fallback: float) -> float:
    """Strength for temporal tile ``index``: the last schedule value
    repeats past the end; no schedule means the flat fallback
    (``VRGDG_LTXLoopingSampler.py:159-164``)."""
    if not schedule:
        return float(fallback)
    return float(schedule[min(int(index), len(schedule) - 1)])


# ---------------------------------------------------------------------------
# First/last-frame temporal blend guide
# ---------------------------------------------------------------------------

GUIDE_CURVES = ("smoothstep", "linear", "ease_in", "ease_out")


def apply_curve(values, curve: str = "smoothstep"):
    """Vectorized easing curve on values already clipped to [0, 1]."""
    x = torch.as_tensor(values)
    if curve == "linear":
        return x
    if curve == "ease_in":
        return x * x
    if curve == "ease_out":
        return 1.0 - (1.0 - x) * (1.0 - x)
    if curve == "smoothstep":
        return x * x * (3.0 - 2.0 * x)
    raise ValueError(f"Unknown curve {curve!r}; one of {GUIDE_CURVES}")


def guide_frame_count(latent_length: int, time_scale: int) -> int:
    """Pixel-frame count covered by a video latent of ``latent_length``
    steps at the VAE's temporal downscale
    (``VRGDG_LTXFirstLastGuide.py:52-54``)."""
    return max(1, (int(latent_length) - 1) * int(time_scale) + 1)


def first_last_blend(first, last, frame_count: int,
                     transition_start: float = 0.05,
                     transition_end: float = 0.90,
                     curve: str = "smoothstep"):
    """Cross-fade guide video between two frames, one broadcast expression
    on ``first``'s device.

    Returns ``(frame_count, H, W, C)`` float32 where frame ``i`` is
    ``first*(1-a_i) + last*a_i`` with ``a_i`` the eased progress of
    ``i/(N-1)`` through the ``[transition_start, transition_end]``
    window.  ``last`` is resampled to ``first``'s dimensions when they
    differ (bilinear, matching ``comfy.utils.common_upscale``'s default
    path).
    """
    from .resize import resample

    first = torch.as_tensor(first).to(torch.float32)
    last = torch.as_tensor(last).to(device=first.device, dtype=torch.float32)
    if first.ndim == 3:
        first = first[None]
    if last.ndim == 3:
        last = last[None]
    first = first[:1]
    last = last[:1]
    if last.shape[1:3] != first.shape[1:3]:
        last = resample(last, int(first.shape[1]), int(first.shape[2]),
                        method="bilinear")
    n = max(1, int(frame_count))
    start = max(0.0, min(0.95, float(transition_start)))
    end = max(start + 0.01, min(1.0, float(transition_end)))
    position = torch.arange(n, dtype=torch.float32,
                            device=first.device) / max(1, n - 1)
    amount = torch.clamp((position - start) / (end - start), 0.0, 1.0)
    amount = apply_curve(amount, curve)[:, None, None, None]
    return first * (1.0 - amount) + last * amount
