#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vrgdg_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):

1. device: the card's name, its ``nvidia-smi`` name and power limit;
2. build: the three kernel libraries (``grade``, ``grain``, ``probe``)
   compiled from ``kernels/csrc`` with nvcc, all started together;
3. kernel vs plain: the fused kernels against their plain PyTorch versions
   on the card, on the flagship stack (LUT ``LUTS/teal_orange.cube`` at 8,
   adjust contrast 12 / vignette 20, colour match 0.7, unsharp 1.5 zero
   border, grain 0.05 / 0.5 / seed 42) at 1080p x 8, 4K x 2 and
   1 x 1079 x 1917, grain off and on, with the max abs errors beside their
   bounds and the CUDA-event times of kernel and plain version;
4. determinism: reruns and batch splits are bit-identical;
5. main path: seeded uint8 batches streamed through the appliers'
   generator in fused mode (48 frames of 4K at batch 2, 100 frames of
   1080p at batch 8, which pads the tail batch), with the launch counts of
   both kernels, frame counts, fps and device ms per frame; a small clip
   is checked against the eager CPU path;
6. grain kernel vs plain: ``film_grain`` against the eager ``film_grain``
   at the three shapes and an RGBA 1080p frame, a batch split, and the
   noise statistics on the card;
7. grain path: the ``grain_mode="kernel"`` eager stack of ``bench.py``'s
   ``fused_pallas_grain`` (LUT at 8, colour match 0.7, unsharp 1.5 zero
   border, grain 0.05 / 0.5 / seed 42) streamed at 4K x 2, with the grain
   kernel's launches (one per batch), fps and device ms per frame, then
   the same stream with the default torch-op grain for comparison; a
   small clip is checked against the eager CPU path;
8. layouts: the planes kernels against their plain versions at the three
   shapes, then ``fused_post_gather`` with ``layout="rowmajor"`` and
   ``"plane"`` against ``"flat"`` at 4K x 2, grain off and on, with each
   layout's CUDA-event time and peak memory;
9. probe: ``python -m vrgdg_tpu_torch.tools.probe_transpose``'s run, and
   ``weighted_row_sum`` against its plain version at (4096, 24) and at
   4K x 2's pixel count;
10. file: if cv2 imports, ``grade_video`` on a generated file.

Each path (5, 7, 8's layout run, 9's probe run) is driven with the launch
counts set to 0 just before it and read just after; launches made to
compare a kernel with its plain version are not counted.  The last three
lines are the kernels' JSON record, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.  Exits with a non-zero code
and prints no result when no CUDA card is visible or the package is
missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = dict(lut_name="teal_orange.cube", lut_strength=8.0,
                adjust={"contrast": 12.0, "vignette": 20.0},
                match_strength=0.7, sharpen_strength=1.5,
                grain_intensity=0.05, saturation_mix=0.5, seed=42)
SHAPES = ((8, 1080, 1920), (2, 2160, 3840), (1, 1079, 1917))
TIMED_SHAPE = (2, 2160, 3840)
SPLIT_SHAPE = (8, 1080, 1920)
RUNS = ((48, 2, 2160, 3840), (100, 8, 1080, 1920))   # frames, batch, H, W
GRAIN_RUN = (48, 2, 2160, 3840)
TIMED_PASSES = 3
# kernel vs plain on the card: nvcc contracts a*b+c into FMAs and its
# powf/cbrtf/logf differ from the plain ops' by an ulp or two.  Measured
# on an H100 (700 W): LAB 1.2e-4, A/B 9.5e-7, RGB 1.07e-5 with grain off
# and on.  The planes layouts and the grain kernel run the same formulas,
# so they are held to the same bounds; the probe to its TPU tool's 1e-4.
BOUNDS = {"lab": 5e-4, "coeff": 1e-5, "rgb_grain_off": 2e-5,
          "rgb_grain_on": 5e-5, "probe": 1e-4}
# kernel -> (its source, the TPU kernel it replaces)
SOURCES = {
    "grade_phase1": ("vrgdg_tpu_torch/kernels/csrc/grade.cu",
                     "vrgdg_tpu/kernels/grade_pallas.py:297"),
    "grade_phase2": ("vrgdg_tpu_torch/kernels/csrc/grade.cu",
                     "vrgdg_tpu/kernels/grade_pallas.py:453"),
    "grade_phase1_planes": ("vrgdg_tpu_torch/kernels/csrc/grade.cu",
                            "vrgdg_tpu/kernels/grade_pallas.py:218"),
    "grade_phase2_planes": ("vrgdg_tpu_torch/kernels/csrc/grade.cu",
                            "vrgdg_tpu/kernels/grade_pallas.py:380"),
    "film_grain": ("vrgdg_tpu_torch/kernels/csrc/grain.cu",
                   "vrgdg_tpu/kernels/grain_pallas.py:52"),
    "weighted_row_sum": ("vrgdg_tpu_torch/kernels/csrc/probe.cu",
                         "tools/probe_transpose.py:34"),
}


def _say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _nvidia_smi() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return result.stdout.strip().splitlines()[0].strip()


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _timed_pair(kernel, plain, reps: int) -> tuple[float, float]:
    """CUDA-event ms of a kernel (``reps`` launches) and of its plain
    version (a quarter as many, at least 2)."""
    return _cuda_ms(kernel, reps), _cuda_ms(plain, max(2, reps // 4))


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _check(name: str, err: float, bound: float) -> None:
    if not err <= bound:
        raise AssertionError(f"{name}: max abs error {err} > bound {bound}")


def _label(shape) -> str:
    return "x".join(map(str, shape))


def _stack(device):
    """Flagship config, LUT and seeded reference statistics on ``device``."""
    from vrgdg_tpu_torch.api import appliers, paths
    from vrgdg_tpu_torch.core.cube import GLOBAL_LUT_CACHE
    from vrgdg_tpu_torch.ops.color_match import lab_statistics

    lut = GLOBAL_LUT_CACHE.load(paths.safe_lut_path(FLAGSHIP["lut_name"]))
    generator = torch.Generator(device="cpu").manual_seed(7)
    reference = torch.rand((1, 64, 64, 3), generator=generator)
    ref_stats = lab_statistics(reference.to(device))
    config = appliers.grade_config(
        lut=lut, lut_strength=FLAGSHIP["lut_strength"],
        adjust=FLAGSHIP["adjust"], ref_stats=ref_stats,
        match_strength=FLAGSHIP["match_strength"],
        sharpen_strength=FLAGSHIP["sharpen_strength"],
        grain_intensity=FLAGSHIP["grain_intensity"],
        saturation_mix=FLAGSHIP["saturation_mix"], seed=FLAGSHIP["seed"],
        fused_mode="fused")
    return config, lut, ref_stats


def _frames(shape, seed: int, device, channels: int = 3):
    generator = torch.Generator(device="cpu").manual_seed(seed)
    u8 = torch.randint(0, 256, (*shape, channels), dtype=torch.uint8,
                       generator=generator)
    return u8.to(device).to(torch.float32) / 255.0


def kernels_vs_plain(device, config, lut, ref_stats, shapes, reps=10):
    """Phase 3: returns per-kernel max errors and the timed shape's ms."""
    from vrgdg_tpu_torch.kernels import grade_cuda as gc
    from vrgdg_tpu_torch.ops.grade import _active_adjust, prepare_operands

    table, dmin, dmax, ref_mean, ref_std = prepare_operands(
        config, lut=lut, ref_stats=ref_stats, device=device)
    blend = config.lut.strength / 10.0
    adjust = _active_adjust(config)
    domain = gc.lut_domain(dmin, dmax)
    grain = config.grain
    errors = {"grade_phase1": 0.0, "grade_phase2": 0.0}
    times = {}
    for index, shape in enumerate(shapes):
        frames = _frames(shape, 100 + index, device)
        pixels = shape[1] * shape[2]
        lab_k, part_k = gc.phase1(frames, table, domain, blend=blend,
                                  adjust=adjust)
        lab_p, part_p = gc.phase1_plain(frames, table, domain, blend=blend,
                                        adjust=adjust)
        coeff_k = gc.stats_barrier(part_k, pixels, ref_mean, ref_std,
                                   config.color_match.match_strength)
        coeff_p = gc.stats_barrier(part_p, pixels, ref_mean, ref_std,
                                   config.color_match.match_strength)
        lab_err = _max_err(lab_k, lab_p)
        coeff_err = _max_err(coeff_k, coeff_p)
        _check(f"{shape} LAB", lab_err, BOUNDS["lab"])
        _check(f"{shape} A/B coefficients", coeff_err, BOUNDS["coeff"])
        errors["grade_phase1"] = max(errors["grade_phase1"], lab_err)
        line = dict(shape=_label(shape),
                    lab_err=f"{lab_err:.3g}<={BOUNDS['lab']:g}",
                    coeff_err=f"{coeff_err:.3g}<={BOUNDS['coeff']:g}")
        for label, intensity in (("off", 0.0), ("on", grain.intensity)):
            kw = dict(sharpen_strength=config.sharpen.strength,
                      grain_intensity=intensity,
                      saturation_mix=grain.saturation_mix,
                      seed_base=grain.seed)
            bound = BOUNDS[f"rgb_grain_{label}"]
            p2_err = _max_err(gc.phase2(lab_p, coeff_p, **kw),
                              gc.phase2_plain(lab_p, coeff_p, **kw))
            _check(f"{shape} phase 2 grain {label}", p2_err, bound)
            errors["grade_phase2"] = max(errors["grade_phase2"], p2_err)
            full = dict(blend=blend,
                        match_strength=config.color_match.match_strength,
                        sharpen_strength=config.sharpen.strength,
                        grain_intensity=intensity,
                        saturation_mix=grain.saturation_mix, adjust=adjust)
            args = (frames, table, dmin, dmax, ref_mean, ref_std, grain.seed)
            rgb_err = _max_err(gc.fused_post_gather(*args, **full),
                               gc.fused_post_gather_plain(*args, **full))
            _check(f"{shape} RGB grain {label}", rgb_err, bound)
            line[f"phase2_err_grain_{label}"] = f"{p2_err:.3g}<={bound:g}"
            line[f"rgb_err_grain_{label}"] = f"{rgb_err:.3g}<={bound:g}"
        _say("kernel-vs-plain", **line)

        kw = dict(sharpen_strength=config.sharpen.strength,
                  grain_intensity=grain.intensity,
                  saturation_mix=grain.saturation_mix, seed_base=grain.seed)
        shape_times = {
            "grade_phase1": _timed_pair(
                lambda: gc.phase1(frames, table, domain, blend=blend,
                                  adjust=adjust),
                lambda: gc.phase1_plain(frames, table, domain, blend=blend,
                                        adjust=adjust), reps),
            "grade_phase2": _timed_pair(
                lambda: gc.phase2(lab_p, coeff_p, **kw),
                lambda: gc.phase2_plain(lab_p, coeff_p, **kw), reps),
        }
        _say("kernel-ms", shape=_label(shape),
             **{f"{name}_ms": f"{k:.4f}" for name, (k, _) in shape_times.items()},
             **{f"{name}_plain_ms": f"{p:.4f}"
                for name, (_, p) in shape_times.items()})
        if tuple(shape) == TIMED_SHAPE:
            times = shape_times
        del frames, lab_k, lab_p, part_k, part_p
        torch.cuda.empty_cache()
    return errors, times


def determinism(device, config, lut, ref_stats, shape=SPLIT_SHAPE) -> None:
    """Phase 4: bit-identical reruns and batch splits (fused, grain on)."""
    from vrgdg_tpu_torch.ops.grade import grade_prepared, prepare_operands

    operands = prepare_operands(config, lut=lut, ref_stats=ref_stats,
                                device=device)
    frames = _frames(shape, 200, device)
    whole = grade_prepared(frames, config, *operands, frame_start=0)
    again = grade_prepared(frames, config, *operands, frame_start=0)
    split = torch.cat([
        grade_prepared(frames[0:3], config, *operands, frame_start=0),
        grade_prepared(frames[3:8], config, *operands, frame_start=3)])
    if not torch.equal(whole, again):
        raise AssertionError("fused grade rerun is not bit-identical")
    if not torch.equal(whole, split):
        raise AssertionError("frames[0:8]@0 != frames[0:3]@0 + frames[3:8]@3")
    _say("determinism", rerun="bit-identical", split_0_3_8="bit-identical")


def _source(count: int, batch: int, height: int, width: int, seed: int):
    """Seeded uint8 (B, H, W, 3) batches for ``count`` frames, cycled from a
    pool of three made in bulk here, before any run is timed."""
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, (batch, height, width, 3), np.uint8)
            for _ in range(3)]
    return [(start, pool[number % 3][:min(batch, count - start)])
            for number, start in enumerate(range(0, count, batch))]


def _clip_check(label: str, config, device, lut, ref_stats) -> None:
    """A small clip through ``config`` on the card and through the eager
    chain (default grain) on the CPU: at most one uint8 level apart on at
    most 0.1% of values."""
    from vrgdg_tpu_torch.api import appliers

    small = list(_source(5, 2, 270, 480, 11))
    on_card = appliers.grade_effect(config, device, lut=lut,
                                    ref_stats=ref_stats)
    eager_config = dataclasses.replace(config, fused_mode="eager",
                                       grain_mode="eager")
    eager = appliers.grade_effect(
        eager_config, "cpu", lut=lut,
        ref_stats=tuple(t.cpu() for t in ref_stats))
    got = np.concatenate(list(appliers.stream_graded_batches(
        small, on_card, batch_size=2, device=device)))
    want = np.concatenate(list(appliers.stream_graded_batches(
        small, eager, batch_size=2, device="cpu")))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((diff > 0).mean())
    if got.shape != (5, 270, 480, 3) or diff.max() > 1 or share > 1e-3:
        raise AssertionError(f"{label} card path vs eager CPU path: shape "
                             f"{got.shape}, max {diff.max()} levels, "
                             f"{share:.2e} of values differ")
    _say(f"{label}-check", frames=5, shape="270x480",
         max_level_diff=int(diff.max()), differing_share=f"{share:.2e}<=1e-3")


def _stream_runs(label: str, effect, device, card: str, runs,
                 kernels: tuple[str, ...], per_batch: bool = False) -> dict:
    """Timed passes of the appliers' generator over seeded uint8 batches;
    returns the launches of ``kernels`` summed over the timed passes.

    Counts are set to 0 just before each pass and read just after; a pass
    that launches one of ``kernels`` no time fails (or, with
    ``per_batch``, not exactly once per batch)."""
    from vrgdg_tpu_torch.api import appliers
    from vrgdg_tpu_torch.kernels import build

    launches = dict.fromkeys(kernels, 0)
    for count, batch, height, width in runs:
        source = _source(count, batch, height, width, count)
        # warm-up pass: allocates the pinned host buffers the runs reuse
        for _ in appliers.stream_graded_batches(
                source, effect, batch_size=batch, device=device):
            pass
        fps, device_ms = [], []
        for _ in range(TIMED_PASSES):
            stats: dict = {}
            build.reset_launch_counts()
            started = time.perf_counter()
            shapes = [out.shape for out in appliers.stream_graded_batches(
                source, effect, batch_size=batch, device=device,
                stats=stats)]
            wall = time.perf_counter() - started
            counts = {name: build.LAUNCHES[name] for name in kernels}
            frames = sum(s[0] for s in shapes)
            if frames != count or any(s[1:] != (height, width, 3)
                                      for s in shapes):
                raise AssertionError(
                    f"{label} returned {frames} frames of shapes "
                    f"{set(shapes)}; expected {count} of {height}x{width}x3")
            for name, value in counts.items():
                if value == 0 or (per_batch and value != len(source)):
                    raise AssertionError(
                        f"{label} launched {name} {value} times over "
                        f"{len(source)} batches")
                launches[name] += value
            fps.append(count / wall)
            device_ms.append(stats["device_ms"] / count)
        _say(label, frames=count, size=f"{height}x{width}",
             batch=batch, passes=TIMED_PASSES, launches_per_pass=counts,
             wall_fps=",".join(f"{v:.2f}" for v in fps),
             median_wall_fps=f"{float(np.median(fps)):.2f}",
             device_ms_per_frame=",".join(f"{v:.4f}" for v in device_ms),
             card=f"'{card}'")
        breakdown(source, effect, batch, device)
    torch.cuda.empty_cache()
    return launches


def main_path(device, config, lut, ref_stats, card: str,
              runs=RUNS) -> dict:
    """Phase 5: the appliers' generator in fused mode; returns the launch
    counts of the runs."""
    from vrgdg_tpu_torch.api import appliers

    _clip_check("main-path", config, device, lut, ref_stats)
    effect = appliers.grade_effect(config, device, lut=lut,
                                   ref_stats=ref_stats)
    return _stream_runs("main-path", effect, device, card, runs,
                        ("grade_phase1", "grade_phase2"))


def breakdown(source, effect, batch: int, device) -> None:
    """Device time by kernel over one more pass of the main path, from
    ``torch.profiler``, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from vrgdg_tpu_torch.api import appliers

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        started = time.perf_counter()
        for _ in appliers.stream_graded_batches(
                source, effect, batch_size=batch, device=device):
            pass
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3
    rows = []
    for event in prof.key_averages():
        # device-side events only (kernels, memcpys): the CPU ops that
        # launched them report the same device time again
        if not str(event.device_type).endswith("CUDA"):
            continue
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "self_cuda_time_total", 0.0)
        if device_us > 0:
            rows.append((device_us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    frames = sum(b.shape[0] for _, b in source)
    _say("breakdown", frames=frames, wall_ms=f"{wall_ms:.3f}",
         device_busy_ms=f"{busy_ms:.3f}",
         device_busy_share=f"{busy_ms / wall_ms:.4f}")
    for ms, count, name in rows[:10]:
        print(f"  device_ms={ms:.3f} calls={count} name={name[:90]}",
              flush=True)


def grain_vs_plain(device, reps=10):
    """Phase 6: the grain kernel against the eager ``film_grain`` (the
    same Philox stream, so value for value); returns its max error and
    its ms at the timed shape."""
    from vrgdg_tpu_torch.kernels.grain_cuda import film_grain_kernel
    from vrgdg_tpu_torch.ops.grain import film_grain

    args = (FLAGSHIP["grain_intensity"], FLAGSHIP["saturation_mix"],
            FLAGSHIP["seed"])
    bound = BOUNDS["rgb_grain_on"]
    worst, timed = 0.0, None
    cases = [(shape, 3) for shape in SHAPES] + [((1, 1080, 1920), 4)]
    for index, (shape, channels) in enumerate(cases):
        frames = _frames(shape, 300 + index, device, channels)
        got = film_grain_kernel(frames, *args, frame_start=5)
        want = film_grain(frames, *args, frame_start=5)
        err = _max_err(got, want)
        _check(f"{shape}x{channels} grain", err, bound)
        if channels > 3 and not torch.equal(got[..., 3:], frames[..., 3:]):
            raise AssertionError("the grain kernel changed the alpha channel")
        worst = max(worst, err)
        ms = _timed_pair(lambda: film_grain_kernel(frames, *args),
                         lambda: film_grain(frames, *args), reps)
        _say("grain-vs-plain", shape=f"{_label(shape)}x{channels}",
             err=f"{err:.3g}<={bound:g}", film_grain_ms=f"{ms[0]:.4f}",
             film_grain_plain_ms=f"{ms[1]:.4f}")
        if tuple(shape) == TIMED_SHAPE:
            timed = ms
        del frames, got, want

    frames = _frames(SPLIT_SHAPE, 310, device)
    whole = film_grain_kernel(frames, *args, frame_start=0)
    split = torch.cat([film_grain_kernel(frames[0:3], *args, frame_start=0),
                       film_grain_kernel(frames[3:8], *args, frame_start=3)])
    if not torch.equal(whole, split):
        raise AssertionError("grain kernel: frames[0:8]@0 != "
                             "frames[0:3]@0 + frames[3:8]@3")
    # tests/test_grain_pallas.py:79-87's statistics, over 16.6M values a
    # channel: std ratios 2 and 3 and std 1 within 5%, mean 0 within 0.02
    grey = torch.full((*TIMED_SHAPE, 3), 0.5, device=device)
    noise = ((film_grain_kernel(grey, 0.01, 1.0, 3) - 0.5) / 0.01).double()
    stds = noise.reshape(-1, 3).std(dim=0).tolist()
    mean = float(noise.mean())
    if not (abs(stds[0] / stds[1] - 2.0) <= 0.1
            and abs(stds[2] / stds[1] - 3.0) <= 0.15
            and abs(stds[1] - 1.0) <= 0.05 and abs(mean) <= 0.02):
        raise AssertionError(f"grain statistics: stds {stds}, mean {mean}")
    _say("grain-checks", split_0_3_8="bit-identical",
         std_ratio_r=f"{stds[0] / stds[1]:.4f}",
         std_ratio_b=f"{stds[2] / stds[1]:.4f}", std_g=f"{stds[1]:.4f}",
         mean=f"{mean:.2e}")
    del frames, whole, split, grey, noise
    torch.cuda.empty_cache()
    return worst, timed


def grain_path(device, lut, ref_stats, card: str) -> dict:
    """Phase 7: ``grain_mode="kernel"`` through the appliers' generator."""
    from vrgdg_tpu_torch.api import appliers

    config = dataclasses.replace(appliers.grade_config(
        lut=lut, lut_strength=FLAGSHIP["lut_strength"], ref_stats=ref_stats,
        match_strength=FLAGSHIP["match_strength"],
        sharpen_strength=FLAGSHIP["sharpen_strength"],
        grain_intensity=FLAGSHIP["grain_intensity"],
        saturation_mix=FLAGSHIP["saturation_mix"], seed=FLAGSHIP["seed"],
        fused_mode="eager"), grain_mode="kernel")
    _clip_check("grain-path", config, device, lut, ref_stats)
    effect = appliers.grade_effect(config, device, lut=lut,
                                   ref_stats=ref_stats)
    launches = _stream_runs("grain-path", effect, device, card,
                            (GRAIN_RUN,), ("film_grain",), per_batch=True)
    # the same stream with the default torch-op grain, for comparison
    eager = appliers.grade_effect(
        dataclasses.replace(config, grain_mode="eager"), device, lut=lut,
        ref_stats=ref_stats)
    _stream_runs("grain-path-eager-grain", eager, device, card,
                 (GRAIN_RUN,), ())
    return launches


def layouts(device, config, lut, ref_stats, shapes, reps=10):
    """Phase 8: the planes kernels against their plain versions, then the
    ``"rowmajor"`` and ``"plane"`` layouts against ``"flat"``; returns
    max errors, the timed shape's ms and the layout run's launches."""
    from vrgdg_tpu_torch.kernels import build
    from vrgdg_tpu_torch.kernels import grade_cuda as gc
    from vrgdg_tpu_torch.ops.grade import _active_adjust, prepare_operands

    operands = prepare_operands(config, lut=lut, ref_stats=ref_stats,
                                device=device)
    table, dmin, dmax, ref_mean, ref_std = operands
    blend = config.lut.strength / 10.0
    match = config.color_match.match_strength
    domain = gc.lut_domain(dmin, dmax)
    size = round(table.shape[0] ** (1.0 / 3.0))
    grain = config.grain
    errors = {"grade_phase1_planes": 0.0, "grade_phase2_planes": 0.0}
    times = {}
    for index, shape in enumerate(shapes):
        frames = _frames(shape, 400 + index, device)
        src = frames.permute(3, 0, 1, 2).contiguous()
        planes = gc.corner_planes(src, table, domain)
        lab_k, part_k = gc.phase1_planes(src, planes, domain, blend=blend,
                                         lut_size=size)
        lab_p, part_p = gc.phase1_planes_plain(src, planes, domain,
                                               blend=blend, lut_size=size)
        pixels = shape[1] * shape[2]
        coeff_k, coeff_p = (gc.stats_barrier(p, pixels, ref_mean, ref_std,
                                             match) for p in (part_k, part_p))
        lab_err, coeff_err = _max_err(lab_k, lab_p), _max_err(coeff_k, coeff_p)
        _check(f"{shape} planes LAB", lab_err, BOUNDS["lab"])
        _check(f"{shape} planes A/B", coeff_err, BOUNDS["coeff"])
        errors["grade_phase1_planes"] = max(errors["grade_phase1_planes"],
                                            lab_err)
        line = dict(shape=_label(shape),
                    lab_err=f"{lab_err:.3g}<={BOUNDS['lab']:g}",
                    coeff_err=f"{coeff_err:.3g}<={BOUNDS['coeff']:g}")
        for label, intensity in (("off", 0.0), ("on", grain.intensity)):
            kw = dict(sharpen_strength=config.sharpen.strength,
                      grain_intensity=intensity,
                      saturation_mix=grain.saturation_mix,
                      seed_base=grain.seed)
            bound = BOUNDS[f"rgb_grain_{label}"]
            err = _max_err(gc.phase2_planes(lab_p, coeff_p, **kw),
                           gc.phase2_planes_plain(lab_p, coeff_p, **kw))
            _check(f"{shape} planes phase 2 grain {label}", err, bound)
            errors["grade_phase2_planes"] = max(
                errors["grade_phase2_planes"], err)
            line[f"phase2_err_grain_{label}"] = f"{err:.3g}<={bound:g}"
        _say("planes-vs-plain", **line)
        shape_times = {
            "grade_phase1_planes": _timed_pair(
                lambda: gc.phase1_planes(src, planes, domain, blend=blend,
                                         lut_size=size),
                lambda: gc.phase1_planes_plain(src, planes, domain,
                                               blend=blend, lut_size=size),
                reps),
            "grade_phase2_planes": _timed_pair(
                lambda: gc.phase2_planes(lab_p, coeff_p, **kw),
                lambda: gc.phase2_planes_plain(lab_p, coeff_p, **kw), reps),
        }
        _say("planes-ms", shape=_label(shape),
             **{f"{name}_ms": f"{k:.4f}" for name, (k, _) in shape_times.items()},
             **{f"{name}_plain_ms": f"{p:.4f}"
                for name, (_, p) in shape_times.items()})
        if tuple(shape) == TIMED_SHAPE:
            times = shape_times
        del frames, src, planes, lab_k, lab_p, part_k, part_p
        torch.cuda.empty_cache()

    # the layouts end to end at 4K x 2, on bench.py's fused_pallas2 stack
    # (no adjust: the plane layout has none)
    frames = _frames(TIMED_SHAPE, 450, device)
    flat, launches = {}, {}
    for label, intensity in (("off", 0.0), ("on", grain.intensity)):
        kw = dict(blend=blend, match_strength=match,
                  sharpen_strength=config.sharpen.strength,
                  grain_intensity=intensity,
                  saturation_mix=grain.saturation_mix)
        flat[label] = (kw, gc.fused_post_gather(frames, *operands,
                                                grain.seed, **kw))
    build.reset_launch_counts()
    got = {(layout, label): gc.fused_post_gather(
               frames, *operands, grain.seed, layout=layout, **kw)
           for label, (kw, _) in flat.items()
           for layout in ("rowmajor", "plane")}
    torch.cuda.synchronize()
    launches = {name: build.LAUNCHES[name]
                for name in ("grade_phase1_planes", "grade_phase2_planes")}
    line = {}
    for (layout, label), out in got.items():
        bound = BOUNDS[f"rgb_grain_{label}"]
        err = _max_err(out, flat[label][1])
        _check(f"layout {layout} vs flat, grain {label}", err, bound)
        line[f"{layout}_err_grain_{label}"] = f"{err:.3g}<={bound:g}"
    kw = flat["on"][0]
    planes_out = gc.fused_post_gather(frames, *operands, grain.seed,
                                      layout="plane", emit="planes", **kw)
    if not torch.equal(planes_out, got[("plane", "on")].permute(0, 3, 1, 2)):
        raise AssertionError("emit='planes' differs from the BHWC output")
    adjust = _active_adjust(config)
    with_adjust = {layout: gc.fused_post_gather(
        frames, *operands, grain.seed, layout=layout, adjust=adjust, **kw)
        for layout in ("flat", "rowmajor")}
    err = _max_err(with_adjust["rowmajor"], with_adjust["flat"])
    _check("layout rowmajor vs flat with adjust", err, BOUNDS["rgb_grain_on"])
    line["rowmajor_adjust_err_grain_on"] = f"{err:.3g}"
    _say("layouts-vs-flat", shape=_label(TIMED_SHAPE), launches=launches,
         **line)
    kwargs = {label: kw for label, (kw, _) in flat.items()}
    del got, planes_out, with_adjust, flat
    torch.cuda.empty_cache()
    for label, kw in kwargs.items():
        for layout in ("flat", "rowmajor", "plane"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            ms = _cuda_ms(lambda: gc.fused_post_gather(
                frames, *operands, grain.seed, layout=layout, **kw), reps)
            peak = torch.cuda.max_memory_allocated(device) - base
            _say("layout-ms", layout=layout, shape=_label(TIMED_SHAPE),
                 grain=label, ms=f"{ms:.4f}",
                 peak_mib=f"{peak / 2**20:.1f}")
    torch.cuda.empty_cache()
    return errors, times, launches


def probe(device, reps=10):
    """Phase 9: the transpose probe's run, then ``weighted_row_sum``
    against its plain version; returns max error, ms at 4K x 2's pixel
    count and the probe run's launches."""
    from vrgdg_tpu_torch.kernels import build, probe_cuda
    from vrgdg_tpu_torch.tools import probe_transpose

    build.reset_launch_counts()
    probe_err = probe_transpose.run(device)
    launches = {"weighted_row_sum": build.LAUNCHES["weighted_row_sum"]}
    _check("transpose probe vs its numpy oracle", probe_err, BOUNDS["probe"])
    _say("probe", rows=4096, err=f"{probe_err:.3g}<={BOUNDS['probe']:g}",
         launches=launches)
    worst, timed = 0.0, None
    pixels = TIMED_SHAPE[0] * TIMED_SHAPE[1] * TIMED_SHAPE[2]
    for rows in (4096, pixels):
        generator = torch.Generator(device="cpu").manual_seed(rows)
        g = (torch.rand((rows, 24), generator=generator) * 2 - 1).to(device)
        err = _max_err(probe_cuda.weighted_row_sum(g),
                       probe_cuda.weighted_row_sum_plain(g))
        _check(f"weighted_row_sum rows={rows}", err, BOUNDS["probe"])
        worst = max(worst, err)
        ms = _timed_pair(lambda: probe_cuda.weighted_row_sum(g),
                         lambda: probe_cuda.weighted_row_sum_plain(g), reps)
        _say("probe-vs-plain", rows=rows, err=f"{err:.3g}",
             weighted_row_sum_ms=f"{ms[0]:.4f}",
             weighted_row_sum_plain_ms=f"{ms[1]:.4f}")
        timed = ms
        del g
    torch.cuda.empty_cache()
    return worst, timed, launches


def file_phase(device, config, lut) -> None:
    """Phase 10: ``grade_video`` on a generated clip, if cv2 imports."""
    try:
        import cv2
    except ImportError:
        _say("file", ran="no", reason="cv2 is not importable on this machine")
        return
    from vrgdg_tpu_torch.api import appliers

    with tempfile.TemporaryDirectory() as folder:
        clip = os.path.join(folder, "clip.mp4")
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                                 (640, 360))
        rng = np.random.default_rng(3)
        for _ in range(30):
            writer.write(rng.integers(0, 256, (360, 640, 3), np.uint8))
        writer.release()
        reference = np.random.default_rng(4).uniform(
            0, 1, (64, 64, 3)).astype(np.float32)
        result = appliers.grade_video(
            clip, os.path.join(folder, "graded.mp4"),
            lut_name=FLAGSHIP["lut_name"],
            lut_strength=FLAGSHIP["lut_strength"],
            adjust=FLAGSHIP["adjust"], reference_image=reference,
            match_strength=FLAGSHIP["match_strength"],
            sharpen_strength=FLAGSHIP["sharpen_strength"],
            grain_intensity=FLAGSHIP["grain_intensity"],
            seed=FLAGSHIP["seed"], batch_size=8, fused_mode="fused",
            device=device)
        if (result["processed_frames"] != 30 or result["width"] != 640
                or result["height"] != 360):
            raise AssertionError(f"grade_video: {result}")
        _say("file", ran="yes", frames=result["processed_frames"],
             size="640x360", encoder=result["encoder"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card.", file=sys.stderr)
        return 1
    try:
        from vrgdg_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the vrgdg_tpu_torch package is missing ({exc}); "
              "run this script from the root of the repository.",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _nvidia_smi()
    _say("device", name=f"'{kind}'", nvidia_smi=f"'{card}'",
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    started = time.perf_counter()
    built = build.load_libraries()
    _say("build", seconds=f"{time.perf_counter() - started:.2f}",
         **{f"nvcc_{stem}_seconds": f"{b.seconds:.2f}"
            for stem, b in built.items()})
    for stem, library in built.items():
        for line in library.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}:", line.strip(), flush=True)

    config, lut, ref_stats = _stack(device)
    errors, times = kernels_vs_plain(device, config, lut, ref_stats, SHAPES)
    determinism(device, config, lut, ref_stats)
    launches = main_path(device, config, lut, ref_stats, card)
    errors["film_grain"], times["film_grain"] = grain_vs_plain(device)
    launches.update(grain_path(device, lut, ref_stats, card))
    layout_errors, layout_times, layout_launches = layouts(
        device, config, lut, ref_stats, SHAPES)
    errors.update(layout_errors)
    times.update(layout_times)
    launches.update(layout_launches)
    (errors["weighted_row_sum"], times["weighted_row_sum"],
     probe_launches) = probe(device)
    launches.update(probe_launches)
    file_phase(device, config, lut)

    for name in SOURCES:
        if launches.get(name, 0) == 0:
            raise AssertionError(f"no path launched {name}")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, (source, replaces) in SOURCES.items()]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
