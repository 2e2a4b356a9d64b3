"""Benchmark of the port: frames/sec on one CUDA card for the fused grade
stack, with a per-stage profile and measured hardware yardsticks.

    python3 -m vrgdg_tpu_torch.bench

Counterpart of ``bench.py``, function by function.  It measures the same
configurations on one card:

  1. 512x512 film grain alone (``grain_512``, batch 16)
  2. 1080p trilinear 3D LUT (``lut_1080p``, batch 8)
  3. 1080p color match + unsharp sharpen (``cm_sharpen_1080p``, batch 8)
  4. 4K grain + LUT + color match + sharpen, eager torch ops
     (``fused_4k``, batch 2), and the same stack with the ``film_grain``
     kernel (``fused_4k_pallas_grain``), through the two fused kernels
     (``fused_4k_pallas2``, the headline when it is the faster) and
     through them with the adjust sliders on (``fused_4k_pallas2_adjust``)

then the five stages of ``stage_ms_per_4k_frame`` at 4K x 2 and the
enhancer's device step (``enhance_step_1080p_to_4k``).  Each config's
``mode`` says what the port ran; the config keys are the JAX bench's.

Timing (:func:`chained_time`): ``steps`` dependent calls ``carry =
step_fn(carry, i)`` queued on the current stream between two CUDA events
and ended by a ``.item()`` of ``out[0, 0, 0, 0]``, the counterpart of the
JAX bench's scalar host fetch; one warm-up chain, then three timed ones.
No CUDA graphs and no ``torch.compile``: the bench times what the port
runs.  Each config reports:

- ``fps`` and ``wall_ms_per_frame``: the median host-clock time of a
  chain, the final ``.item()`` included;
- ``device_ms_per_frame`` (median, with min and max): the CUDA events
  around the chain.  They bracket the idle gaps too, so where the host's
  enqueue sets the pace they read about the wall time;
- ``launches``: the port's CUDA kernels the config launched
  (``kernels/build.LAUNCHES``); a config whose mode runs a kernel and
  counts no launch of it fails the run.

Baseline: ``oracle_cpu_fps``, the reference nodes' math in float32 torch
on the host's CPU, one 4K frame (:func:`bench_oracle_cpu`, kept as in
``bench.py``).  ``bench.py``'s ``chip_floor_fps`` and ``a100_estimate``,
models of other hardware, are not ported; the benchmark's rooflines
(``perfbench``) bound the streamed grade on this card.

Per-config detail goes to stderr; stdout gets ONE JSON line.  Without a
card the bench says why and exits 1: it has no CPU fallback.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .core.cube import build_palette_lut
from .core.params import (AdjustSettings, ColorMatchParams, EnhancerSettings,
                          GrainParams, LUTParams, SharpenParams)
from .jobs.enhancer import _enhance_step
from .kernels import build
from .ops.color_match import lab_statistics
from .ops.grade import GradeConfig, _bundle_for, grade_prepared

# Dependent steps per timed chain, as in bench.py.  On a card the fixed
# cost of a chain is the final .item() (call_overhead_ms), which 64 steps
# make small beside the per-step time.
TIMED_STEPS = 64
TIMED_CHAINS = 3
PALETTE = "#0b1d51, #1f6aa5, #f3d27a"
LUT_SIZE = 33
HEADLINE_SHAPE = (2, 2160, 3840)
# name, build_stack key, batch, height, width (bench.py's main)
CONFIGS = (
    ("grain_512", "grain_only", 16, 512, 512),
    ("lut_1080p", "lut_only", 8, 1080, 1920),
    ("cm_sharpen_1080p", "cm_sharpen", 8, 1080, 1920),
    ("fused_4k", "fused", 2, 2160, 3840),
    ("fused_4k_pallas_grain", "fused_pallas_grain", 2, 2160, 3840),
    ("fused_4k_pallas2", "fused_pallas2", 2, 2160, 3840),
    ("fused_4k_pallas2_adjust", "fused_pallas2_adjust", 2, 2160, 3840),
)
STAGES = ("lut_only", "cm_only", "sharpen_only", "grain_only", "adjust_only")
# bench.py's enhance_step_1080p_to_4k: lanczos4 to 4K, unsharp 1.0,
# grain 0.05, seed 42
ENHANCE = {"upscale_resolution": "4k", "sharpen_strength": 1.0,
           "grain_enabled": True, "grain_intensity": 0.05, "seed": 42}
FUSED_MODE = "fused (grade_phase1+grade_phase2)"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _is_oom(exc: Exception) -> bool:
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def _card(device) -> torch.device:
    """``device`` as a CUDA device; raises for anything else."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the bench times a CUDA card; got device {device!s} "
            f"(torch.cuda.is_available() is {torch.cuda.is_available()})")
    return device


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"
    return done.stdout.strip().splitlines()[0].strip()


@dataclass(frozen=True)
class ChainTime:
    """Per-step times of a chain: the median wall seconds (host clock to
    the final ``.item()``) and the median, min and max CUDA-event ms."""

    wall_s: float
    device_ms: float
    device_ms_min: float
    device_ms_max: float


def _chain(step_fn, x0: torch.Tensor, steps: int) -> torch.Tensor:
    carry = x0
    for i in range(steps):
        carry = step_fn(carry, i)
    return carry


def _fetch(out: torch.Tensor, x0: torch.Tensor) -> float:
    """The chain's hard sync: one scalar to the host, which must be finite
    and come from a carry of the input's shape."""
    if out.shape != x0.shape:
        raise RuntimeError(f"a step changed the carry's shape from "
                           f"{tuple(x0.shape)} to {tuple(out.shape)}")
    value = out[0, 0, 0, 0].item()
    if not np.isfinite(value):
        raise RuntimeError(f"the chain ended on a non-finite value {value}")
    return value


def chained_time(step_fn, x0: torch.Tensor,
                 steps: int = TIMED_STEPS) -> ChainTime:
    """Time ``steps`` dependent applications of ``step_fn`` on ``x0``'s
    card: one warm-up chain, then :data:`TIMED_CHAINS` timed ones."""
    _card(x0.device)
    _fetch(_chain(step_fn, x0, steps), x0)
    walls, device_ms = [], []
    for _ in range(TIMED_CHAINS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        started = time.perf_counter()
        start.record()
        out = _chain(step_fn, x0, steps)
        end.record()
        _fetch(out, x0)
        walls.append(time.perf_counter() - started)
        device_ms.append(start.elapsed_time(end))
        del out
    return ChainTime(
        wall_s=float(np.median(walls)) / steps,
        device_ms=float(np.median(device_ms)) / steps,
        device_ms_min=min(device_ms) / steps,
        device_ms_max=max(device_ms) / steps)


def call_overhead(device="cuda") -> float:
    """Median ms of 5 round trips of a trivial computation and its scalar
    fetch: the fixed cost each timed chain pays once."""
    x = torch.ones((8,), dtype=torch.float32, device=_card(device))
    (x.sum() * 1.0000001).item()
    samples = []
    for _ in range(5):
        started = time.perf_counter()
        (x.sum() * 1.0000001).item()
        samples.append(time.perf_counter() - started)
    return float(np.median(samples) * 1e3)


def _event_ms(fn) -> float:
    """CUDA-event ms of one ``fn()`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def hardware_probes(device="cuda") -> dict:
    """The yardsticks that bound this stack, each timed by CUDA events:
    elementwise HBM bandwidth (one multiply a step over (64, 1024, 1024)
    float32, read and written once, 256 steps), the row-gather rate
    (``index_select`` of 8,000,000 rows from a (35937, 24) float32 table)
    and a ``copy_`` of a 4K x 2 float32 batch (24 bytes a pixel).  They
    are not ports of a kernel."""
    device = _card(device)
    generator = torch.Generator(device=device).manual_seed(0)
    ew_steps = 256
    src = torch.rand((64, 1024, 1024), generator=generator, device=device)
    dst = torch.empty_like(src)

    def elementwise():
        a, b = src, dst
        for _ in range(ew_steps):
            torch.mul(a, 1.0000001, out=b)
            a, b = b, a

    per_ms = _event_ms(elementwise) / ew_steps
    bw_gbps = 2 * src.numel() * 4 / (per_ms * 1e-3) / 1e9
    del src, dst

    rows, cells = 8_000_000, 35937
    table = torch.rand((cells, 24), generator=generator, device=device)
    idx0 = torch.from_numpy(np.random.default_rng(2).integers(
        0, cells, (rows,))).to(device)
    # bench.py's idx ^ 1, held inside the table (35936 ^ 1 is past it)
    idx1 = torch.clamp(idx0 ^ 1, max=cells - 1)
    rows_out = torch.empty((rows, 24), dtype=torch.float32, device=device)

    def gather():
        for k in range(TIMED_STEPS):
            torch.index_select(table, 0, idx1 if k & 1 else idx0,
                               out=rows_out)

    per_ms = _event_ms(gather) / TIMED_STEPS
    grate = rows / (per_ms * 1e-3) / 1e9
    del table, idx0, idx1, rows_out

    frames = torch.rand((*HEADLINE_SHAPE, 3), generator=generator,
                        device=device)
    copy = torch.empty_like(frames)
    reps = 64

    def copies():
        for _ in range(reps):
            copy.copy_(frames)

    copy_ms = _event_ms(copies) / reps
    copy_gbps = 2 * frames.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del frames, copy
    torch.cuda.empty_cache()
    return {"elementwise_gbps": bw_gbps, "gather_grows_per_s": grate,
            "copy_4k_x2_ms": copy_ms, "copy_4k_x2_gbps": copy_gbps}


def stack_configs() -> dict[str, GradeConfig]:
    """``bench.py``'s ten configurations, its modes mapped as
    :func:`vrgdg_tpu_torch.ops.grade.from_reference` maps them: ``xla`` ->
    ``eager``, ``pallas`` -> ``fused``; grain ``threefry`` -> ``eager``,
    ``pallas`` -> ``kernel``."""
    lut = LUTParams.normalize(8.0)
    match = ColorMatchParams.normalize(0.7)
    sharpen = SharpenParams.normalize(1.5, border="zero")
    grain = GrainParams.normalize(0.05, 0.5, seed=42)
    adjust = AdjustSettings.normalize(
        {"exposure": 10, "contrast": 12, "saturation": 8, "vignette": 20})
    stack = dict(lut=lut, color_match=match, sharpen=sharpen, grain=grain)
    return dict(
        grain_only=GradeConfig(grain=grain),
        lut_only=GradeConfig(lut=lut),
        cm_sharpen=GradeConfig(color_match=match, sharpen=sharpen),
        fused=GradeConfig(**stack),
        fused_pallas_grain=GradeConfig(**stack, grain_mode="kernel"),
        fused_pallas2=GradeConfig(**stack, fused_mode="fused"),
        fused_pallas2_adjust=GradeConfig(**stack, adjust=adjust,
                                         fused_mode="fused"),
        adjust_only=GradeConfig(adjust=adjust),
        sharpen_only=GradeConfig(sharpen=sharpen),
        cm_only=GradeConfig(color_match=match),
    )


def run_mode(config: GradeConfig) -> str:
    """What the port runs for ``config``."""
    if config.fused_mode == "fused":
        return FUSED_MODE
    kernels = expected_kernels(config)
    if not kernels:
        return "eager (torch ops)"
    return (f"eager (torch ops, {' and '.join(kernels)} "
            f"kernel{'s' if len(kernels) > 1 else ''})")


def expected_kernels(config: GradeConfig) -> tuple[str, ...]:
    """The port's CUDA kernels a step of ``config`` must launch on a card:
    the fused pair, or in the eager mode ``lut_apply`` for a bundle LUT
    (``ops.lut.apply_lut_bundle`` on CUDA frames) and ``film_grain`` for
    the kernel grain."""
    if config.fused_mode == "fused":
        return ("grade_phase1", "grade_phase2")
    kernels = ()
    if config.lut is not None and config.lut_mode == "bundle":
        kernels += ("lut_apply",)
    if config.grain is not None and config.grain.intensity > 0 \
            and config.grain_mode == "kernel":
        kernels += ("film_grain",)
    return kernels


def stack_operands(device):
    """The palette LUT and the operands every step grades with: its corner
    bundle, the unit domain and the LAB statistics of ``bench.py``'s
    seeded 256x256 reference."""
    lut = build_palette_lut(PALETTE, LUT_SIZE)
    bundle = _bundle_for(lut, device)
    dmin = torch.zeros(3, dtype=torch.float32, device=device)
    dmax = torch.ones(3, dtype=torch.float32, device=device)
    reference = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (1, 256, 256, 3)).astype(np.float32)).to(device)
    ref_mean, ref_std = lab_statistics(reference)
    return lut, (bundle, dmin, dmax, ref_mean, ref_std)


def grade_step(config: GradeConfig, operands):
    """One dependent step of a chain: the stack on the carry, frame start
    ``4 * i`` as in ``bench.py``."""
    def fn(carry, i):
        return grade_prepared(carry, config, *operands, frame_start=4 * i)
    return fn


def build_stack(device):
    lut, operands = stack_operands(device)
    return ({name: grade_step(config, operands)
             for name, config in stack_configs().items()}, lut)


def frames_for(batch, height, width, device):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(0, 1, (batch, height, width, 3))
                            .astype(np.float32)).to(device)


def measure(step_fn, batch, height, width, device="cuda",
            steps: int = TIMED_STEPS) -> tuple[ChainTime, int]:
    """``chained_time`` at ``batch``, retried at half the batch and at 1
    when the card runs out of memory; returns the times and the batch."""
    device = _card(device)
    last = None
    for b in (batch, max(1, batch // 2), 1):
        try:
            return chained_time(step_fn, frames_for(b, height, width,
                                                    device), steps), b
        except RuntimeError as exc:
            if not _is_oom(exc):
                raise
            last = exc
            torch.cuda.empty_cache()
    raise RuntimeError(f"all batch sizes OOMed: {last}")


def bench_oracle_cpu():
    """Reference-path math (LUT+colormatch+sharpen+grain) in torch f32 on
    this host CPU, one 4K frame."""
    import torch
    import torch.nn.functional as F

    from vrgdg_tpu_torch.core.cube import build_palette_lut

    def rgb_to_lab(rgb):
        lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                          rgb / 12.92)
        m = torch.tensor([[0.412453, 0.357580, 0.180423],
                          [0.212671, 0.715160, 0.072169],
                          [0.019334, 0.119193, 0.950227]])
        xyz = lin @ m.T
        t = xyz / torch.tensor([0.95047, 1.0, 1.08883])
        ft = torch.where(t > 0.008856, t.clamp(min=0) ** (1 / 3),
                         7.787 * t + 4 / 29)
        return torch.stack([116 * ft[..., 1] - 16,
                            500 * (ft[..., 0] - ft[..., 1]),
                            200 * (ft[..., 1] - ft[..., 2])], -1)

    def lab_to_rgb(lab):
        fy = (lab[..., 0] + 16) / 116
        fx = lab[..., 1] / 500 + fy
        fz = (fy - lab[..., 2] / 200).clamp(min=0)
        ft = torch.stack([fx, fy, fz], -1)
        t = torch.where(ft > 0.2068966, ft ** 3, (ft - 4 / 29) / 7.787)
        xyz = t * torch.tensor([0.95047, 1.0, 1.08883])
        m = torch.tensor(
            [[3.2404813432005266, -1.5371515162713185, -0.4985363261688878],
             [-0.9692549499965682, 1.8759900014898907, 0.0415559265582928],
             [0.0556466391351772, -0.2040413383665112, 1.0573110696453443]])
        lin = (xyz @ m.T).clamp(min=0)
        return torch.where(lin > 0.0031308,
                           1.055 * lin ** (1 / 2.4) - 0.055,
                           12.92 * lin).clamp(0, 1)

    lut = torch.from_numpy(build_palette_lut(
        "#0b1d51, #1f6aa5, #f3d27a", 33).table)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 2160, 3840, 3))
                           .astype(np.float32))
    ref = torch.from_numpy(rng.uniform(0, 1, (1, 256, 256, 3))
                           .astype(np.float32))
    start = time.perf_counter()
    with torch.inference_mode():
        coords = img.clamp(0, 1) * (lut.shape[0] - 1)
        lo = coords.floor().long()
        hi = (lo + 1).clamp(max=lut.shape[0] - 1)
        f = coords - lo.float()
        r0, g0, b0 = lo[..., 0], lo[..., 1], lo[..., 2]
        r1, g1, b1 = hi[..., 0], hi[..., 1], hi[..., 2]
        fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
        c00 = lut[b0, g0, r0] * (1 - fb) + lut[b1, g0, r0] * fb
        c01 = lut[b0, g1, r0] * (1 - fb) + lut[b1, g1, r0] * fb
        c10 = lut[b0, g0, r1] * (1 - fb) + lut[b1, g0, r1] * fb
        c11 = lut[b0, g1, r1] * (1 - fb) + lut[b1, g1, r1] * fb
        graded = ((c00 * (1 - fg) + c01 * fg) * (1 - fr)
                  + (c10 * (1 - fg) + c11 * fg) * fr).clamp(0, 1)
        out = img * 0.2 + graded * 0.8
        il, rl = rgb_to_lab(out), rgb_to_lab(ref)
        matched = ((il - il.mean(dim=(1, 2), keepdim=True))
                   / (il.std(dim=(1, 2), keepdim=True) + 1e-5)
                   * (rl.std(dim=(1, 2), keepdim=True) + 1e-5)
                   + rl.mean(dim=(1, 2), keepdim=True))
        out = lab_to_rgb(0.7 * matched + 0.3 * il)
        x = out.permute(0, 3, 1, 2)
        blur = F.avg_pool2d(x, kernel_size=3, stride=1, padding=1)
        x = (x + 1.5 * (x - blur)).clamp(0, 1)
        grain = torch.randn_like(x)
        grain[:, 0] *= 2.0
        grain[:, 2] *= 3.0
        gray = grain[:, 1:2].repeat(1, 3, 1, 1)
        grain = 0.5 * grain + 0.5 * gray
        out = (x + grain * 0.05).clamp(0, 1)
        _ = out.permute(0, 2, 3, 1).numpy()
    return 1.0 / (time.perf_counter() - start)


def _launch_counts() -> dict:
    return {name: count for name, count in build.LAUNCHES.items() if count}


def _result(timing: ChainTime, batch: int, mode: str, launches: dict) -> dict:
    return {
        "fps": batch / timing.wall_s,
        "batch": batch,
        "mode": mode,
        "wall_ms_per_frame": timing.wall_s * 1e3 / batch,
        "device_ms_per_frame": timing.device_ms / batch,
        "device_ms_per_frame_min": timing.device_ms_min / batch,
        "device_ms_per_frame_max": timing.device_ms_max / batch,
        "launches": launches,
    }


def _check_launches(label: str, launches: dict, kernels) -> None:
    for kernel in kernels:
        if not launches.get(kernel):
            raise RuntimeError(f"{label} launched no {kernel}: {launches}")


def _run_config(name, step_fn, config, batch, height, width, device,
                steps) -> dict:
    build.reset_launch_counts()
    timing, used = measure(step_fn, batch, height, width, device, steps)
    launches = _launch_counts()
    _check_launches(name, launches, expected_kernels(config))
    return _result(timing, used, run_mode(config), launches)


def _enhance(device, steps: int) -> dict:
    """The enhancer's device step (lanczos4 1080p -> 4K, unsharp, the
    ``film_grain`` kernel) at batch 1, frame start ``k``; the carry feeds
    the next step's input by 1e-12 of one value, as in ``bench.py``."""
    settings = EnhancerSettings.normalize(ENHANCE)
    frames = frames_for(1, 1080, 1920, device)

    def step(carry, k):
        return _enhance_step(frames + carry[0, 0, 0, 0] * 1e-12, settings,
                             2160, 3840, k)

    build.reset_launch_counts()
    timing = chained_time(step, torch.zeros((1, 2160, 3840, 3),
                                            device=device), steps)
    launches = _launch_counts()
    _check_launches("enhance_step_1080p_to_4k", launches, ("film_grain",))
    return _result(timing, 1, "eager (lanczos4, unsharp, film_grain kernel)",
                   launches)


def _say(name: str, result: dict) -> None:
    log(f"[bench] {name}: {result['fps']:.2f} fps (batch {result['batch']}) "
        f"device {result['device_ms_per_frame']:.4f} ms/frame "
        f"mode={result['mode']} launches={result['launches']}")


def run(device="cuda", steps: int = TIMED_STEPS, oracle: bool = True) -> dict:
    """Every measurement of :func:`main` on ``device``, ``steps`` per
    chain; the host-CPU oracle only when ``oracle``.  Returns the JSON
    object :func:`main` prints."""
    device = _card(device)
    kind = torch.cuda.get_device_name(device)
    card = card_line()
    rtt_ms = call_overhead(device)
    probes = hardware_probes(device)
    log(f"[bench] device={kind!r} nvidia_smi={card!r} "
        f"call_overhead={rtt_ms:.4f} ms "
        f"elementwise_bw={probes['elementwise_gbps']:.1f} GB/s "
        f"gather_rate={probes['gather_grows_per_s']:.4f} G-rows/s "
        f"copy_4k_x2={probes['copy_4k_x2_ms']:.4f} ms")

    stack, _ = build_stack(device)
    configs = stack_configs()
    detail = {}
    for name, key, batch, height, width in CONFIGS:
        detail[name] = _run_config(name, stack[key], configs[key], batch,
                                   height, width, device, steps)
        _say(name, detail[name])

    stage_ms, stage_device_ms = {}, {}
    for key in STAGES:
        timing, used = measure(stack[key], *HEADLINE_SHAPE, device, steps)
        stage_ms[key] = timing.wall_s * 1e3 / used
        stage_device_ms[key] = timing.device_ms / used
        log(f"[bench] stage {key}: {stage_ms[key]:.4f} ms/frame @4K "
            f"(device {stage_device_ms[key]:.4f})")

    detail["enhance_step_1080p_to_4k"] = _enhance(device, steps)
    _say("enhance_step_1080p_to_4k", detail["enhance_step_1080p_to_4k"])

    oracle_fps = bench_oracle_cpu() if oracle else None
    # headline = the faster implementation of the full stack
    fused = detail["fused_4k"]["fps"]
    headline_mode = detail["fused_4k"]["mode"]
    if detail["fused_4k_pallas2"]["fps"] > fused:
        fused = detail["fused_4k_pallas2"]["fps"]
        headline_mode = detail["fused_4k_pallas2"]["mode"]
    log(f"[bench] oracle_cpu="
        f"{'not run' if oracle_fps is None else f'{oracle_fps:.3f} fps'}")
    return {
        "metric": "4K frames/sec on one card, fused "
                  "grain+LUT+colormatch+sharpen",
        "value": fused,
        "unit": "frames/sec",
        "vs_baseline": None if oracle_fps is None else fused / oracle_fps,
        "baseline": "torch-f32 reference math on host CPU, 1 thread-pool",
        "oracle_cpu_fps": oracle_fps,
        "backend": "cuda",
        "device": {"name": kind, "nvidia_smi": card},
        "call_overhead_ms": rtt_ms,
        "timed_steps": steps,
        "elementwise_gbps": probes["elementwise_gbps"],
        "gather_grows_per_s": probes["gather_grows_per_s"],
        "copy_4k_x2_ms": probes["copy_4k_x2_ms"],
        "copy_4k_x2_gbps": probes["copy_4k_x2_gbps"],
        "configs": detail,
        "stage_ms_per_4k_frame": stage_ms,
        "stage_device_ms_per_4k_frame": stage_device_ms,
        "lut_mode": "bundle (exact trilinear, one row-gather/pixel)",
        "headline_mode": headline_mode,
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("[bench] no CUDA device (torch.cuda.is_available() is False); "
            "the bench times a card and has no CPU fallback.")
        return 1
    print(json.dumps(run("cuda", TIMED_STEPS, True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
