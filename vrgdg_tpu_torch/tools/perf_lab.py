"""LUT-stage, fused-stack and layout A/B lab on one CUDA card.

Counterpart of ``tools/perf_lab.py``.  Each lever is one name; ``all``
runs every one of them in one process:

    python3 -m vrgdg_tpu_torch.tools.perf_lab baseline24     # row gather from (N^3, 24)
    python3 -m vrgdg_tpu_torch.tools.perf_lab padded32       # 24 -> 32 float32 pad
    python3 -m vrgdg_tpu_torch.tools.perf_lab transposed24   # column gather from (24, N^3): lands (24, B, P)
    python3 -m vrgdg_tpu_torch.tools.perf_lab transposed32   # same with a 32-row padded table
    python3 -m vrgdg_tpu_torch.tools.perf_lab baseline24_b4  # batch 4 (also padded32_b4, baseline24_b1)
    python3 -m vrgdg_tpu_torch.tools.perf_lab split24        # one gather per frame
    python3 -m vrgdg_tpu_torch.tools.perf_lab fused          # eager vs fused stack, 4K x 2 (fused_1080p: 1080p x 8)
    python3 -m vrgdg_tpu_torch.tools.perf_lab rowmajor       # layout plane vs rowmajor, 4K x 2 (rowmajor_1080p)
    python3 -m vrgdg_tpu_torch.tools.perf_lab flat           # layout rowmajor vs flat, 4K x 2 (flat_1080p)
    python3 -m vrgdg_tpu_torch.tools.perf_lab all

A LUT variant is the corner-bundle LUT stage in torch ops (trilerp and
strength blend included, the lerps as :func:`vrgdg_tpu_torch.ops.lut._lerp`
rounds them): first its parity against :func:`~vrgdg_tpu_torch.ops.lut.apply_lut`
on a seeded (1, 64, 96, 3) batch (< 1e-6, the JAX lab's gate), then ms
per frame at 4K over 64 dependent steps by CUDA events
(:func:`vrgdg_tpu_torch.bench.chained_time`).  ``fused`` times the eager
stack against the two fused kernels (``grade_phase1`` + ``grade_phase2``);
the layout A/Bs time :func:`vrgdg_tpu_torch.kernels.grade_cuda.fused_post_gather`
per layout (``plane`` runs ``grade_phase1_planes`` and
``grade_phase2_planes``, ``rowmajor`` ``grade_phase1`` and
``grade_phase2_planes``, ``flat`` ``grade_phase1`` and ``grade_phase2``).
Every line names the card (``nvidia-smi`` name and power limit) and the
kernels each run launched.  Without a card the lab exits 1.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from .. import bench
from ..core.cube import build_palette_lut, corner_bundle
from ..core.params import (ColorMatchParams, GrainParams, LUTParams,
                           SharpenParams)
from ..kernels import build
from ..kernels.grade_cuda import fused_post_gather
from ..ops.grade import GradeConfig
from ..ops.lut import _lerp, apply_lut

STEPS = 64
PARITY_SHAPE = (1, 64, 96, 3)
PARITY_BOUND = 1e-6
VARIANTS = ("baseline24", "padded32", "transposed24", "transposed32",
            "baseline24_b4", "padded32_b4", "baseline24_b1", "split24")
SHAPE_4K = (2, 2160, 3840, 3)
SHAPE_1080P = (8, 1080, 1920, 3)


def build_variant(name, device):
    """The LUT stage of variant ``name`` on ``device`` (a function of a
    BHWC batch), and its palette LUT."""
    lut = build_palette_lut(bench.PALETTE, bench.LUT_SIZE)
    bundle_np = corner_bundle(lut.table)            # (N^3, 24)
    size = lut.table.shape[0]
    max_index = size - 1

    width = 24
    transposed = name.startswith("transposed")
    if name.startswith("padded32") or name == "transposed32":
        width = 32
        bundle_np = np.pad(bundle_np, ((0, 0), (0, 8)))
    if transposed:
        table = torch.from_numpy(np.ascontiguousarray(bundle_np.T)).to(
            device)                                 # (w, N^3)
    else:
        table = torch.from_numpy(bundle_np).to(device)  # (N^3, w)
    blend = torch.tensor(0.8, dtype=torch.float32, device=device)

    def gather(cell):
        """(P,) cells -> (w, P) corner values."""
        if transposed:
            return torch.index_select(table, 1, cell)   # lands (w, P)
        return torch.index_select(table, 0, cell).t()   # (P, w), read (w, P)

    def lut_stage(frames):
        src = frames[..., :3]
        batch, h, w, _ = src.shape
        pixels = h * w
        pm = src.reshape(batch, pixels, 3).permute(2, 0, 1)   # (3, B, P)
        coords = torch.clamp(pm, 0.0, 1.0) * max_index
        lo = torch.floor(coords)
        frac = coords - lo
        lo = lo.to(torch.int64)
        cell = (lo[2] * size + lo[1]) * size + lo[0]          # (B, P)
        if name.startswith("split"):
            # one gather per frame
            g = torch.stack([gather(cell[b]) for b in range(batch)], dim=1)
        else:
            g = gather(cell.reshape(-1)).reshape(width, batch, pixels)
        fr, fg, fb = frac[0], frac[1], frac[2]
        planes = []
        for c in range(3):
            c00 = _lerp(g[0 + c], g[3 + c], fb)
            c01 = _lerp(g[6 + c], g[9 + c], fb)
            c10 = _lerp(g[12 + c], g[15 + c], fb)
            c11 = _lerp(g[18 + c], g[21 + c], fb)
            c0 = _lerp(c00, c01, fg)
            c1 = _lerp(c10, c11, fg)
            graded = torch.clamp(_lerp(c0, c1, fr), 0.0, 1.0)
            planes.append(_lerp(pm[c], graded, blend))
        return torch.stack(planes, dim=-1).reshape(batch, h, w, 3)

    return lut_stage, lut


def parity_batch(device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, PARITY_SHAPE).astype(np.float32)).to(device)


def _parity(name, lut_stage, lut, device) -> float:
    small = parity_batch(device)
    err = float((apply_lut(small, lut, strength=8.0)
                 - lut_stage(small)).abs().max())
    if not err < PARITY_BOUND:
        raise AssertionError(f"[{name}] diverged from apply_lut: max abs "
                             f"err {err} >= {PARITY_BOUND}")
    return err


def parity(name, device) -> float:
    """Max abs error of variant ``name`` against ``apply_lut`` at strength
    8 on :func:`parity_batch`; raises past :data:`PARITY_BOUND`."""
    return _parity(name, *build_variant(name, device), device)


def _launches() -> dict:
    return {name: count for name, count in build.LAUNCHES.items() if count}


def _line(label: str, timing: bench.ChainTime, batch: int, launches: dict,
          card: str) -> dict:
    result = {"ms_per_batch": timing.wall_s * 1e3,
              "ms_per_frame": timing.wall_s * 1e3 / batch,
              "fps": batch / timing.wall_s,
              "device_ms_per_batch": timing.device_ms, "launches": launches}
    print(f"[{label}] batch={batch}: {result['ms_per_batch']:.4f} ms/batch, "
          f"{result['ms_per_frame']:.4f} ms/frame, {result['fps']:.2f} fps, "
          f"device {timing.device_ms:.4f} ms/batch "
          f"(min {timing.device_ms_min:.4f}, max {timing.device_ms_max:.4f}), "
          f"launches={launches} card='{card}'", flush=True)
    return result


def lut_variant(name, device="cuda", steps=STEPS, card="") -> dict:
    """Parity of variant ``name``, then its LUT stage at 4K chained over
    ``steps`` dependent steps."""
    batch = 2
    if name.endswith("_b4"):
        batch = 4
    elif name.endswith("_b1"):
        batch = 1
    lut_stage, lut = build_variant(name, device)
    err = _parity(name, lut_stage, lut, device)
    print(f"[{name}] parity max abs err vs apply_lut: {err:.2e} "
          f"card='{card}'", flush=True)
    frames = bench.frames_for(batch, 2160, 3840, device)
    build.reset_launch_counts()
    timing = bench.chained_time(lambda carry, _: lut_stage(carry), frames,
                                steps)
    result = _line(name, timing, batch, _launches(), card)
    result["parity_err"] = err
    return result


def fused_stack_ab(shape=SHAPE_4K, steps=STEPS, device="cuda", card=""):
    """The full stack (grain + LUT + colour match + sharpen) in the eager
    mode against the fused kernels at ``shape``."""
    _, operands = bench.stack_operands(device)
    frames = bench.frames_for(*shape[:3], device)
    results = {}
    for mode in ("eager", "fused"):
        config = GradeConfig(lut=LUTParams.normalize(8.0),
                             color_match=ColorMatchParams.normalize(0.7),
                             sharpen=SharpenParams.normalize(1.5,
                                                             border="zero"),
                             grain=GrainParams.normalize(0.05, 0.5, seed=42),
                             fused_mode=mode)
        build.reset_launch_counts()
        timing = bench.chained_time(bench.grade_step(config, operands),
                                    frames, steps)
        results[mode] = _line(f"fused {mode} {shape[1]}p", timing, shape[0],
                              _launches(), card)
    return results


def phase1_layout_ab(shape=SHAPE_4K, steps=STEPS,
                     layouts=("plane", "rowmajor"), device="cuda", card=""):
    """The fused kernels' inter-phase layouts at ``shape``:

    - ``plane``: the corner planes gathered by torch indexing, then
      ``grade_phase1_planes`` and ``grade_phase2_planes``;
    - ``rowmajor``: ``grade_phase1`` on BHWC rows, a permute to planes,
      ``grade_phase2_planes``;
    - ``flat``: ``grade_phase1`` -> ``grade_phase2``, all BHWC (the
      fused mode's default).

    Prints each layout's times and the second's speed-up over the first
    by CUDA-event ms."""
    _, (bundle, dmin, dmax, ref_mean, ref_std) = bench.stack_operands(device)
    frames = bench.frames_for(*shape[:3], device)
    kw = dict(blend=0.8, match_strength=0.7, sharpen_strength=1.5,
              grain_intensity=0.05, saturation_mix=0.5)
    results = {}
    for layout in layouts:
        def step(carry, i, _layout=layout):
            return fused_post_gather(carry, bundle, dmin, dmax, ref_mean,
                                     ref_std, 4 * i, layout=_layout, **kw)

        build.reset_launch_counts()
        timing = bench.chained_time(step, frames, steps)
        results[layout] = _line(f"{layout} {shape[1]}p", timing, shape[0],
                                _launches(), card)
    a, b = layouts
    speedup = (results[a]["device_ms_per_batch"]
               / results[b]["device_ms_per_batch"])
    print(f"[{b} {shape[1]}p] speedup vs {a} (device ms): {speedup:.4f}x "
          f"card='{card}'", flush=True)
    return results


AB = {
    "fused": fused_stack_ab,
    "fused_1080p": functools.partial(fused_stack_ab, SHAPE_1080P),
    "rowmajor": phase1_layout_ab,
    "rowmajor_1080p": functools.partial(phase1_layout_ab, SHAPE_1080P),
    "flat": functools.partial(phase1_layout_ab,
                              layouts=("rowmajor", "flat")),
    "flat_1080p": functools.partial(phase1_layout_ab, SHAPE_1080P,
                                    layouts=("rowmajor", "flat")),
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    name = args[0] if args else "baseline24"
    names = [*VARIANTS, *AB] if name == "all" else [name]
    unknown = [n for n in names if n not in VARIANTS and n not in AB]
    if unknown:
        print(f"perf_lab: unknown name {unknown[0]!r}; expected one of "
              f"{', '.join([*VARIANTS, *AB, 'all'])}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perf_lab: no CUDA device (torch.cuda.is_available() is "
              "False); the lab times a card.", file=sys.stderr)
        return 1
    card = bench.card_line()
    for one in names:
        if one in AB:
            AB[one](device="cuda", card=card)
        else:
            lut_variant(one, "cuda", card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
