#!/usr/bin/env python3
"""Paired timing of the fused grade on one card: two checkouts in turns.

    python3 paired_grade.py <checkout A> <checkout B> [--rounds N]

Each round runs A, B, B, A, each turn in a fresh process whose
``vrgdg_tpu_torch`` (kernels built from that checkout's sources) comes
from the checkout, while the frames, the stack, the timers and the main
path come from the ``chip_smoke.py`` beside this script, so both sides
are driven by the same code.  A turn prints, as one ``KERNELS`` JSON line,
the package it ran and the CUDA-event ms (20 launches after a warm-up) at
4K x 2 and 1080p x 8 of ``grade_phase1`` on the smoke's seeded uniform
frames and on its smooth frame (a gradient plus +-2 levels of noise), of
``grade_phase2`` on phase 1's LAB, of ``grade_phase2_planes`` on the same
LAB permuted to channel planes, and of ``fused_post_gather`` with
``layout="rowmajor"`` (phase 1, a permute, ``grade_phase2_planes``; grain
on, no adjust), and of a ``copy_`` of the 4K x 2 batch; then the smoke's
fused main path (48 frames of 4K at batch 2, 100 of 1080p at batch 8)
with its fps, device ms per frame and the device-time breakdown of one
profiled pass.  Compare two versions only within one call
of this script.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((2, 2160, 3840), (8, 1080, 1920))
REPS = 20


def _smoke():
    """This tree's ``chip_smoke.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _turn(root: str) -> None:
    """One checkout's turn, in its own process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import vrgdg_tpu_torch
    from vrgdg_tpu_torch.kernels import build
    from vrgdg_tpu_torch.kernels import grade_cuda as gc
    from vrgdg_tpu_torch.ops.grade import _active_adjust, prepare_operands

    cs = _smoke()
    device = torch.device("cuda", 0)
    build.load_libraries()
    card = cs._nvidia_smi()
    config, lut, ref_stats = cs._stack(device)
    table, dmin, dmax, ref_mean, ref_std = prepare_operands(
        config, lut=lut, ref_stats=ref_stats, device=device)
    blend = config.lut.strength / 10.0
    adjust = _active_adjust(config)
    domain = gc.lut_domain(dmin, dmax)
    grain = config.grain
    kw = dict(sharpen_strength=config.sharpen.strength,
              grain_intensity=grain.intensity,
              saturation_mix=grain.saturation_mix, seed_base=grain.seed)
    times = {"checkout": root,
             "package": os.path.dirname(vrgdg_tpu_torch.__file__),
             "card": card}
    for shape in SHAPES:
        label = cs._label(shape)
        frames = cs._frames(shape, 100, device)
        smooth = cs._smooth_frames(shape, 120, device)
        lab, partials = gc.phase1(frames, table, domain, blend=blend,
                                  adjust=adjust)
        coeff = gc.stats_barrier(partials, shape[1] * shape[2], ref_mean,
                                 ref_std, config.color_match.match_strength)
        times[f"grade_phase1_{label}"] = cs._cuda_ms(
            lambda: gc.phase1(frames, table, domain, blend=blend,
                              adjust=adjust), REPS)
        times[f"grade_phase1_smooth_{label}"] = cs._cuda_ms(
            lambda: gc.phase1(smooth, table, domain, blend=blend,
                              adjust=adjust), REPS)
        times[f"grade_phase2_{label}"] = cs._cuda_ms(
            lambda: gc.phase2(lab, coeff, **kw), REPS)
        lab_planes = lab.permute(0, 3, 1, 2).contiguous()
        times[f"grade_phase2_planes_{label}"] = cs._cuda_ms(
            lambda: gc.phase2_planes(lab_planes, coeff, **kw), REPS)
        times[f"layout_rowmajor_{label}"] = cs._cuda_ms(
            lambda: gc.fused_post_gather(
                frames, table, dmin, dmax, ref_mean, ref_std, grain.seed,
                blend=blend, match_strength=config.color_match.match_strength,
                sharpen_strength=config.sharpen.strength,
                grain_intensity=grain.intensity,
                saturation_mix=grain.saturation_mix, layout="rowmajor"),
            REPS)
        if shape == SHAPES[0]:
            copy = torch.empty_like(frames)
            times[f"copy_{label}"] = cs._cuda_ms(
                lambda: copy.copy_(frames), REPS)
        del frames, smooth, lab, lab_planes
        torch.cuda.empty_cache()
    print("KERNELS " + json.dumps(times), flush=True)
    cs.main_path(device, config, lut, ref_stats, card)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.turn:
        _turn(os.path.abspath(args.a))
        return 0
    failed = 0
    for _ in range(args.rounds):
        for label, root in (("A", args.a), ("B", args.b), ("B", args.b),
                            ("A", args.a)):
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__), root, root,
                 "--turn"], capture_output=True, text=True, timeout=900,
                check=False)
            print(f"== {label} {os.path.abspath(root)} rc={done.returncode}",
                  flush=True)
            print(done.stdout, end="", flush=True)
            if done.returncode:
                failed += 1
                print(done.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
