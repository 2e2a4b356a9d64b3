"""The readings that the limits of a configuration are set from.

``python3 -m perfbench.readings --workload <cell> --seeds <n>... \\
    --control-seeds <n>... --seconds <s>``

For each seed: the cell's inputs, a short window of the program at the
cell's own load, and :func:`perfbench.run.judge` of the frames it kept
against the reference: the program's reading.  For each control seed,
also the control (the reference computed in the precision below the
program's, the configuration's ``control``) on the same kept frames,
judged the same way: the control's reading.  One JSON line a seed, then a
summary: the largest program reading (the lower end of a limit) and the
smallest control reading (the upper end) of each number.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import cells
from .cells import ROOT
from .run import (SAMPLED_CLIPS, Sampler, build_reference, frame_numbers,
                  judge, kept_frames, run_window, set_up)


def read_seed(cell, seed: int, seconds: float, device, control: bool,
              root: str = ROOT) -> dict:
    generator, inputs, entry = set_up(cell, seed, device, root)
    sampler = Sampler(seed, SAMPLED_CLIPS, (*entry.frame_out, 3))
    records, _, _ = run_window(cell, entry, generator, seed, seconds, False,
                               sampler)
    del entry
    gc.collect()
    reference = build_reference(cell, inputs, root, device)
    frames = kept_frames(sampler, reference, generator, inputs)
    line = {"seed": seed, "clips": len(records), "frames": len(frames),
            "program": judge(frames, records)}
    if control:
        lower = build_reference(cell, inputs, root, device, control=True)
        line["control"] = frame_numbers(
            [(lower.frame(clip, index, source), expected)
             for clip, index, source, _, expected in frames])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m perfbench.readings")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=4.0)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench.readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        line = read_seed(cell, seed, args.seconds, device,
                         seed in args.control_seeds)
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "limits": cell.config["limits"]}
    for side, pick in (("program", max), ("control", min)):
        readings = [line[side] for line in lines if side in line]
        if readings:
            summary[side] = {name: pick(r[name] for r in readings)
                             for name in readings[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
