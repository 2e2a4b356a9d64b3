"""Self-check of the multi-process mesh, with no JAX: run once per rank.

    python -m vrgdg_tpu_torch.parallel 127.0.0.1:29500 2 0 --device cpu &
    python -m vrgdg_tpu_torch.parallel 127.0.0.1:29500 2 1 --device cpu

Each rank joins the ``torch.distributed`` group
(:func:`~vrgdg_tpu_torch.parallel.distributed.initialize_distributed`:
gloo on the CPU, NCCL on a card), grades a seeded (8, 12, 16, 3) clip
frame-sharded over a global mesh of two devices a rank, and checks that
the all-gathered clip equals a one-device grade bit for bit.  It prints
``rank<r> GRADE OK ...`` and exits 0, or exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.params import GrainParams, SharpenParams
from ..ops.grade import GradeConfig, grade
from .distributed import initialize_distributed, shutdown_distributed
from .mesh import grade_on_mesh, make_mesh


def _self_check(argv=None) -> int:
    """Grade a seeded (8, 12, 16, 3) clip frame-sharded over a global mesh
    of two devices a rank and check the all-gathered result against a
    one-device grade, bit for bit."""
    parser = argparse.ArgumentParser(
        prog="python -m vrgdg_tpu_torch.parallel")
    parser.add_argument("coordinator", help="host:port of rank 0")
    parser.add_argument("num_processes", type=int)
    parser.add_argument("process_id", type=int)
    parser.add_argument("--device", default=None,
                        help="each rank's device (default: its card for "
                             "NCCL, else cpu for gloo)")
    args = parser.parse_args(argv)
    summary = initialize_distributed(args.coordinator, args.num_processes,
                                     args.process_id)
    rank = summary["process_index"]
    try:
        device = torch.device(args.device) if args.device else (
            torch.device("cuda", torch.cuda.current_device())
            if summary["backend"] == "nccl" else torch.device("cpu"))
        mesh = make_mesh(devices=[device] * 2)
        config = GradeConfig(sharpen=SharpenParams.normalize(2.0),
                             grain=GrainParams.normalize(0.08, 0.5, seed=21))
        full = torch.from_numpy(np.random.default_rng(0).uniform(
            0.0, 1.0, (8, 12, 16, 3)).astype(np.float32))
        gathered = grade_on_mesh(full, config, mesh)
        reference = grade(full.to(device), config)
        if not torch.equal(gathered.cpu(), reference.cpu()):
            print(f"rank{rank} GRADE MISMATCH", flush=True)
            return 1
        print(f"rank{rank} GRADE OK shape={tuple(gathered.shape)} "
              f"backend={summary['backend']} "
              f"data_axis={mesh.shape['data']}", flush=True)
        return 0
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    sys.exit(_self_check())
