"""Entry: apply a LUT to clips as ``vrgdg_tpu_torch``'s
``apply_lut_to_video`` does, with the codec left out.

For each clip the effect comes from the applier's own builder,
``api.appliers._lut_effect`` (the cached ``.cube``, then ``grade_effect``
of a LUT-only ``GradeConfig``: the eager chain with the corner-bundle
LUT); then ``stream_graded_batches`` runs the clip's uint8 host batches at
the configuration's batch size and dispatch depth and yields uint8 frames,
which go to the sink.  Apply LUT has no colour match, so a clip's
reference image is not used.
"""

from __future__ import annotations

import os
import time

import torch
from torch.autograd.profiler import record_function


class Entry:
    def __init__(self, config: dict, mix: dict, inputs, device, generator,
                 root: str):
        stack = config["stack"]
        path = os.path.join(root, stack["lut"])
        self.lut_name = os.path.basename(path)
        self.luts_dir = os.path.dirname(path)
        self.strength = float(stack["lut_strength"])
        self.device = torch.device(device)
        self.inputs, self.generator = inputs, generator
        self.depth = int(config["dispatch_depth"])
        self.batch = int(config["batch_size"])
        self.frame_out = (int(mix["height"]), int(mix["width"]))

    def warm_lengths(self) -> list:
        """Two clips of two full batches and a short one."""
        return [2 * self.batch + 1] * 2

    def run_clip(self, clip, sink, sync_setup: bool = False) -> dict:
        """Apply the LUT to ``clip`` into ``sink``; returns ``setup_ms``
        (the effect's build, ended by a synchronise when ``sync_setup``),
        ``device_ms`` (the program's CUDA events), ``frames`` and
        ``batches``."""
        from vrgdg_tpu_torch.api.appliers import (_lut_effect,
                                                  stream_graded_batches)

        started = time.perf_counter()
        with record_function("perfbench.clip_setup"):
            effect, _ = _lut_effect(self.lut_name, self.strength,
                                    self.luts_dir, self.device)
            if sync_setup and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        setup_ms = (time.perf_counter() - started) * 1e3
        stats: dict = {}
        stream = iter(stream_graded_batches(
            self.generator.batches(self.inputs, clip, self.batch), effect,
            batch_size=self.batch, device=self.device,
            dispatch_depth=self.depth, stats=stats))
        while True:
            with record_function("perfbench.next_batch"):
                out = next(stream, None)
            if out is None:
                break
            with record_function("perfbench.sink"):
                sink(out)
        return {"setup_ms": setup_ms, "device_ms": stats.get("device_ms"),
                "frames": stats["frames"], "batches": stats["batches"]}
