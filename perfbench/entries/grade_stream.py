"""Entry: grade clips as ``vrgdg_tpu_torch``'s ``grade_video`` does, with
the codec left out.

For each clip, the colour-match reference image goes up as float32 and
``lab_statistics`` takes its statistics; ``grade_config`` and
``grade_effect`` resolve the stack's operands on the device; then
``stream_graded_batches`` runs the clip's uint8 host batches (the last one
padded by the program) and yields uint8 frames, which go to the sink.
"""

from __future__ import annotations

import os
import time

import torch
from torch.autograd.profiler import record_function


class Entry:
    def __init__(self, config: dict, mix: dict, inputs, device, generator,
                 root: str):
        from vrgdg_tpu_torch.core.cube import GLOBAL_LUT_CACHE

        self.stack = dict(config["stack"])
        self.device = torch.device(device)
        self.inputs, self.generator = inputs, generator
        self.depth = int(config["dispatch_depth"])
        self.batch = int(config["batch_size"][f"{mix['width']}x{mix['height']}"])
        self.frame_out = (int(mix["height"]), int(mix["width"]))
        self.lut = GLOBAL_LUT_CACHE.load(os.path.join(root, self.stack["lut"]))

    def warm_lengths(self) -> list:
        """Two clips of two full batches and a padded one."""
        return [2 * self.batch + 1] * 2

    def run_clip(self, clip, sink, sync_setup: bool = False) -> dict:
        """Grade ``clip`` into ``sink``; returns ``setup_ms`` (the
        operands, ended by a synchronise when ``sync_setup``),
        ``device_ms`` (the program's CUDA events), ``frames`` and
        ``batches``."""
        from vrgdg_tpu_torch.api.appliers import (grade_config, grade_effect,
                                                  stream_graded_batches)
        from vrgdg_tpu_torch.ops.color_match import lab_statistics

        s = self.stack
        started = time.perf_counter()
        with record_function("perfbench.clip_setup"):
            reference = torch.from_numpy(
                self.inputs.references[clip.reference]).to(self.device)
            ref_stats = lab_statistics(reference)
            config = grade_config(
                lut=self.lut, lut_strength=s["lut_strength"],
                adjust=s.get("adjust"), ref_stats=ref_stats,
                match_strength=s["match_strength"],
                sharpen_strength=s["sharpen_strength"],
                sharpen_kind=s["sharpen_kind"],
                sharpen_border=s["sharpen_border"],
                grain_intensity=s["grain_intensity"],
                saturation_mix=s["saturation_mix"], seed=s["seed"],
                fused_mode=s["fused_mode"])
            effect = grade_effect(config, self.device, lut=self.lut,
                                  ref_stats=ref_stats)
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
