"""Entry: enhance clips as the Standalone Video Enhancer's render does, with
the codec left out.

The settings go through ``EnhancerSettings.normalize``; the output size is
``output_dimensions`` and the device batch ``auto_batch_size`` of it (when
the settings' ``batch_size`` is 0), as ``_render_segment`` picks them;
``enhance_batches`` then runs each clip's uint8 host batches and hands the
uint8 results to the sink.
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function


class Entry:
    def __init__(self, config: dict, mix: dict, inputs, device, generator,
                 root: str):
        from vrgdg_tpu_torch.core.params import (EnhancerSettings,
                                                 auto_batch_size,
                                                 output_dimensions)

        self.settings = EnhancerSettings.normalize(config["settings"])
        self.device = torch.device(device)
        self.inputs, self.generator = inputs, generator
        self.out_w, self.out_h = output_dimensions(
            int(mix["width"]), int(mix["height"]),
            self.settings.upscale_resolution)
        self.batch = (self.settings.batch_size
                      or auto_batch_size(self.out_w, self.out_h))
        self.frame_out = (self.out_h, self.out_w)

    def warm_lengths(self) -> list:
        """Two clips of three device batches."""
        return [3 * self.batch] * 2

    def run_clip(self, clip, sink, sync_setup: bool = False) -> dict:
        from vrgdg_tpu_torch.jobs.enhancer import enhance_batches

        def write(out):
            with record_function("perfbench.sink"):
                sink(out)

        stats: dict = {}
        frames, _ = enhance_batches(
            self.generator.batches(self.inputs, clip, self.batch),
            self.settings, self.out_h, self.out_w, device=self.device,
            batch_size=self.batch, write=write, stats=stats)
        return {"setup_ms": None,
                "device_ms": (stats["device_ms"]
                              if self.device.type == "cuda" else None),
                "frames": frames, "batches": stats["batches"]}
