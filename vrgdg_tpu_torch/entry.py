"""Entry points: the flagship grade step on the card, and a multi-device
dry run of every sharded path.

Counterpart of the repository's ``__graft_entry__.py``, with explicit
devices: :func:`dryrun_multichip` takes the devices it shards over (the
visible cards by default; ``[torch.device("cuda:0")] * 4`` runs the shard
arithmetic on one card, ``[torch.device("cpu")] * 4`` on the CPU) instead
of re-executing itself on a virtual platform.

    python -c "from vrgdg_tpu_torch.entry import dryrun_multichip; \\
        import torch; print(dryrun_multichip(4, [torch.device('cpu')] * 4))"
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The segment scheduler's job (the JAX suite's tests/dist_render_worker.py
# SETTINGS): two 5 s segments of a 10 s clip at 12 fps
SCHEDULER_SETTINGS = {
    "upscale_resolution": "original",
    "sharpen_strength": 1.5,
    "grain_enabled": True,
    "grain_intensity": 0.06,
    "seed": 11,
    "segment_seconds": 5,
    "preserve_audio": False,
    "output_name": "dist_out",
}


def _example_inputs(batch=4, height=256, width=256, device="cuda"):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 1, (batch, height, width, 3))
                              .astype(np.float32)).to(device)
    reference = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3))
                                 .astype(np.float32)).to(device)
    return frames, reference


def _flagship_config(fused_mode: str = "eager"):
    from .core.cube import build_palette_lut
    from .core.params import (ColorMatchParams, GrainParams, LUTParams,
                              SharpenParams)
    from .ops.grade import GradeConfig

    config = GradeConfig(
        lut=LUTParams.normalize(8.0),
        color_match=ColorMatchParams.normalize(0.7),
        sharpen=SharpenParams.normalize(1.5, border="zero"),
        grain=GrainParams.normalize(0.05, 0.5, seed=42),
        fused_mode=fused_mode,
    )
    lut = build_palette_lut("#0b1d51, #1f6aa5, #f3d27a", 33)
    return config, lut


def entry(device="cuda"):
    """Return ``(fn, example_args)``: the flagship grade step in its fused
    mode (the two CUDA kernels on a card) and a seeded (4, 256, 256, 3)
    batch on ``device``."""
    from .ops.color_match import lab_statistics
    from .ops.grade import grade
    from .runtime.batch_stream import resolve_device

    device = resolve_device(device)
    config, lut = _flagship_config("fused")
    frames, reference = _example_inputs(device=device)
    ref_stats = lab_statistics(reference)

    def forward(frames):
        return grade(frames, config, lut=lut, ref_stats=ref_stats,
                     frame_start=0)

    return forward, (frames,)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the grade stack's sharded paths over ``n_devices`` devices on
    tiny shapes, each against one device; raises on a mismatch and
    returns the checks' results.

    1. spatial (``space=2`` when ``n_devices`` is even and at least 4),
       with adjust clarity 30 and sharpen 10: halos of 4 and 1 rows and the
       colour-match reduction, within 1e-5;
    2. frame-axis DP, grain on: bit-identical;
    3. the enhancer step on the DP mesh with an odd batch (padding):
       bit-identical;
    4. the fused grade (with adjust contrast and vignette) under DP:
       bit-identical;
    5. the two-process segment scheduler (:func:`_dryrun_segment_scheduler`):
       byte-identical to one process.
    """
    from .core.params import AdjustSettings, EnhancerSettings
    from .jobs.enhancer import apply_effects_batch
    from .ops.color_match import lab_statistics
    from .ops.grade import grade
    from .parallel import grade_on_mesh, make_mesh

    n_devices = int(n_devices)
    spatial = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices, spatial=spatial, devices=devices)
    dp_mesh = make_mesh(n_devices, spatial=1, devices=devices)
    device = mesh.lead
    config, lut = _flagship_config()
    spatial_config = dataclasses.replace(
        config, adjust=AdjustSettings.normalize({"clarity": 30,
                                                 "sharpen": 10}))
    frames, reference = _example_inputs(batch=2 * n_devices,
                                        height=16 * spatial, width=32,
                                        device=device)
    ref_stats = lab_statistics(reference)
    results = {"n_devices": n_devices, "mesh": mesh.shape,
               "device": str(device)}

    out = grade_on_mesh(frames, spatial_config, mesh, lut=lut,
                        ref_stats=ref_stats, spatial=spatial > 1)
    single = grade(frames, spatial_config, lut=lut, ref_stats=ref_stats)
    err = float((out - single).abs().max())
    if out.shape != frames.shape or not err <= 1e-5:
        raise AssertionError(f"spatial grade: shape {tuple(out.shape)}, "
                             f"max abs error {err} > 1e-5")
    results["spatial_max_abs_err"] = err

    out = grade_on_mesh(frames, config, dp_mesh, lut=lut, ref_stats=ref_stats)
    if not torch.equal(out, grade(frames, config, lut=lut,
                                  ref_stats=ref_stats)):
        raise AssertionError("frame-axis DP grade differs from one device")
    results["dp"] = "bit-identical"

    settings = EnhancerSettings.normalize({
        "sharpen_strength": 1.0, "grain_enabled": True,
        "grain_intensity": 0.05, "seed": 7})
    batch = frames[:2 * n_devices - 1].cpu().numpy()   # odd: pads
    sharded = apply_effects_batch(batch, settings, 32, 48, frame_start=0,
                                  mesh=dp_mesh)
    alone = apply_effects_batch(batch, settings, 32, 48, frame_start=0,
                                device=device)
    if sharded.shape != alone.shape or not np.array_equal(sharded, alone):
        raise AssertionError("enhancer step on the mesh differs from one "
                             "device")
    results["enhancer_dp"] = "bit-identical"

    fused_config = dataclasses.replace(
        config, fused_mode="fused",
        adjust=AdjustSettings.normalize({"contrast": 12, "vignette": 20}))
    out = grade_on_mesh(frames, fused_config, dp_mesh, lut=lut,
                        ref_stats=ref_stats)
    if not torch.equal(out, grade(frames, fused_config, lut=lut,
                                  ref_stats=ref_stats)):
        raise AssertionError("fused grade under DP differs from one device")
    results["fused_dp"] = "bit-identical"

    results["scheduler"] = _dryrun_segment_scheduler(device)
    return results


def _write_clip(path: str, frames: int, fps: float, width: int, height: int,
                seed: int) -> str:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (height, width, 3), np.uint8))
    writer.release()
    return path


def run_scheduler_workers(source: str, base: str, device,
                          timeout: float = 300.0) -> dict:
    """Render ``source`` under :data:`SCHEDULER_SETTINGS` with two
    ``enhance --shard-index`` processes of this package's command line,
    started together on ``device``; returns rank 0's final job status."""
    count = 2
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "enhance", source,
         "--settings", json.dumps(SCHEDULER_SETTINGS),
         "--shard-index", str(rank), "--shard-count", str(count),
         "--job-id", "dist_job",
         "--output-root", base, "--shard-stall-timeout", str(timeout),
         "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env) for rank in range(count)]
    outputs = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"scheduler rank{rank} failed:\n"
                                   f"{err[-2000:]}")
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return json.loads(outputs[0])


def _dryrun_segment_scheduler(device) -> str:
    """Two ``enhance --shard-index`` processes render segments ``i::2``
    of a seeded 120-frame 48x32 clip at 12 fps into one job folder; rank
    0's output must equal an in-process :func:`render_job`'s byte for
    byte."""
    from .jobs import enhancer

    with tempfile.TemporaryDirectory(prefix="vrgdg_dryrun_") as tmp:
        source = _write_clip(os.path.join(tmp, "clip.mp4"), 120, 12.0, 48,
                             32, 3)
        final = run_scheduler_workers(source, os.path.join(tmp, "dist"),
                                      device)
        registry = enhancer.JobRegistry()
        enhancer.render_job(
            "single_job", {"source_path": source,
                           "settings": dict(SCHEDULER_SETTINGS)},
            registry=registry, base_folder=os.path.join(tmp, "single"),
            device=device)
        snap = registry.snapshot("single_job")
        if snap.get("status") != "complete":
            raise AssertionError(f"render_job: {snap.get('error')}")
        with open(final["output_path"], "rb") as handle:
            sharded = handle.read()
        with open(snap["output_path"], "rb") as handle:
            alone = handle.read()
        if sharded != alone:
            raise AssertionError("scheduler output differs from a "
                                 "one-process render")
    return "byte-identical"
