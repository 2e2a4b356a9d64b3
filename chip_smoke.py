#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vrgdg_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):

1. device: the card's name, its ``nvidia-smi`` name and power limit;
2. build: the five kernel libraries (``enhance``, ``grade``, ``grain``,
   ``lut``, ``probe``)
   compiled from ``kernels/csrc`` with nvcc, all started together, and
   beside them probes of each kernel's per-pixel code, whose
   floating-point ``cuobjdump -sass`` instructions price the operations
   term of each kernel's bound;
3. kernel vs plain: the fused kernels against their plain PyTorch versions
   on the card, on the flagship stack (LUT ``LUTS/teal_orange.cube`` at 8,
   adjust contrast 12 / vignette 20, colour match 0.7, unsharp 1.5 zero
   border, grain 0.05 / 0.5 / seed 42) at 1080p x 8, 4K x 2 and
   1 x 1079 x 1917, grain off and on, with the max abs errors beside their
   bounds and the CUDA-event times of kernel and plain version; phase 1
   also timed on a smooth frame (a gradient plus light noise), whose
   neighbouring pixels share LUT cells, and a ``copy_`` of the same 24
   bytes a pixel as the measured copy floor;
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
   shapes, and ``grade_phase2_planes`` bit for bit against
   ``grade_phase2`` on the same LAB, permuted, grain off and on; then
   ``fused_post_gather`` with ``layout="rowmajor"`` and ``"plane"``
   against ``"flat"`` at 4K x 2, grain off and on, with each layout's
   CUDA-event time and peak memory;
9. probe: ``python -m vrgdg_tpu_torch.tools.probe_transpose``'s run, and
   ``weighted_row_sum`` against its plain version at (4096, 24) and at
   4K x 2's pixel count;
10. file: ``grade_video`` on a generated file (cv2 is required);
11. resample: lanczos4 ``resample`` 1080p -> 2160x3840 on the card
    against the CPU (<= 1e-5) and cv2 (<= 1e-3), bit-identical with TF32
    turned on, its ms per frame beside the tap-gather form's;
12. enhance path: 48 seeded 1080p uint8 frames through the enhancer's
    submit/force loop to 4K (lanczos4, unsharp 1.0, grain 0.05, seed 42,
    auto batch 1), with ``enhance_step``'s launches (one per batch), fps,
    device ms per frame and the breakdown; a batch split is bit-identical
    and a small clip is checked against the CPU path;
13. enhancer job: ``render_job`` on a generated 72-frame 1080p clip at
    12 fps to 4K in two segments, with its stage seconds and concat
    backend; a cancel -> resume on a small clip decodes byte for byte as
    an uninterrupted run;
14. images and compare (cv2 is required): ``render_compare`` on 4K x 8
    batches on the card, all five modes, against the same function on the
    CPU (side_by_side, slider, blink exact; overlay, difference <= 1e-6;
    B at 1080p letterboxed onto 4K <= 1e-5), with CUDA-event ms per mode;
    the three image appliers on a 4K PNG (timed, run twice, byte-identical
    outputs) and at 1080p on the card and the CPU (one level on <= 0.1% of
    values); the three previews of the 4K PNG and of a 1080p clip, and
    ``delete_preview`` once; ``compare_images`` in each mode;
    ``compare_videos`` side_by_side and blink on two 48-frame 1080p clips
    (frame count, size, blink period), with processed fps and the
    decode / device / encode split.  No TPU kernel lies on this path: its
    run must launch none of the six ports of one, and ``lut_apply`` (the
    LUT appliers' kernel) at least once;
15. face repair and the secondary ops (cv2 with ``FaceDetectorYN`` is
    required): on a seeded 36-frame 1080p clip at 24 fps of the cartoon
    face of tests/test_face_detector.py (at 0.6x its 480p size) panning
    over noise, the Face Fix job with the real YuNet detector (prepare,
    enhanced anchors and 8n+1-trimmed LTX frames from a seeded affine
    tweak of the crops, finalize on the card and on the CPU: composited
    PNGs one level apart on <= 0.1% of values), with its prepare /
    composite / encode seconds, the composite's ms a frame by CUDA events
    and the host cost of a miss of the weight-matrix cache; ``run_face_fix_pipeline`` on the 36-frame batch
    (wall time and breakdown; crops <= 2e-5 and composite <= 1e-4 against
    the CPU); the ``face-repair`` command's four actions with a manual box
    and with YuNet (composite card vs CPU, rebuilt frame count exact); a
    512 crop pasted into a 4K frame (<= 2e-5); ``first_last_blend``,
    ``batch_reference_images``, ``build_msr_reference`` and
    ``switch_dynamic`` at 1080p and ``merge_lora`` at rank 16 into a 4096
    x 4096 weight against the CPU.  No TPU kernel lies on these paths: the
    run must launch none of the six;
16. parallel, on mesh entries that all name the card (the shard
    arithmetic; NCCL across cards and a multi-card speed-up cannot be
    shown on one card): ``grade_on_mesh`` in fused mode at 4K x 3 on
    ``[cuda:0] * 2`` (pads to 4, trims to 3) bit-identical to one device,
    grain on, with one ``grade_phase1`` and one ``grade_phase2`` launch a
    shard and its CUDA-event ms beside one device's; the eager flagship
    stack plus clarity 30 and sharpen 10 at 1080p x 2 height-sharded
    (``data=1, space=2``, <= 1e-5) and frame-sharded (bit-identical); the
    enhance step 1080p -> 4K on 3 frames frame-sharded (bit-identical, one
    ``film_grain`` launch a shard) and height-sharded (<= 1e-5), and a
    height shard's ``film_grain`` against the whole frame's rows (bit for
    bit); a one-rank NCCL group in a process of its own
    (``python -m vrgdg_tpu_torch.parallel``: a global mesh and
    ``grade_on_mesh`` through the all-gather, bit-identical); two
    ``enhance --shard-index`` processes sharing the card on a seeded
    120-frame 1080p clip at 12 fps, byte-identical to an in-process
    ``render_job``, with both wall times; and
    ``vrgdg_tpu_torch.entry.dryrun_multichip(4, [cuda:0] * 4)``;
17. the server on the card (``vrgdg_tpu_torch.server`` in this process on
    127.0.0.1, driven by real socket requests, one ``[server]`` line each
    with its wall ms): health names the card, 18 LUTs, the panel; the
    fused ``grade_video`` (``fused_mode: "pallas"``, the flagship stack
    with a seeded reference image) on a 48-frame 1080p clip at batch 8,
    six launches of each grade kernel and decoded byte for byte as the
    in-process applier, the ``"xla"`` name launching neither but
    ``lut_apply`` once a batch; the LUT
    route on a 4K PNG, byte for byte as in process; the enhancer's upload,
    load, preview (one ``film_grain`` launch) and a 1080p -> 4K render of
    24 frames (one ``enhance_step`` launch a batch) against an in-process ``start_render``,
    the media route and an unknown job's 404; a second render with the
    fused grade sent from another request thread while it runs, both
    outputs as their lone runs; ``compare/video`` side_by_side and
    ``compare/grid``; ``face_fix/estimate_anchors``; beats, scene SRT,
    peaks and silent audio on a click track; a cross-origin POST refused;
    and ``python -m vrgdg_tpu_torch.cli serve`` in a process of its own
    answering ``/vrgdg/health`` with the card's name.  Any reply other
    than ``ok: true`` fails it, except the refusals it asks for;
18. the host-only stores by request (the same in-process server with the
    card as its device, the stores' clocks held at one instant so
    time-stamped names agree): the music video builder project store, its
    instruction store, the text and audio libraries, storyboard, video
    editor and LoRA dataset on a 12-scene timeline over a seeded 60 s
    stereo 44.1 kHz WAV, 1080p images as data URLs and a seeded 24-frame
    1080p mp4v clip: new project, session, scene image and reference,
    scene audio, the 60 s timeline mix, a trim, the analysis, the final
    frame (cv2's seek, equal to the clip's last decoded frame: the card's
    machine has no ffmpeg), the scan and restore of scene videos, the
    audio route, the instruction store, the streamed ZIP export and the
    multipart import, text files, an audio upload, the popup, storyboard,
    the editor's remake queue drained, the LoRA pairs and a refused
    delete.  Each answer must equal the in-process call on a twin root,
    and the two roots must end as equal file trees (names and bytes, the
    roots' paths blanked, file times left out); then the ``builder`` and
    ``humo`` commands' actions.  None of the six kernels may launch, and
    the phase must end within 60 s;
19. the workflow runner, scene render, prompt creator, start storyboard
    and Krea2 LoRA Studio by request on the same server, each answer
    equal to the in-process call on a twin root (the modules' clocks
    frozen, ``random`` seeded alike, MiniMax H3's output root switched to
    the side's root): a seeded fake model root set by the model-root
    POST, the 16 prompt builders with explicit seeds and
    ``clear_memory``, a seed of -1 drawn in [0, 2**64 - 1]; the seven
    scene-render routes and the scene-audio trim with a recording runner
    on ``scene_render``'s ffmpeg seam (1080p frames written by cv2), equal
    command plans and colour-match cubes, then without it a render route
    failing with ``find_ffmpeg_path``'s message where no ffmpeg is
    installed; the prompt creator's multipart import of a seeded 60 s
    stereo 44.1 kHz WAV, outputs, drafts, instructions and the hidden
    Whisper workflow; a start storyboard imported into a 12-scene builder
    project and its image route; Krea2 1080p PNG edit pairs by multipart
    (a pair of two sizes and a file that holds no image, whose problems
    must be exact, then replaced), samples, the XYZ grid and run plans;
    then the ``workflow`` command's ``list`` and a ``build``.  The roots
    must end as equal trees, none of the six kernels may launch, and the
    phase must end within 45 s;
20. lyrics, LLM batches, text pickers and graph plans by request on the
    same server, each answer equal to the in-process call on a twin root:
    a seeded 4-minute song in the ASR word-JSON contract (about 640 words
    in 80 segments, 60 reference lines) through ``lyrics/timestamped`` in
    the five segment modes (one with gaps off too) and ``lyrics/sheet``
    for a 60-scene SRT with a backup transcription; 60 story groups at
    batch size 10 through six plan/save rounds, combine, split (of damaged
    prompt JSON), the two combined-file GETs, a remake edit and the remake
    indexes, and a folder outside the managed root refused; pickers over
    500 lines in each selection mode and ``multi_pick``; the graph's LoRA
    and state plans.  The two-pass plan of eight LoRAs is applied by
    ``ops.lora.apply_lora_plan`` to a 4096 x 4096 weight with rank-16
    pairs on the card, within 1e-5 relative of the same call on the CPU,
    with its CUDA-event ms; the LUT examples tool grades its 18 frames on
    the card (within 1e-5 of the CPU) into a temporary folder; and the
    ``lyrics``, ``llm-batch`` (four actions) and ``graph`` (two) commands
    run in processes of their own beside the rest, each output equal to
    the in-process call.  The roots must end as equal trees, none of the
    six kernels may launch, and the phase must end within 90 s;
21. bench: ``vrgdg_tpu_torch.bench.run`` at 8 steps a chain without the
    host-CPU oracle: the probes, the seven configs, the five 4K stages
    and the enhance step, each with fps > 0, the fused configs launching
    ``grade_phase1`` and ``grade_phase2``, ``fused_4k_pallas_grain`` and
    the enhance step ``film_grain``; the perf lab's eight LUT variants within 1e-6 of
    ``apply_lut`` on the card, and its plane vs rowmajor A/B at 4K x 2
    (2 steps) launching ``grade_phase1_planes`` and
    ``grade_phase2_planes``.  The phase must end within 60 s;
22. adjust sweep: seeded uniform 2 x 64 x 3840 frames (numpy), the
    flagship LUT at 8, colour match 0.7, unsharp 1.5, grain off; each of
    the eleven sliders ``grade_phase1`` fuses alone (temperature, tint,
    exposure, contrast, saturation, highlights, shadows, whites, blacks
    at -100, 37 and 100; vignette and fade at 37 and 100) and all eleven
    from a seeded draw within +-80: ``grade_phase1`` against its plain
    version (LAB <= 5e-4, partials and A/B coefficients by
    tests/test_torch_cuda.py's rules), and the fused stack through
    ``grade_prepared`` against the same stack on the plain versions (RGB
    <= 2e-5), except saturation -100 and contrast -100, whose flat
    channels make colour match ill-conditioned: there only phase 1 is
    judged and the stack's difference is printed.  Then ``film_grain`` at
    saturation_mix 0 and 1, intensity 1.0, and seed 2**31 - 1 from frame
    5 against its plain version, each batch of 2 bit for bit as 1 + 1.
    One line a slider; the phase must end within 30 s;
23. Apply LUT's kernel: ``lut_apply`` (``apply_lut_bundle`` on the card)
    bit for bit against its plain version (``apply_lut_bundle_plain``, the
    torch ops, on the card) with the flagship LUT at 10, at 1080p x 8 and
    4K x 2 on seeded uniform and smooth frames, with the CUDA-event ms of
    both beside the bytes term of its bound and its L2 gather (96 bytes a
    pixel, in GB and at the rate the kernel reached); then Apply LUT's
    stream (``_lut_effect`` through the appliers' generator) on 17 frames
    of 1080p at batch 8, one launch a batch;
24. the enhancer's fused step: ``enhance_step`` against the torch chain
    it replaces (dequantize -> ``_enhance_step`` -> quantize, on the card)
    at the benchmark cell's settings, 720p and 1080p -> 4K x 1, at most
    one level apart on at most 0.1% of values, both timed by CUDA events
    beside the step's least time (perfbench's ``enhance_step_roofline``),
    and its peak device memory (under a float32 4K frame).

Each path (5, 7, 8's layout run, 9's probe run, 12, 14, 15, 16's mesh
runs, 17's grade, enhancer and concurrent requests, 18's, 19's and
20's requests and commands, 21's bench configs and A/B layouts, 22's
stack runs and 23's stream) is
driven with the launch counts set to 0 just before it and
read just after; launches made
to compare a kernel with its plain version are not counted; a kernel's
``launches`` in the record sum every path that launched it.  The last
three lines are the kernels' JSON record (with each kernel's bound at 4K
x 2: the larger of its bytes at 3.35 TB/s and its floating-point
operations, float32 at 67 TFLOP/s, MUFU and conversions at a sixteenth of
that, float64 at 34 TFLOP/s; beside it ``issue_ms``, its probe's SASS
instructions at the card's issue rate; and, for ``weighted_row_sum``, the
time of ``torch.mv``, the one PyTorch call that computes its function;
``lut_apply`` replaces no TPU kernel and is listed with them),
the ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Exits with a non-zero code
and prints no result when no CUDA card is visible or the package is
missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
RESAMPLE = ((1080, 1920), (2160, 3840))              # (H, W) -> (H, W)
# bench.py's enhance_step_1080p_to_4k: lanczos4 to 4K, unsharp 1.0,
# grain 0.05, seed 42
ENHANCE = dict(upscale_resolution="4k", sharpen_strength=1.0,
               grain_enabled=True, grain_intensity=0.05, seed=42)
ENHANCE_RUN = (48, 1080, 1920)                        # frames, H, W
ENHANCE_SIZE = (3840, 2160)                           # output W, H
JOB_CLIP = (72, 12.0, (1920, 1080))                   # frames, fps, W x H
# phase 14: compare renders on 4K x 8 batches (B also at 1080p, which
# letterboxes), still images at 4K (and at 1080p for the CPU check), and
# two 48-frame 1080p clips at 24 fps for compare_videos
COMPARE_BATCH = (8, 2160, 3840)
LETTERBOX_B = (1080, 1920)
STILL_SIZES = ((2160, 3840), (1080, 1920))
COMPARE_CLIP = (48, 24.0, (1920, 1080))
# phase 15: the cartoon face of tests/test_face_detector.py in a 1080p
# frame, panning over a seeded noise background, 36 frames at 24 fps (the
# face path is host-bound: its depth keeps the script under half its time
# limit); a 512 crop pasted into a 4K frame; the secondary ops at 1080p and a
# rank-16 LoRA fold into a 4096 x 4096 weight.  The face is drawn at 0.6x
# the test's 480p size (a 132 x 180 ellipse): YuNet finds none at 1.5x or
# more, and the job targets small faces
FACE_CLIP = (36, 24.0, (1920, 1080))
FACE_SCALE = 0.6
FACE_REPAIR_RANGES = ("0-11,20-31", 24)               # ranges, frames
PASTE_4K = ((2160, 3840), 512, (1600, 800, 2300, 1500))
# phase 16: the fused grade on a mesh at 4K x 3 (pads to 4), the eager
# stack height-sharded at 1080p x 2, the enhance step 1080p -> 4K on 3
# frames, and the segment scheduler on a 10 s 1080p clip at 12 fps
PARALLEL_FUSED = (3, 2160, 3840)
PARALLEL_EAGER = (2, 1080, 1920)
PARALLEL_ENHANCE = (3, 1080, 1920)
SCHEDULER_CLIP = (120, 12.0, (1920, 1080))
# phase 17: the server in this process on 127.0.0.1: grade_video on a
# 48-frame 1080p clip at 24 fps at batch 8 (6 batches), enhancer renders of
# a 24-frame 1080p clip to 4K, a 4K PNG, a 4 s click track at 120 bpm
# written as a 44.1 kHz WAV, and `serve` in a process of its own, which
# must answer /vrgdg/health within SERVE_START_LIMIT_S
SERVER_GRADE_CLIP = (48, 24.0, (1920, 1080))
SERVER_GRADE_BATCH = 8
SERVER_RENDER_CLIP = (24, 24.0, (1920, 1080))
SERVER_CLICKS = (4.0, 44100, 120.0)                   # seconds, rate, bpm
SERVE_START_LIMIT_S = 90.0
SECONDARY = (1080, 1920)                              # H, W
LORA = (4096, 4096, 16)
# phase 23: lut_apply at Apply LUT's batch (1080p x 8) and at 4K x 2, the
# same pixels, the flagship LUT at 10; Apply LUT's stream on a 17-frame
# 1080p clip at batch 8 (frames, batch, H, W); the bundle row each pixel
# gathers from L2 (no L2 bandwidth is published, so its bytes are printed
# beside the HBM term, not priced)
LUT_SHAPES = ((8, 1080, 1920), (2, 2160, 3840))
LUT_STRENGTH = 10.0
LUT_STREAM = (17, 8, 1080, 1920)
LUT_GATHER_BYTES = 96
# kernel vs plain on the card: nvcc contracts a*b+c into FMAs and its
# powf/cbrtf/logf differ from the plain ops' by an ulp or two.  Measured
# on an H100 (700 W): LAB 1.2e-4, A/B 9.5e-7, RGB 1.07e-5 with grain off
# and on.  The planes layouts and the grain kernel run the same formulas,
# so they are held to the same bounds; the probe to its TPU tool's 1e-4.
# lanczos4 on the card against the CPU: float32 products summed in other
# orders; against cv2: the JAX suite's cv2 budget.
BOUNDS = {"lab": 5e-4, "coeff": 1e-5, "rgb_grain_off": 2e-5,
          "rgb_grain_on": 5e-5, "probe": 1e-4, "resample_cpu": 1e-5,
          "resample_cv2": 1e-3, "compare_blend": 1e-6,
          "compare_letterbox": 1e-5, "face_crops": 2e-5,
          "face_composite": 1e-4, "paste_back_4k": 2e-5, "bilinear": 2e-5,
          "lanczos4": 1e-5, "lora_relative": 1e-5, "spatial": 1e-5,
          "lut_examples": 1e-5}
# NVIDIA's H100 SXM data sheet (at the 700 W limit): HBM bandwidth, and
# the float32 and float64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# MUFU (exp2, log2, reciprocal, square root, sine, cosine) and the
# float <-> int conversions run 16 a clock per SM, against 128 float32
# FMAs of 2 operations each (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): a sixteenth of the
# float32 rate, in instructions
XU_OPS_PER_S = FP32_OPS_PER_S / 16
# SASS opcode -> (instruction class, operations): the floating-point
# instructions; integer, address, memory and branch instructions are not
# counted, so the operations term stays a lower bound
SASS_OPS = {
    **{op: ("fp32", 2) for op in ("FFMA", "FFMA32I")},
    **{op: ("fp32", 1) for op in ("FADD", "FADD32I", "FMUL", "FMUL32I",
                                  "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
                                  "FSWZADD")},
    **{op: ("xu", 1) for op in ("MUFU", "F2F", "F2I", "I2F", "FRND")},
    "DFMA": ("fp64", 2),
    **{op: ("fp64", 1) for op in ("DADD", "DMUL", "DSETP", "DMNMX")},
}
OPS_RATES = {"fp32": FP32_OPS_PER_S, "xu": XU_OPS_PER_S,
             "fp64": FP64_OPS_PER_S}
# Issue slots, beside the bound and not part of it: an H100 SXM's 132 SMs
# each issue 4 warp instructions a clock (one per scheduler), 32 threads
# each, at the SM clock nvidia-smi gives as clocks.max.sm.  A probe's SASS
# instructions of every kind (integer, memory, branch included) over that
# rate is the least time a kernel running its code one pixel a thread can
# take to issue them.
SMS = 132
WARP_ISSUE_PER_CLOCK = 4
# Probe kernels for the operations term of the bounds: each runs one pixel
# of a kernel's own per-pixel code (grade.cu's helpers and common.h's
# functions, on the flagship's path: adjust contrast and vignette, grain
# on) on values it loads, so nothing folds.  Its floating-point SASS
# instructions above the copy-only "base" probe are what a pixel costs.
# Phase 2 is priced at one LAB -> RGB conversion a pixel, the function's
# own; the halo's extra conversions are the kernel's overhead.
SASS_PROBE_SOURCE = r"""
#include "grade.cu"
#include "lut.cu"

#define PROBE(name)                                                \
  extern "C" __global__ void probe_##name(const float* __restrict__ in, \
                                          float* __restrict__ out, int n)

PROBE(base) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (int c = 0; c < 3; ++c) out[3 * i + c] = in[3 * i + c];
}

// lattice cell, gather, trilerp and blend, [adjust], LAB, float64 sums
template <bool kAdjust>
__device__ __forceinline__ void phase1_pixel(const float* __restrict__ in,
                                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float source[3] = {in[3 * i], in[3 * i + 1], in[3 * i + 2]};
  const float dmin[3] = {in[0], in[1], in[2]};
  const float inv_span[3] = {in[3], in[4], in[5]};
  float frac[3], g[24], color[3], lab[3];
  const int cell = lattice_cell(source, dmin, inv_span, n, frac);
  for (int k = 0; k < 24; ++k) g[k] = in[24 * cell + k];
  trilerp_blend(g, frac, source, in[6], in[7], color);
  if (kAdjust) {
    AdjustParams adjust{};
    adjust.contrast = in[8];
    adjust.vignette = in[9];
    int y, x;
    pixel_yx(i, n, in[10], y, x);
    apply_adjust(color, kAdjustOn | kContrast | kVignette, adjust, y, x, n,
                 n);
  }
  rgb_to_lab(color, lab);
  double* sums = reinterpret_cast<double*>(out) + 6 * i;
  add_sums(lab, sums);
}

PROBE(grade_phase1) { phase1_pixel<true>(in, out, n); }
PROBE(grade_phase1_planes) { phase1_pixel<false>(in, out, n); }

// the affine transfer and LAB -> RGB of the pixel, the 3x3 unsharp of each
// channel (eight neighbours loaded), the grain and the final clip
PROBE(grade_phase2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[3], rgb[3], g[3];
  for (int c = 0; c < 3; ++c) v[c] = in[3 * i + c] * in[c] + in[3 + c];
  lab_to_rgb(v, rgb);
  grain_field(static_cast<uint32_t>(n), static_cast<uint32_t>(i), in[6],
              in[7], g);
  for (int c = 0; c < 3; ++c) {
    float w[3][3];
    for (int k = 0; k < 9; ++k) w[k / 3][k % 3] = in[9 * i + k + c];
    w[1][1] = rgb[c];
    out[3 * i + c] = clip01(unsharp3x3(w, in[8]) + g[c] * in[9]);
  }
}

// film_grain's pixel: the grain and clip(x + grain * intensity)
PROBE(film_grain) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float g[3];
  grain_field(static_cast<uint32_t>(n), static_cast<uint32_t>(i), in[0],
              in[1], g);
  for (int c = 0; c < 3; ++c) {
    out[3 * i + c] = clip01(in[3 * i + c] + g[c] * in[2]);
  }
}

// lut_apply's pixel: coordinates, the bundle row, the float64-summed
// trilerp and the blend
PROBE(lut_apply) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float src[3] = {in[3 * i], in[3 * i + 1], in[3 * i + 2]};
  const float dmin[3] = {in[0], in[1], in[2]};
  const float span[3] = {in[3], in[4], in[5]};
  float rgb[3];
  lut_pixel(src, in + 8, n, dmin, span, in[6], keep_of(in[6]), rgb);
  for (int c = 0; c < 3; ++c) out[3 * i + c] = rgb[c];
}
"""
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
    "lut_apply": ("vrgdg_tpu_torch/kernels/csrc/lut.cu",
                  "none in Pallas; vrgdg_tpu/ops/lut.py::apply_lut_bundle "
                  "(XLA gather)"),
}


def _say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _nvidia_smi(query: str = "name,power.limit",
                fmt: str = "csv,noheader") -> str:
    result = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return result.stdout.strip().splitlines()[0].strip()


def _sm_clock_hz() -> float:
    """The card's maximum SM clock (``clocks.max.sm``), in Hz."""
    return float(_nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6


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


def _start_sass_probe(folder: str):
    """Start nvcc on :data:`SASS_PROBE_SOURCE` (sm_90a, -O3, next to the
    kernels' sources); returns the cubin path and the process."""
    from vrgdg_tpu_torch.kernels import build

    source = os.path.join(folder, "probe_math.cu")
    with open(source, "w", encoding="utf-8") as handle:
        handle.write(SASS_PROBE_SOURCE)
    cubin = os.path.join(folder, "probe_math.cubin")
    process = subprocess.Popen(
        [build.find_nvcc(), "-cubin", "-O3", "-std=c++17", "-arch=sm_90a",
         "-I", build.CSRC_DIR, "-o", cubin, source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        errors="replace")
    return cubin, process


def _sass_counts(text: str, prefix: str = "probe_") -> dict:
    """Floating-point operations of each ``<prefix>*`` function of
    ``cuobjdump -sass`` output, by instruction class (:data:`SASS_OPS`),
    and its ``instructions`` of every kind, on the path these inputs take:
    from its entry to its first unpredicated EXIT (out-of-line slow paths
    after it are not counted), leaving out every stretch that a forward
    conditional branch jumps over and that holds a loop (a backward
    branch): in the probes, the large-argument reduction of sinf and cosf,
    which runs only for |x| > 105615 and never for Box-Muller's angles in
    (0, 2 pi]."""
    functions, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            found = re.search(r"Function : " + prefix + r"(\w+)", line)
            name = found.group(1) if found else None
            if name is not None:
                functions[name] = []
            continue
        found = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_]+)[^;]*?(?:0x([0-9a-f]+))?\s*;", line)
        if name is not None and found:
            address, predicate, opcode, target = found.groups()
            functions[name].append(
                (int(address, 16), bool(predicate), opcode,
                 int(target, 16) if target and opcode == "BRA" else None))
    counts = {}
    for name, code in functions.items():
        skipped = set()
        for address, predicate, opcode, target in code:
            if opcode == "BRA" and predicate and target and target > address:
                inside = [i for i in code if address < i[0] < target]
                if any(i[2] == "BRA" and i[3] is not None and i[3] < i[0]
                       for i in inside):
                    skipped.update(i[0] for i in inside)
        total = {**dict.fromkeys(OPS_RATES, 0), "instructions": 0}
        for address, predicate, opcode, _ in code:
            if opcode == "EXIT" and not predicate:
                break
            if address in skipped:
                continue
            total["instructions"] += 1
            if opcode in SASS_OPS:
                kind, ops = SASS_OPS[opcode]
                total[kind] += ops
        counts[name] = total
    return counts


def _finish_sass_probe(cubin: str, process) -> dict:
    """Each probe's operations by instruction class and its instructions,
    above the ``base`` probe."""
    from vrgdg_tpu_torch.kernels import build

    log, _ = process.communicate(timeout=600)
    if process.returncode != 0:
        raise RuntimeError(f"nvcc failed on the SASS probe:\n{log}")
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = _sass_counts(text)
    expected = {"base", "grade_phase1", "grade_phase1_planes",
                "grade_phase2", "film_grain", "lut_apply"}
    if set(counts) != expected:
        raise RuntimeError(f"SASS probe: found {sorted(counts)}")
    base = counts.pop("base")
    return {name: {kind: ops - base[kind] for kind, ops in count.items()}
            for name, count in counts.items()}


def kernel_bounds(shape, bundle_bytes: int, sass: dict,
                  sm_clock_hz: float) -> dict:
    """Kernel -> (bound ms, "bytes" or "operations", issue ms or None) at
    ``shape``.  The bound is the larger of the bytes each function must
    move (each input read once, each output written once) at
    :data:`HBM_BYTES_PER_S`, and its floating-point operations a pixel from
    ``sass`` (the probes of :data:`SASS_PROBE_SOURCE`), each instruction
    class at its rate in :data:`OPS_RATES`; the classes run side by side,
    so the slowest sets the term.  ``weighted_row_sum`` runs one row a
    pixel: 24 FMAs, and has no probe.  The issue ms, reported beside the
    bound and not part of it, is a probe's instructions a pixel at the
    card's issue rate (:data:`SMS` x :data:`WARP_ISSUE_PER_CLOCK` x 32
    threads x ``sm_clock_hz``)."""
    from vrgdg_tpu_torch.kernels.grade_cuda import PHASE1_BLOCK

    batch, height, width = shape
    pixels = batch * height * width
    partials = batch * -(-height * width // PHASE1_BLOCK) * 6 * 8
    work = {   # name: (bytes, operations a pixel by instruction class)
        "grade_phase1": (24 * pixels + bundle_bytes + partials,
                         sass["grade_phase1"]),
        "grade_phase2": (24 * pixels + batch * 24, sass["grade_phase2"]),
        "grade_phase1_planes": (120 * pixels + partials,
                                sass["grade_phase1_planes"]),
        "grade_phase2_planes": (24 * pixels + batch * 24,
                                sass["grade_phase2"]),
        "film_grain": (24 * pixels, sass["film_grain"]),
        "weighted_row_sum": (100 * pixels, {"fp32": 48}),
        "lut_apply": (24 * pixels + bundle_bytes, sass["lut_apply"]),
    }
    issue_rate = SMS * WARP_ISSUE_PER_CLOCK * 32 * sm_clock_hz
    bounds = {}
    for name, (nbytes, ops) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        terms = {kind: ops.get(kind, 0) * pixels / rate * 1e3
                 for kind, rate in OPS_RATES.items()}
        ops_ms = max(terms.values())
        instructions = ops.get("instructions")
        issue_ms = (None if instructions is None
                    else instructions * pixels / issue_rate * 1e3)
        bounds[name] = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                        else (ops_ms, "operations")) + (issue_ms,)
        _say("bound", kernel=name, bytes_ms=f"{bytes_ms:.4f}",
             **{f"{kind}_ops": ops.get(kind, 0) for kind in OPS_RATES},
             **{f"{kind}_ms": f"{ms:.4f}" for kind, ms in terms.items()},
             bound_by=bounds[name][1], instructions=instructions,
             issue_ms="none" if issue_ms is None else f"{issue_ms:.4f}",
             sm_clock_mhz=f"{sm_clock_hz / 1e6:.0f}")
    return bounds


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


def _smooth_frames(shape, seed: int, device):
    """A gradient per channel (x, y, their mean) plus uniform noise of
    +-2 levels: neighbouring pixels fall in the same LUT cells, as in real
    footage."""
    batch, height, width = shape
    y = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    x = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    ramp = torch.stack([x.expand(height, width), y.expand(height, width),
                        ((x + y) / 2).expand(height, width)], dim=-1)
    generator = torch.Generator(device="cpu").manual_seed(seed)
    noise = (torch.rand((batch, height, width, 3), generator=generator)
             - 0.5) * (4.0 / 255.0)
    return torch.clamp(ramp + noise.to(device), 0.0, 1.0).contiguous()


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
            smooth_line(frames, table, domain, blend, adjust, reps,
                        shape_times["grade_phase1"][0])
        del frames, lab_k, lab_p, part_k, part_p
        torch.cuda.empty_cache()
    return errors, times


def smooth_line(frames, table, domain, blend, adjust, reps,
                random_ms) -> None:
    """Phase 1 on a smooth batch of ``frames``' shape beside its time on
    the seeded uniform one, and a ``copy_`` of ``frames`` (12 bytes read
    and 12 written a pixel) as the measured copy floor."""
    from vrgdg_tpu_torch.kernels import grade_cuda as gc

    smooth = _smooth_frames(tuple(frames.shape[:3]), 120, frames.device)
    lab_k, _ = gc.phase1(smooth, table, domain, blend=blend, adjust=adjust)
    lab_p, _ = gc.phase1_plain(smooth, table, domain, blend=blend,
                               adjust=adjust)
    err = _max_err(lab_k, lab_p)
    _check("smooth LAB", err, BOUNDS["lab"])
    smooth_ms = _cuda_ms(lambda: gc.phase1(smooth, table, domain,
                                           blend=blend, adjust=adjust), reps)
    copy = torch.empty_like(frames)
    copy_ms = _cuda_ms(lambda: copy.copy_(frames), reps)
    _say("phase1-smooth", shape=_label(frames.shape[:3]),
         lab_err=f"{err:.3g}<={BOUNDS['lab']:g}",
         grade_phase1_smooth_ms=f"{smooth_ms:.4f}",
         grade_phase1_uniform_ms=f"{random_ms:.4f}",
         copy_floor_ms=f"{copy_ms:.4f}")
    del smooth, lab_k, lab_p, copy


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


def _drain(iterable) -> None:
    for _ in iterable:
        pass


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
        breakdown(lambda: _drain(appliers.stream_graded_batches(
            source, effect, batch_size=batch, device=device)), count)
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


def breakdown(run_pass, frames: int) -> None:
    """Device time by kernel over one more pass of a path (``run_pass()``),
    from ``torch.profiler``, and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        started = time.perf_counter()
        run_pass()
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


# launches of the layout run of phase 8: rowmajor and plane with grain off
# and on, plane with emit="planes", then flat and rowmajor with adjust
LAYOUT_RUN_LAUNCHES = {"grade_phase1": 4, "grade_phase2": 1,
                       "grade_phase1_planes": 3, "grade_phase2_planes": 6}


def layouts(device, config, lut, ref_stats, shapes, reps=10):
    """Phase 8: the planes kernels against their plain versions, and
    ``grade_phase2_planes`` bit for bit against ``grade_phase2`` on the
    same LAB, permuted; then the ``"rowmajor"`` and ``"plane"`` layouts
    against ``"flat"``; returns max errors, the timed shape's ms and the
    layout run's launches (:data:`LAYOUT_RUN_LAUNCHES`)."""
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
        lab_bhwc = lab_p.permute(0, 2, 3, 1).contiguous()
        for label, intensity in (("off", 0.0), ("on", grain.intensity)):
            kw = dict(sharpen_strength=config.sharpen.strength,
                      grain_intensity=intensity,
                      saturation_mix=grain.saturation_mix,
                      seed_base=grain.seed)
            bound = BOUNDS[f"rgb_grain_{label}"]
            rgb_planes = gc.phase2_planes(lab_p, coeff_p, **kw)
            err = _max_err(rgb_planes,
                           gc.phase2_planes_plain(lab_p, coeff_p, **kw))
            _check(f"{shape} planes phase 2 grain {label}", err, bound)
            errors["grade_phase2_planes"] = max(
                errors["grade_phase2_planes"], err)
            line[f"phase2_err_grain_{label}"] = f"{err:.3g}<={bound:g}"
            # one phase-2 body for both layouts: the same bits, permuted
            rgb_flat = gc.phase2(lab_bhwc, coeff_p, **kw).permute(0, 3, 1, 2)
            if not torch.equal(rgb_planes, rgb_flat):
                raise AssertionError(
                    f"{shape} grain {label}: grade_phase2_planes differs "
                    "from grade_phase2, permuted, by "
                    f"{_max_err(rgb_planes, rgb_flat)}")
            del rgb_planes, rgb_flat
        _say("planes-vs-plain", **line)
        _say("planes-vs-flat", shape=_label(shape),
             grain_off="bit-identical", grain_on="bit-identical")
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
        del frames, src, planes, lab_k, lab_p, part_k, part_p, lab_bhwc
        torch.cuda.empty_cache()

    # the layouts end to end at 4K x 2, on bench.py's fused_pallas2 stack
    # (no adjust: the plane layout has none)
    frames = _frames(TIMED_SHAPE, 450, device)
    flat = {}
    for label, intensity in (("off", 0.0), ("on", grain.intensity)):
        kw = dict(blend=blend, match_strength=match,
                  sharpen_strength=config.sharpen.strength,
                  grain_intensity=intensity,
                  saturation_mix=grain.saturation_mix)
        flat[label] = (kw, gc.fused_post_gather(frames, *operands,
                                                grain.seed, **kw))
    # the layout run, every launch counted: the other two layouts,
    # emit="planes", and flat and rowmajor with adjust
    kw = flat["on"][0]
    adjust = _active_adjust(config)
    build.reset_launch_counts()
    got = {(layout, label): gc.fused_post_gather(
               frames, *operands, grain.seed, layout=layout, **layout_kw)
           for label, (layout_kw, _) in flat.items()
           for layout in ("rowmajor", "plane")}
    planes_out = gc.fused_post_gather(frames, *operands, grain.seed,
                                      layout="plane", emit="planes", **kw)
    with_adjust = {layout: gc.fused_post_gather(
        frames, *operands, grain.seed, layout=layout, adjust=adjust, **kw)
        for layout in ("flat", "rowmajor")}
    torch.cuda.synchronize()
    launches = {name: count for name, count in build.LAUNCHES.items()
                if count}
    if launches != LAYOUT_RUN_LAUNCHES:
        raise AssertionError(f"the layout run launched {launches}; "
                             f"expected {LAYOUT_RUN_LAUNCHES}")
    line = {}
    for (layout, label), out in got.items():
        bound = BOUNDS[f"rgb_grain_{label}"]
        err = _max_err(out, flat[label][1])
        _check(f"layout {layout} vs flat, grain {label}", err, bound)
        line[f"{layout}_err_grain_{label}"] = f"{err:.3g}<={bound:g}"
    if not torch.equal(planes_out, got[("plane", "on")].permute(0, 3, 1, 2)):
        raise AssertionError("emit='planes' differs from the BHWC output")
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
    against its plain version and ``torch.mv`` (the one PyTorch call that
    computes the same function; timed only); returns max error, ms at 4K x
    2's pixel count, the probe run's launches and ``torch.mv``'s ms."""
    from vrgdg_tpu_torch.kernels import build, probe_cuda
    from vrgdg_tpu_torch.tools import probe_transpose

    build.reset_launch_counts()
    probe_err = probe_transpose.run(device)
    launches = {"weighted_row_sum": build.LAUNCHES["weighted_row_sum"]}
    _check("transpose probe vs its numpy oracle", probe_err, BOUNDS["probe"])
    _say("probe", rows=4096, err=f"{probe_err:.3g}<={BOUNDS['probe']:g}",
         launches=launches)
    worst, timed, library_ms = 0.0, None, None
    pixels = TIMED_SHAPE[0] * TIMED_SHAPE[1] * TIMED_SHAPE[2]
    weights = torch.arange(1, probe_cuda.WIDTH + 1, dtype=torch.float32,
                           device=device)
    for rows in (4096, pixels):
        generator = torch.Generator(device="cpu").manual_seed(rows)
        g = (torch.rand((rows, 24), generator=generator) * 2 - 1).to(device)
        err = _max_err(probe_cuda.weighted_row_sum(g),
                       probe_cuda.weighted_row_sum_plain(g))
        _check(f"weighted_row_sum rows={rows}", err, BOUNDS["probe"])
        worst = max(worst, err)
        ms = _timed_pair(lambda: probe_cuda.weighted_row_sum(g),
                         lambda: probe_cuda.weighted_row_sum_plain(g), reps)
        library_ms = _cuda_ms(lambda: torch.mv(g, weights), reps)
        _say("probe-vs-plain", rows=rows, err=f"{err:.3g}",
             weighted_row_sum_ms=f"{ms[0]:.4f}",
             weighted_row_sum_plain_ms=f"{ms[1]:.4f}",
             torch_mv_ms=f"{library_ms:.4f}")
        timed = ms
        del g
    torch.cuda.empty_cache()
    return worst, timed, launches, library_ms


def file_phase(device, config, lut) -> None:
    """Phase 10: ``grade_video`` on a generated clip."""
    import cv2

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
        _say("file", frames=result["processed_frames"],
             size="640x360", encoder=result["encoder"])


def resample_phase(device, reps=10) -> None:
    """Phase 11: lanczos4 ``resample`` 1080p -> 2160x3840 on the card
    against the same function on the CPU and against cv2; again with TF32
    turned on just before the call (the products must force float32
    themselves); its ms per frame, and the tap-gather form of the same
    weights timed for comparison."""
    import cv2

    from vrgdg_tpu_torch.ops import resize

    (src_h, src_w), (dst_h, dst_w) = RESAMPLE
    frame = np.random.default_rng(21).uniform(
        0, 1, (1, src_h, src_w, 3)).astype(np.float32)
    x = torch.from_numpy(frame).to(device)
    got = resize.resample(x, dst_h, dst_w, "lanczos4")
    cpu_err = _max_err(got.cpu(), resize.resample(
        torch.from_numpy(frame), dst_h, dst_w, "lanczos4"))
    cv2_err = _max_err(got[0].cpu(), torch.from_numpy(cv2.resize(
        frame[0], (dst_w, dst_h), interpolation=cv2.INTER_LANCZOS4)))
    _check("lanczos4 card vs CPU", cpu_err, BOUNDS["resample_cpu"])
    _check("lanczos4 card vs cv2", cv2_err, BOUNDS["resample_cv2"])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with_tf32 = resize.resample(x, dst_h, dst_w, "lanczos4")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.equal(with_tf32, got):
        raise AssertionError("lanczos4 changed with TF32 on: "
                             f"{_max_err(with_tf32, got)}")

    def taps():
        y = resize._resample_axis(x, 1, src_h, dst_h, "lanczos4")
        return resize._resample_axis(y, 2, src_w, dst_w, "lanczos4")

    tap_err = _max_err(taps(), got)
    ms = _cuda_ms(lambda: resize.resample(x, dst_h, dst_w, "lanczos4"), reps)
    tap_ms = _cuda_ms(taps, reps)
    # the two dense products, width first: dw*sw*sh + dh*sh*dw MACs a
    # channel
    flop = 2 * 3 * (dst_w * src_w * src_h + dst_h * src_h * dst_w)
    _say("resample", size=f"{src_h}x{src_w}->{dst_h}x{dst_w}",
         cpu_err=f"{cpu_err:.3g}<={BOUNDS['resample_cpu']:g}",
         cv2_err=f"{cv2_err:.3g}<={BOUNDS['resample_cv2']:g}",
         tf32_on="bit-identical", dense_ms_per_frame=f"{ms:.4f}",
         dense_tflops=f"{flop / ms / 1e9:.2f}",
         tap_gather_ms_per_frame=f"{tap_ms:.4f}",
         tap_gather_err=f"{tap_err:.3g}")
    del x, got, with_tf32
    torch.cuda.empty_cache()


def _enhance_checks(device, settings) -> None:
    """Phase 12's checks: a batch split on the card is bit-identical, and
    a small clip on the card is at most one uint8 level from the CPU path
    on at most 0.1% of values."""
    from vrgdg_tpu_torch.jobs import enhancer

    (count, src_h, src_w), (out_w, out_h) = ENHANCE_RUN, ENHANCE_SIZE
    frames = np.random.default_rng(31).integers(
        0, 256, (4, src_h, src_w, 3), np.uint8)
    whole = enhancer.apply_effects_batch(frames, settings, out_h, out_w, 0,
                                         device=device)
    split = np.concatenate([
        enhancer.apply_effects_batch(frames[0:1], settings, out_h, out_w, 0,
                                     device=device),
        enhancer.apply_effects_batch(frames[1:4], settings, out_h, out_w, 1,
                                     device=device)])
    if not np.array_equal(whole, split):
        raise AssertionError("enhance step: frames[0:4]@0 != "
                             "frames[0:1]@0 + frames[1:4]@1")
    del whole, split
    small = np.random.default_rng(32).integers(0, 256, (5, 135, 240, 3),
                                               np.uint8)
    got = enhancer.apply_effects_batch(small, settings, 270, 480, 3,
                                       device=device, as_uint8=True)
    want = enhancer.apply_effects_batch(small, settings, 270, 480, 3,
                                        device="cpu", as_uint8=True)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((diff > 0).mean())
    if got.shape != (5, 270, 480, 3) or diff.max() > 1 or share > 1e-3:
        raise AssertionError(f"enhance step card vs CPU: shape {got.shape}, "
                             f"max {diff.max()} levels, {share:.2e} differ")
    _say("enhance-checks", split_0_1_4="bit-identical",
         small_clip="5x135x240->270x480", max_level_diff=int(diff.max()),
         differing_share=f"{share:.2e}<=1e-3")


def enhance_path(device, card: str) -> dict:
    """Phase 12: seeded 1080p uint8 frames streamed through the enhancer's
    submit/force loop (``enhance_batches``) to 4K at the auto batch;
    returns the ``enhance_step`` launches of the timed passes, which must
    be one per batch (the stream's uint8 batches run the fused step)."""
    from vrgdg_tpu_torch.core.params import EnhancerSettings, auto_batch_size
    from vrgdg_tpu_torch.jobs import enhancer
    from vrgdg_tpu_torch.kernels import build

    settings = EnhancerSettings.normalize(ENHANCE)
    _enhance_checks(device, settings)
    count, src_h, src_w = ENHANCE_RUN
    out_w, out_h = ENHANCE_SIZE
    batch = auto_batch_size(out_w, out_h)
    source = _source(count, batch, src_h, src_w, 1080)

    def run_pass(stats=None) -> list:
        shapes = []
        enhancer.enhance_batches(
            source, settings, out_h, out_w, device=device, batch_size=batch,
            write=lambda out: shapes.append(out.shape), stats=stats)
        return shapes

    run_pass()  # warm-up: builds nothing new, allocates the pinned buffers
    fps, device_ms, launches = [], [], 0
    for _ in range(TIMED_PASSES):
        stats: dict = {}
        build.reset_launch_counts()
        started = time.perf_counter()
        shapes = run_pass(stats)
        wall = time.perf_counter() - started
        fused = build.LAUNCHES["enhance_step"]
        frames = sum(s[0] for s in shapes)
        if frames != count or any(s[1:] != (out_h, out_w, 3) for s in shapes):
            raise AssertionError(f"enhance path returned {frames} frames of "
                                 f"shapes {set(shapes)}")
        if fused != len(source) or build.LAUNCHES["film_grain"]:
            raise AssertionError(f"enhance path launched enhance_step {fused} "
                                 f"times over {len(source)} batches")
        launches += fused
        fps.append(count / wall)
        device_ms.append(stats["device_ms"] / count)
    _say("enhance-path", frames=count, size=f"{src_h}x{src_w}->{out_h}x{out_w}",
         batch=batch, passes=TIMED_PASSES, enhance_step_launches_per_pass=fused,
         batches_per_pass=len(source),
         wall_fps=",".join(f"{v:.2f}" for v in fps),
         median_wall_fps=f"{float(np.median(fps)):.2f}",
         device_ms_per_frame=",".join(f"{v:.4f}" for v in device_ms),
         card=f"'{card}'")
    breakdown(run_pass, count)
    torch.cuda.empty_cache()
    return {"enhance_step": launches}


def _write_clip(path: str, frames: int, fps: float, width: int, height: int,
                seed: int) -> str:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, (height, width, 3), np.uint8)
            for _ in range(4)]
    for index in range(frames):
        writer.write(pool[index % 4])
    writer.release()
    return path


def _decode(path: str) -> np.ndarray:
    import cv2

    capture = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return np.stack(frames)


def enhancer_job(device) -> None:
    """Phase 13: ``render_job`` on a generated 1080p clip to 4K in two
    segments, then a cancel -> resume on a small clip, decoded byte for
    byte against an uninterrupted run."""
    from vrgdg_tpu_torch.jobs import enhancer
    from vrgdg_tpu_torch.runtime import video_io

    class CancelAfterFirstCommit(enhancer.JobRegistry):
        # the post-commit update is the only one with stage_seconds_total
        # and no status
        def update(self, job_id, **values):
            super().update(job_id, **values)
            if "stage_seconds_total" in values and "status" not in values:
                self.cancel_event(job_id).set()

    def render(registry, folder, clip, settings, resume=False):
        enhancer.render_job("smoke_job", {"source_path": clip,
                                          "settings": settings},
                            resume=resume, registry=registry,
                            base_folder=folder, device=device)
        return registry.snapshot("smoke_job")

    frames, fps, (src_w, src_h) = JOB_CLIP
    settings = {**ENHANCE, "segment_seconds": 5, "preserve_audio": False}
    with tempfile.TemporaryDirectory() as folder:
        clip = _write_clip(os.path.join(folder, "clip.mp4"), frames, fps,
                           src_w, src_h, 41)
        started = time.perf_counter()
        final = render(enhancer.JobRegistry(), folder, clip, settings)
        wall = time.perf_counter() - started
        if final.get("status") != "complete":
            raise AssertionError(f"render_job: {final.get('status')}: "
                                 f"{final.get('error')}")
        meta = video_io.probe_video(final["output_path"])
        out_w, out_h = ENHANCE_SIZE
        if (meta["frame_count"], meta["width"], meta["height"],
                final["total_segments"]) != (frames, out_w, out_h, 2):
            raise AssertionError(f"render_job output: {meta}, "
                                 f"{final['total_segments']} segments")
        _say("enhancer-job", frames=frames, fps_in=fps,
             size=f"{src_w}x{src_h}->{meta['width']}x{meta['height']}",
             segments=final["total_segments"], wall_s=f"{wall:.3f}",
             wall_fps=f"{frames / wall:.2f}",
             stage_seconds_total=json.dumps(final["stage_seconds_total"],
                                            separators=(",", ":")),
             concat=final["encode_backend"])

    small = {**ENHANCE, "upscale_resolution": "2k", "segment_seconds": 5,
             "preserve_audio": False}
    with tempfile.TemporaryDirectory() as folder:
        clip = _write_clip(os.path.join(folder, "small.mp4"), 60, 10.0, 64,
                           48, 42)
        full = render(enhancer.JobRegistry(), os.path.join(folder, "a"),
                      clip, small)
        stopped = render(CancelAfterFirstCommit(), os.path.join(folder, "b"),
                         clip, small)
        resumed = render(enhancer.JobRegistry(), os.path.join(folder, "b"),
                         clip, small, resume=True)
        if (full.get("status"), stopped.get("status"),
                resumed.get("status")) != ("complete", "canceled", "complete"):
            raise AssertionError(
                f"cancel/resume: {full.get('status')}, "
                f"{stopped.get('status')}, {resumed.get('status')}: "
                f"{full.get('error')} {resumed.get('error')}")
        a, b = _decode(full["output_path"]), _decode(resumed["output_path"])
        if a.shape != (60, 1920, 2560, 3) or not np.array_equal(a, b):
            raise AssertionError(f"resumed output differs: {a.shape} vs "
                                 f"{b.shape}")
        _say("enhancer-resume", frames=60, size="64x48->2560x1920",
             segments=resumed["total_segments"],
             canceled_after_segments=1, decoded="byte-identical",
             concat=resumed["encode_backend"])


def _levels_apart(label: str, got: np.ndarray, want: np.ndarray) -> dict:
    """Two uint8 images at most one level apart on at most 0.1% of
    values (PERF.md section 2's rule for the card against the CPU)."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((diff > 0).mean())
    if got.shape != want.shape or diff.max() > 1 or share > 1e-3:
        raise AssertionError(f"{label}: shapes {got.shape} {want.shape}, "
                             f"max {diff.max()} levels, {share:.2e} differ")
    return {"max_level_diff": int(diff.max()),
            "differing_share": f"{share:.2e}<=1e-3"}


def _share_apart(label: str, got: np.ndarray, want: np.ndarray) -> float:
    """:func:`_levels_apart`'s check; returns the share of values that
    differ."""
    _levels_apart(label, got, want)
    diff = got.astype(np.int16) != want.astype(np.int16)
    return float(diff.mean())


def _render_compare_checks(device, reps=5) -> None:
    """Phase 14a: every compare mode at 4K x 8 on the card against the
    CPU, and its CUDA-event ms; then B at 1080p letterboxed onto A."""
    from vrgdg_tpu_torch.ops import compare

    count, height, width = COMPARE_BATCH
    rng = np.random.default_rng(51)
    host = [torch.from_numpy(rng.integers(0, 256, (count, h, w, 3),
                                          np.uint8)).float() / 255.0
            for h, w in ((height, width), (height, width), LETTERBOX_B)]
    a_cpu, b_cpu, small_cpu = host
    a, b, small = (t.to(device) for t in host)
    options = dict(slider_position=0.37, overlay_opacity=0.3,
                   difference_gain=4.0, fps=24.0, blink_speed=3.0,
                   frame_start=5)
    for mode in compare.MODES:
        got = compare.render_compare(a, b, mode, **options).cpu()
        want = compare.render_compare(a_cpu, b_cpu, mode, **options)
        if mode in ("overlay", "difference"):
            err = _max_err(got, want)
            _check(f"compare {mode} card vs CPU", err,
                   BOUNDS["compare_blend"])
            agreement = f"{err:.3g}<={BOUNDS['compare_blend']:g}"
        elif torch.equal(got, want):
            agreement = "bit-identical"
        else:
            raise AssertionError(f"compare {mode}: card differs from CPU by "
                                 f"{_max_err(got, want)}")
        del got, want
        ms = _cuda_ms(lambda: compare.render_compare(a, b, mode, **options),
                      reps)
        # bytes the render moves: both inputs read, the output written
        out_bytes = a.numel() * 4 * (2 if mode == "side_by_side" else 1)
        _say("compare-mode", mode=mode, shape=_label(COMPARE_BATCH),
             agreement=agreement, ms=f"{ms:.4f}",
             gb_per_s=f"{(2 * a.numel() * 4 + out_bytes) / ms / 1e6:.1f}")
    got = compare.align_pair(a, small)[1].cpu()
    err = _max_err(got, compare.align_pair(a_cpu, small_cpu)[1])
    _check("letterbox card vs CPU", err, BOUNDS["compare_letterbox"])
    del got
    ms = _cuda_ms(lambda: compare.render_compare(a, small, "side_by_side"),
                  reps)
    _say("compare-letterbox", b=_label((count, *LETTERBOX_B)),
         onto=_label(COMPARE_BATCH), method="bicubic",
         err=f"{err:.3g}<={BOUNDS['compare_letterbox']:g}",
         side_by_side_ms=f"{ms:.4f}")
    del a, b, small
    torch.cuda.empty_cache()


def _still(path: str, height: int, width: int, seed: int) -> str:
    """A seeded PNG: a gradient with noise, as a photo's levels spread."""
    from vrgdg_tpu_torch.runtime import image_io

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([xx / width, yy / height, (xx + yy) / (width + height)],
                    -1) * 200.0
    noise = np.random.default_rng(seed).normal(0, 12, (height, width, 3))
    return image_io.write_rgb(path, np.clip(base + noise + 28, 0, 255)
                              .astype(np.uint8))


def _image_appliers(device, folder: str) -> None:
    """Phase 14b: the three image appliers on a 4K PNG on the card, run
    twice (byte-identical), and at 1080p on the card and the CPU."""
    import cv2

    from vrgdg_tpu_torch.api import appliers

    runs = {
        "lut": lambda src, out, dev: appliers.apply_lut_to_image(
            src, FLAGSHIP["lut_name"], out, FLAGSHIP["lut_strength"],
            device=dev),
        "grain": lambda src, out, dev: appliers.apply_film_grain_to_image(
            src, out, FLAGSHIP["grain_intensity"],
            FLAGSHIP["saturation_mix"], FLAGSHIP["seed"], device=dev),
        "adjust": lambda src, out, dev: appliers.apply_adjust_to_image(
            src, out, FLAGSHIP["adjust"], device=dev),
    }
    for (height, width), seed in zip(STILL_SIZES, (61, 62)):
        source = _still(os.path.join(folder, f"still_{height}.png"), height,
                        width, seed)
        for name, run in runs.items():
            outs = [os.path.join(folder, f"{name}_{height}_{k}.png")
                    for k in ("card", "again", "cpu")]
            started = time.perf_counter()
            first = run(source, outs[0], device)
            wall = (time.perf_counter() - started) * 1e3
            second = run(source, outs[1], device)
            with open(outs[0], "rb") as x, open(outs[1], "rb") as y:
                if x.read() != y.read():
                    raise AssertionError(f"image {name} at {height}p: reruns "
                                         "differ")
            line = dict(applier=name, size=f"{height}x{width}",
                        device=first["device"].replace(" ", "_"),
                        ms=f"{first['elapsed_seconds'] * 1e3:.3f}",
                        wall_ms=f"{wall:.3f}",
                        rerun_ms=f"{second['elapsed_seconds'] * 1e3:.3f}",
                        rerun_stage_seconds=json.dumps(
                            second["stage_seconds"], separators=(",", ":")),
                        rerun="byte-identical")
            if (height, width) != STILL_SIZES[0]:
                cpu = run(source, outs[2], "cpu")
                line.update(cpu_ms=f"{cpu['elapsed_seconds'] * 1e3:.3f}",
                            **_levels_apart(f"image {name} card vs CPU",
                                            cv2.imread(outs[0]),
                                            cv2.imread(outs[2])))
            _say("image-applier", **line)
    _image_breakdown(device, os.path.join(
        folder, f"still_{STILL_SIZES[0][0]}.png"))


def _image_breakdown(device, source: str, reps: int = 3) -> None:
    """The LUT image applier's steps at 4K, each timed alone (host clock,
    the device synchronized after each device step), median of
    ``reps``."""
    from vrgdg_tpu_torch.api import appliers
    from vrgdg_tpu_torch.runtime import image_io

    effect, _ = appliers._lut_effect(FLAGSHIP["lut_name"],
                                     FLAGSHIP["lut_strength"], None, device)
    steps: dict[str, list[float]] = {}

    def timed(name, fn):
        started = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        steps.setdefault(name, []).append(
            (time.perf_counter() - started) * 1e3)
        return value

    with tempfile.TemporaryDirectory() as folder:
        for _ in range(reps):
            u8 = timed("read", lambda: image_io.read_rgb(source))
            array = timed("divide", lambda: u8.astype(np.float32)[None]
                          / 255.0)
            x = timed("upload", lambda: torch.from_numpy(array).to(device))
            y = timed("effect", lambda: effect(x, 0))
            out = timed("download", lambda: y.cpu().numpy())
            q = timed("quantize", lambda: np.clip(out[0] * 255.0, 0, 255)
                      .astype(np.uint8))
            timed("write_png", lambda: image_io.write_rgb(
                os.path.join(folder, "out.png"), q))
    _say("image-breakdown", applier="lut",
         size=_label(STILL_SIZES[0]), reps=reps,
         **{f"{name}_ms": f"{float(np.median(v)):.3f}"
            for name, v in steps.items()})


def _previews(device, folder: str, clip: str) -> None:
    """Phase 14c: the three previews of the 4K PNG and of the first frame
    of a 1080p clip; ``delete_preview`` removes an after file once."""
    import cv2

    from vrgdg_tpu_torch.api import appliers, paths

    base = os.path.join(folder, "out")
    (height, width), (clip_w, clip_h) = STILL_SIZES[0], COMPARE_CLIP[2]
    media = {"png": (os.path.join(folder, f"still_{height}.png"),
                     (height, width)),
             "clip": (clip, (clip_h, clip_w))}
    for label, (path, size) in media.items():
        made = {
            "lut": appliers.preview_lut_on_media(
                path, FLAGSHIP["lut_name"], FLAGSHIP["lut_strength"],
                base=base, device=device),
            "grain": appliers.preview_film_grain_on_media(
                path, FLAGSHIP["grain_intensity"],
                FLAGSHIP["saturation_mix"], FLAGSHIP["seed"], base=base,
                device=device),
            "adjust": appliers.preview_adjust_on_media(
                path, FLAGSHIP["adjust"], base=base, device=device),
        }
        for name, pair in made.items():
            for key in ("before", "after"):
                image = cv2.imread(pair[key])
                if image is None or image.shape[:2] != size \
                        or os.path.dirname(pair[key]) != paths.preview_root(
                            base):
                    raise AssertionError(f"preview {name} of {label}: "
                                         f"{key} {pair[key]}")
        after = made["adjust"]["after"]
        if not appliers.delete_preview(after, base) or os.path.exists(after) \
                or appliers.delete_preview(after, base):
            raise AssertionError("delete_preview did not remove the file "
                                 "exactly once")
        _say("previews", media=label, size=_label(size),
             made=",".join(made), jpeg="before+after",
             delete_preview="once")


def _compare_media(device, folder: str, clips: tuple[str, str]) -> None:
    """Phase 14d: ``compare_images`` in every mode on 4K PNGs, and
    ``compare_videos`` side_by_side and blink on two 1080p clips."""
    import cv2

    from vrgdg_tpu_torch.api import compare
    from vrgdg_tpu_torch.ops.compare import MODES, blink_period
    from vrgdg_tpu_torch.runtime import video_io

    (height, width), _ = STILL_SIZES
    a = os.path.join(folder, f"still_{height}.png")
    b = _still(os.path.join(folder, "still_b.png"), height, width, 63)
    for mode in MODES:
        result = compare.compare_images(
            a, b, mode, os.path.join(folder, f"cmp_{mode}.png"),
            device=device)
        want_w = 2 * width + 2 if mode in ("side_by_side", "blink") else width
        shape = cv2.imread(result["output"]).shape
        if (result["width"], result["height"]) != (want_w, height) \
                or shape != (height, want_w, 3):
            raise AssertionError(f"compare_images {mode}: {result}, {shape}")
        _say("compare-image", mode=mode, size=f"{height}x{want_w}",
             ms=f"{result['elapsed_seconds'] * 1e3:.3f}")

    frames, fps, (clip_w, clip_h) = COMPARE_CLIP
    source_a, source_b = _decode(clips[0]), _decode(clips[1])
    for mode, blink_speed in (("side_by_side", 1.0), ("blink", 1.0)):
        result = compare.compare_videos(
            clips[0], clips[1], mode, os.path.join(folder, f"cmp_{mode}.mp4"),
            blink_speed=blink_speed, batch_size=8, device=device)
        want_w = 2 * clip_w + 2 if mode == "side_by_side" else clip_w
        meta = video_io.probe_video(result["output"])
        if (result["processed_frames"], meta["frame_count"], meta["width"],
                meta["height"]) != (frames, frames, want_w, clip_h):
            raise AssertionError(f"compare_videos {mode}: {result}, {meta}")
        line = {}
        if mode == "blink":
            period = blink_period(fps, blink_speed)
            out = _decode(result["output"]).astype(np.int16)
            for index in range(frames):
                to_a = np.abs(out[index] - source_a[index]).mean()
                to_b = np.abs(out[index] - source_b[index]).mean()
                if (to_a < to_b) != ((index // period) % 2 == 0):
                    raise AssertionError(f"blink frame {index} does not "
                                         f"follow a period of {period}")
            line["period"] = f"{period}(checked)"
        _say("compare-video", mode=mode, frames=frames,
             size=f"{clip_h}x{want_w}", **line,
             processed_fps=f"{result['processed_fps']:.2f}",
             stage_seconds=json.dumps(
                 {k: round(v, 3) for k, v in result["stage_seconds"].items()},
                 separators=(",", ":")),
             encoder=result["encoder"])


def images_and_compare(device) -> dict:
    """Phase 14: the still-image, preview and compare surface.  No TPU
    kernel lies on it, so its run (counts set to 0 just before, read just
    after) must launch none of the six ports of one; the LUT appliers
    launch ``lut_apply``.  Returns the launches."""
    import cv2  # noqa: F401  (required: the phase fails without it)

    from vrgdg_tpu_torch.kernels import build

    _render_compare_checks(device)
    frames, fps, (clip_w, clip_h) = COMPARE_CLIP
    with tempfile.TemporaryDirectory() as folder:
        clips = tuple(_write_clip(os.path.join(folder, name), frames, fps,
                                  clip_w, clip_h, seed)
                      for name, seed in (("a.mp4", 71), ("b.mp4", 72)))
        build.reset_launch_counts()
        _image_appliers(device, folder)
        _previews(device, folder, clips[0])
        _compare_media(device, folder, clips)
        launched = {name: count for name, count in build.LAUNCHES.items()
                    if count}
    if set(launched) != {"lut_apply"}:
        raise AssertionError(f"the images and compare path launched "
                             f"{launched}, expected lut_apply alone")
    _say("images-and-compare", kernels_launched=json.dumps(launched))
    torch.cuda.empty_cache()
    return launched


def _draw_face(canvas, center, scale: float):
    """The cartoon face of tests/test_face_detector.py (BGR), its
    480p sizes times ``scale``."""
    import cv2

    def s(value):
        return max(1, int(round(value * scale)))

    cx, cy = center
    ax, ay = s(110), s(150)
    cv2.ellipse(canvas, (cx, cy), (ax, ay), 0, 0, 360, (140, 170, 205), -1)
    eye_y = cy - int(0.27 * ay)
    dx = int(0.41 * ax)
    for ex in (cx - dx, cx + dx):
        cv2.ellipse(canvas, (ex, eye_y), (int(0.2 * ax), int(0.09 * ay)),
                    0, 0, 360, (255, 255, 255), -1)
        cv2.circle(canvas, (ex, eye_y), max(2, int(0.07 * ax)),
                   (40, 30, 30), -1)
    cv2.ellipse(canvas, (cx, cy + int(0.1 * ay)),
                (max(2, int(0.11 * ax)), int(0.2 * ay)), 0, 0, 360,
                (120, 150, 185), -1)
    cv2.ellipse(canvas, (cx, cy + int(0.47 * ay)),
                (int(0.41 * ax), int(0.12 * ay)), 0, 0, 180,
                (60, 60, 160), s(6))
    return canvas


def _face_clip(path: str, frames: int, fps: float, width: int, height: int,
               seed: int) -> str:
    """The cartoon face panning left to right over seeded noise."""
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    rng = np.random.default_rng(seed)
    for index in range(frames):
        frame = rng.integers(40, 90, (height, width, 3), np.uint8)
        cx = int(width * 0.35 + index * width * 0.3 / frames)
        writer.write(_draw_face(frame, (cx, height // 2), FACE_SCALE))
    writer.release()
    return path


def _tweak(u8: np.ndarray, rng) -> np.ndarray:
    """A seeded affine tweak: the stand-in for an external enhancer."""
    gain, offset = rng.uniform(0.85, 0.95), rng.uniform(8.0, 24.0)
    return np.clip(u8.astype(np.float32) * gain + offset, 0,
                   255).astype(np.uint8)


def _face_fix_job(device, folder: str, clip: str, detector) -> None:
    """Phase 15a: the Face Fix job on the 1080p clip with the real YuNet
    detector: prepare, enhanced anchors and 8n+1-trimmed LTX frames from
    the crops, finalize on the card and on the CPU (composited PNGs one
    level apart on <= 0.1% of values), the composite's ms a frame (CUDA
    events around all frames back to back) and the host cost of its
    lanczos4 weight matrices."""
    import cv2

    from vrgdg_tpu_torch.jobs import face_fix as ff
    from vrgdg_tpu_torch.ops import resize
    from vrgdg_tpu_torch.ops.paste_back import ellipse_composite
    from vrgdg_tpu_torch.runtime.profiling import StageTimer

    started = time.perf_counter()
    prepared = ff.prepare_face_fix({
        "video_path": clip, "project_folder": folder, "whole_scene": True,
        "confidence": 0.3, "repair_distance": "all",
        "rotation_assist": "off", "anchor_interval": 16}, detector=detector)
    prepare_s = time.perf_counter() - started
    manifest_path = prepared["manifest_path"]
    rng = np.random.default_rng(81)
    tweaked = os.path.join(folder, "enhanced")
    os.makedirs(tweaked, exist_ok=True)
    tail = 0
    for run in prepared["runs"]:
        for anchor in run["anchors"]:
            path = os.path.join(tweaked, os.path.basename(
                anchor["enhanced_path"]) + f"_{run['run_index']}.png")
            cv2.imwrite(path, _tweak(cv2.imread(anchor["source_path"]), rng))
            ff.accept_enhanced_anchor({
                "manifest_path": manifest_path,
                "run_index": run["run_index"], "order": anchor["order"],
                "image": path})
        ff.build_ltx_inputs({"manifest_path": manifest_path,
                             "run_index": run["run_index"]})
        crops = [c["crop_path"] for c in prepared["crops"]
                 if run["start_entry_index"] <= c["index"]
                 <= run["end_entry_index"]]
        kept = 8 * ((len(crops) - 1) // 8) + 1   # LTX's 8n+1 lengths
        images = []
        for index, crop in enumerate(crops[:kept]):
            path = os.path.join(tweaked, f"ltx_{run['run_index']}_{index}.png")
            cv2.imwrite(path, _tweak(cv2.imread(crop), rng))
            images.append(path)
        accepted = ff.accept_ltx_frames({
            "manifest_path": manifest_path, "run_index": run["run_index"],
            "images": images})
        tail += accepted["preserved_tail_frames"]

    payload = {"manifest_path": manifest_path, "feather": 18,
               "color_match": 0.65}
    before = resize._device_matrix.cache_info()
    timer = StageTimer()
    started = time.perf_counter()
    final = ff.finalize_face_fix(payload, device=device, timer=timer)
    finalize_s = time.perf_counter() - started
    after = resize._device_matrix.cache_info()
    with open(manifest_path, encoding="utf-8") as handle:
        entries = [e for e in json.load(handle)["entries"]
                   if e.get("composited_path")]
    card = {e["frame_number"]: cv2.imread(e["composited_path"])
            for e in entries}
    cpu_final = ff.finalize_face_fix(payload, device="cpu")
    worst = max(_share_apart(f"face-fix frame {e['frame_number']} card vs "
                             "CPU", card[e["frame_number"]],
                             cv2.imread(e["composited_path"]))
                for e in entries)
    frames, fps, (width, height) = FACE_CLIP
    out = _decode(final["output_video_path"])
    if out.shape != (frames, height, width, 3) or final["frames_repaired"] \
            != len(entries) or cpu_final["frames_repaired"] != len(entries):
        raise AssertionError(f"face-fix output: {out.shape}, {final}")

    # the composite alone: frames on the card, CUDA events around the loop
    pairs = []
    for entry in entries:
        pairs.append((ff.unit_float(cv2.imread(entry["original_path"])
                                    [..., ::-1], device),
                      ff.unit_float(cv2.imread(entry["ltx_frame_path"])
                                    [..., ::-1], device),
                      entry["crop_box"],
                      float(entry["composite_strength"])))

    def composite_all():
        for original, enhanced, box, strength in pairs:
            ellipse_composite(original, enhanced, box, 18, 0.65, strength)

    composite_ms = _cuda_ms(composite_all, 1) / len(pairs)
    # host cost of a miss of the weight-matrix cache: both lanczos4
    # matrices of a box built in numpy and uploaded
    build_ms = []
    for entry in entries:
        left, top, right, bottom = entry["crop_box"]
        begin = time.perf_counter()
        for dst in (bottom - top, right - left):
            torch.from_numpy(resize.resample_matrix.__wrapped__(
                ff.ENHANCE_SIZE, dst, "lanczos4")).to(device)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - begin) * 1e3)
    sizes = sorted({(e["crop_box"][3] - e["crop_box"][1],
                     e["crop_box"][2] - e["crop_box"][0]) for e in entries})
    del pairs
    stages = timer.seconds()
    _say("face-fix-job", frames=frames, size=f"{height}x{width}",
         detector="yunet", runs=prepared["face_run_count"],
         frames_repaired=final["frames_repaired"], ltx_tail_preserved=tail,
         prepare_s=f"{prepare_s:.3f}", finalize_s=f"{finalize_s:.3f}",
         composite_s=f"{stages['composite']:.3f}",
         encode_s=f"{stages['encode']:.3f}",
         composite_ms_per_frame=f"{composite_ms:.4f}",
         box_sizes=len(sizes), box_min=_label(sizes[0]),
         box_max=_label(sizes[-1]),
         matrix_cache_misses=after.misses - before.misses,
         matrix_cache_hits=after.hits - before.hits,
         matrix_build_ms_per_miss=f"{float(np.mean(build_ms)):.3f}",
         card_vs_cpu_max_share=f"{worst:.2e}<=1e-3",
         output=f"{out.shape[0]}x{out.shape[1]}x{out.shape[2]}")


def _memoized(detector):
    """``detector`` with its answers kept by frame and region, so that a
    second pass over the same frames repeats no detection."""
    import hashlib

    seen = {}

    def detect(frame, region):
        key = (hashlib.blake2b(np.ascontiguousarray(frame).tobytes(),
                               digest_size=16).digest(), tuple(region))
        if key not in seen:
            seen[key] = detector(frame, region)
        return seen[key]

    return detect


def _face_pipeline(device, clip: str, detector) -> None:
    """Phase 15b: ``run_face_fix_pipeline`` on the 36-frame 1080p batch on
    the card with an affine model, timed and broken down by the profiler;
    then prepare and composite on the card against the CPU (crops <= 2e-5,
    composite <= 1e-4)."""
    from vrgdg_tpu_torch.jobs import face_fix as ff
    from vrgdg_tpu_torch.jobs import face_fix_pipeline as ffp

    rgb = np.ascontiguousarray(_decode(clip)[..., ::-1])
    frames = ff.unit_float(rgb, device)
    gain, offset = np.random.default_rng(82).uniform((0.85, 0.02),
                                                     (0.95, 0.08))

    def model(crops, anchors, safe):
        return torch.clamp(crops * float(gain) + float(offset), 0.0, 1.0)

    kw = dict(detection_confidence=0.3, repair_distance="all",
              rotation_assist="off")
    detector = _memoized(detector)
    runs = []
    breakdown(lambda: runs.append(ffp.run_face_fix_pipeline(
        frames, model, detector=detector, **kw)), int(frames.shape[0]))
    out, masks, repaired = runs.pop()
    if tuple(out.shape) != tuple(frames.shape) or out.device != frames.device:
        raise AssertionError(f"pipeline output {tuple(out.shape)} on "
                             f"{out.device}")
    del out, masks

    # the checks below detect nothing anew: the memoized detector answers
    crops, anchors, context = ffp.prepare_face_pipeline(frames, detector,
                                                        **kw)
    cpu_frames = ff.unit_float(rgb, "cpu")
    cpu_crops, cpu_anchors, cpu_context = ffp.prepare_face_pipeline(
        cpu_frames, detector, **kw)
    if context.entries != cpu_context.entries or \
            context.anchor_indices != cpu_context.anchor_indices:
        raise AssertionError("pipeline tracking differs on the card")
    crop_err = max(_max_err(crops.cpu(), cpu_crops),
                   _max_err(anchors.cpu(), cpu_anchors))
    _check("pipeline crops card vs CPU", crop_err, BOUNDS["face_crops"])
    got = ffp.composite_repaired(model(crops, anchors, None), context)
    want = ffp.composite_repaired(model(cpu_crops, cpu_anchors, None),
                                  cpu_context)
    composite_err = max(_max_err(got[0].cpu(), want[0]),
                        _max_err(got[1].cpu(), want[1]))
    _check("pipeline composite card vs CPU", composite_err,
           BOUNDS["face_composite"])
    if got[2] != want[2] or got[2] != repaired:
        raise AssertionError(f"repaired {got[2]} / {want[2]} / {repaired}")
    _say("face-pipeline", frames=int(frames.shape[0]),
         size=_label(tuple(frames.shape[1:3])), repaired=repaired,
         anchors=len(context.anchor_indices),
         crop_err=f"{crop_err:.3g}<={BOUNDS['face_crops']:g}",
         composite_err=f"{composite_err:.3g}<={BOUNDS['face_composite']:g}")
    del frames, crops, anchors, context, got, want, cpu_frames, cpu_crops
    torch.cuda.empty_cache()


def _cli_json(argv: list[str]) -> dict:
    """One ``vrgdg_tpu_torch.cli`` command's JSON output."""
    import contextlib
    import io

    from vrgdg_tpu_torch import cli

    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        cli.main(argv)
    return json.loads(buffer.getvalue())


def _face_repair(device, folder: str, clip: str) -> None:
    """Phase 15c: the ``face-repair`` command's four actions on the 1080p
    clip, with a manual box and with YuNet; composite on the card against
    the CPU (one level on <= 0.1% of values); the rebuilt video's frame
    count exact."""
    import cv2

    frames, _, (width, height) = FACE_CLIP
    ranges, marked = FACE_REPAIR_RANGES
    for detector in ("manual", "yunet"):
        root = os.path.join(folder, f"repair_{detector}")
        flags = (["--manual-box", "600,430,180,220"] if detector == "manual"
                 else ["--detector", "auto", "--min-confidence", "0.3"])
        started = time.perf_counter()
        prepared = _cli_json(["face-repair", "prepare", "--video", clip,
                              "--ranges", ranges, "--out", root,
                              "--padding", "1.4", *flags,
                              "--device", str(device)])
        prepare_s = time.perf_counter() - started
        # every marked frame has its manual box; YuNet may miss a few
        crops = prepared["crops"]
        if crops != marked and (detector == "manual" or crops < marked - 4):
            raise AssertionError(f"face-repair prepare: {prepared}")
        with open(prepared["manifest_path"], encoding="utf-8") as handle:
            entries = json.load(handle)["entries"]
        fixed = os.path.join(root, "fixed")
        os.makedirs(fixed)
        rng = np.random.default_rng(83)
        for entry in entries:
            cv2.imwrite(os.path.join(fixed, entry["repaired_name"]),
                        _tweak(cv2.resize(cv2.imread(entry["crop"]),
                                          (512, 512)), rng))
        outputs = {}
        for dev in (str(device), "cpu"):
            started = time.perf_counter()
            result = _cli_json(["face-repair", "composite", "--manifest",
                                prepared["manifest_path"], "--repaired-dir",
                                fixed, "--out", os.path.join(root, dev),
                                "--color-match", "--device", dev])
            outputs[dev] = (result, time.perf_counter() - started)
        worst = 0.0
        for entry in entries:
            name = f"frame_{entry['frame']:06d}.png"
            worst = max(worst, _share_apart(
                f"face-repair {detector} {name} card vs CPU",
                cv2.imread(os.path.join(outputs[str(device)][0]["out_dir"],
                                        name)),
                cv2.imread(os.path.join(outputs["cpu"][0]["out_dir"], name))))
        sheet = _cli_json(["face-repair", "contact-sheet", "--manifest",
                           prepared["manifest_path"], "--repaired-dir",
                           outputs[str(device)][0]["out_dir"],
                           "--device", str(device)])
        video = _cli_json(["face-repair", "rebuild-video", "--manifest",
                           prepared["manifest_path"], "--fixed-dir",
                           outputs[str(device)][0]["out_dir"], "--out",
                           os.path.join(root, "preview.mp4"),
                           "--device", str(device)])
        decoded = _decode(video["output"])
        if (video["written"], video["replaced"]) != (frames, crops) or \
                decoded.shape != (frames, height, width, 3) or \
                sheet["pairs"] != crops:
            raise AssertionError(f"face-repair: {sheet} {video} "
                                 f"{decoded.shape}")
        _say("face-repair", detector=detector, ranges=ranges,
             crops=prepared["crops"], prepare_s=f"{prepare_s:.3f}",
             composite_card_s=f"{outputs[str(device)][1]:.3f}",
             composite_cpu_s=f"{outputs['cpu'][1]:.3f}",
             card_vs_cpu_max_share=f"{worst:.2e}<=1e-3",
             sheet_pairs=sheet["pairs"], rebuilt_frames=decoded.shape[0],
             replaced=video["replaced"])


def _paste_back_4k(device, reps=5) -> None:
    """Phase 15d: a 512 crop pasted into a 3840x2160 frame (bicubic,
    ellipse feather, colour match) on the card against the CPU."""
    from vrgdg_tpu_torch.ops.paste_back import paste_back

    (height, width), side, box = PASTE_4K
    rng = np.random.default_rng(84)
    frame = torch.from_numpy(rng.random((1, height, width, 3), np.float32))
    crop = torch.from_numpy(rng.random((1, side, side, 3), np.float32))
    data = ((width, height), box)
    want = paste_back(frame, crop, data)
    got = paste_back(frame.to(device), crop.to(device), data)
    err = max(_max_err(got[0].cpu(), want[0]), _max_err(got[1].cpu(),
                                                        want[1]))
    _check("paste_back 4K card vs CPU", err, BOUNDS["paste_back_4k"])
    on_card = frame.to(device), crop.to(device)
    ms = _cuda_ms(lambda: paste_back(*on_card, data), reps)
    _say("paste-back-4k", frame=f"{height}x{width}", crop=f"{side}x{side}",
         box=_label(box), err=f"{err:.3g}<={BOUNDS['paste_back_4k']:g}",
         ms=f"{ms:.4f}")


def _secondary_ops(device, reps=5) -> None:
    """Phase 15e: ``first_last_blend``, ``batch_reference_images``,
    ``build_msr_reference`` and ``switch_dynamic`` at 1080p and
    ``merge_lora`` at rank 16 into a 4096 x 4096 weight, on the card
    against the CPU, with CUDA-event ms."""
    from vrgdg_tpu_torch.ops import (grid, image_switch, lora,
                                     reference_images, schedules)

    rng = np.random.default_rng(85)

    def image(*shape):
        return torch.from_numpy(rng.random(shape, np.float32))

    height, width = SECONDARY
    small = (height * 2 // 3, width * 2 // 3)
    first, last = image(height, width, 3), image(*small, 3)
    args = (33, 0.05, 0.9, "smoothstep")
    err = _max_err(schedules.first_last_blend(first.to(device),
                                              last.to(device), *args).cpu(),
                   schedules.first_last_blend(first, last, *args))
    _check("first_last_blend card vs CPU", err, BOUNDS["bilinear"])
    on_card = first.to(device), last.to(device)
    ms = _cuda_ms(lambda: schedules.first_last_blend(*on_card, *args), reps)
    _say("first-last-blend", frames=33, size=_label(SECONDARY),
         last=_label(small), err=f"{err:.3g}<={BOUNDS['bilinear']:g}",
         ms=f"{ms:.4f}")

    refs = [image(1, height, width, 3), image(2, *small, 4),
            image(1, height, height * 4 // 3, 3)]
    err = _max_err(reference_images.batch_reference_images(
        [r.to(device) for r in refs]).cpu(),
        reference_images.batch_reference_images(refs))
    _check("batch_reference_images card vs CPU", err, BOUNDS["bilinear"])
    on_card = [r.to(device) for r in refs]
    ms = _cuda_ms(lambda: reference_images.batch_reference_images(on_card),
                  reps)
    _say("batch-reference-images", images=len(refs),
         out=_label((4, height, width, 4)),
         err=f"{err:.3g}<={BOUNDS['bilinear']:g}", ms=f"{ms:.4f}")

    subjects = [image(height, width, 3).numpy(),
                image(width * 2 // 3, height * 2 // 3, 3).numpy()]
    started = time.perf_counter()
    got = grid.build_msr_reference(subjects, None, width, height,
                                   device=device)
    msr_s = time.perf_counter() - started
    want = grid.build_msr_reference(subjects, None, width, height,
                                    device="cpu")
    err = float(np.max(np.abs(got - want)))
    _check("build_msr_reference card vs CPU", err, BOUNDS["lanczos4"])
    _say("msr-reference", frames=got.shape[0], size=_label(SECONDARY),
         err=f"{err:.3g}<={BOUNDS['lanczos4']:g}",
         wall_ms=f"{msr_s * 1e3:.3f}")

    slots = {1: image(2, height, width, 3), 3: image(3, height, width, 3)}
    for spec, blank in (("3,1", False), ("all", False), ("0", True)):
        got = image_switch.switch_dynamic(
            spec, 4, {k: v.to(device) for k, v in slots.items()}, blank,
            device=device)
        want = image_switch.switch_dynamic(spec, 4, slots, blank,
                                           device="cpu")
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"switch_dynamic {spec!r} differs")
    _say("switch-dynamic", specs="3,1|all|0(blank)", agreement="exact")

    rows, cols, rank = LORA
    weight = torch.from_numpy(rng.standard_normal((rows, cols), np.float32))
    pair = {"down": rng.standard_normal((rank, cols), np.float32),
            "up": rng.standard_normal((rows, rank), np.float32) * 0.05,
            "alpha": 8.0}
    want = lora.merge_lora({"w": weight}, {"w": pair}, 0.8)["w"]
    on_card = {"w": weight.to(device)}
    got = lora.merge_lora(on_card, {"w": pair}, 0.8)["w"]
    relative = _max_err(got.cpu(), want) / float(want.abs().max())
    _check("merge_lora card vs CPU (relative)", relative,
           BOUNDS["lora_relative"])
    flags = torch.backends.cuda.matmul
    flags.allow_tf32 = True
    try:
        with_tf32 = lora.merge_lora(on_card, {"w": pair}, 0.8)["w"]
    finally:
        flags.allow_tf32 = False
    if not torch.equal(with_tf32, got):
        raise AssertionError("merge_lora changed with TF32 allowed")
    ms = _cuda_ms(lambda: lora.merge_lora(on_card, {"w": pair}, 0.8), reps)
    _say("merge-lora", weight=f"{rows}x{cols}", rank=rank,
         relative_err=f"{relative:.3g}<={BOUNDS['lora_relative']:g}",
         tf32_allowed="bit-identical", ms=f"{ms:.4f}")


def face_repair_and_secondary_ops(device) -> None:
    """Phase 15: the Face Fix job, its pipeline, targeted face repair, a
    4K paste-back and the secondary ops.  No TPU kernel lies on these
    paths, so the run (counts set to 0 just before, read just after) must
    launch none of the six kernels."""
    import cv2

    from vrgdg_tpu_torch.jobs import face_fix as ff
    from vrgdg_tpu_torch.kernels import build

    if getattr(cv2, "FaceDetectorYN", None) is None and \
            getattr(cv2, "FaceDetectorYN_create", None) is None:
        raise AssertionError("cv2 has no FaceDetectorYN: the face phases "
                             "need YuNet")
    detector = ff.load_default_detector()
    frames, fps, (width, height) = FACE_CLIP
    with tempfile.TemporaryDirectory() as folder:
        clip = _face_clip(os.path.join(folder, "face.mp4"), frames, fps,
                          width, height, 80)
        build.reset_launch_counts()
        _face_fix_job(device, os.path.join(folder, "job"), clip, detector)
        _face_pipeline(device, clip, detector)
        _face_repair(device, folder, clip)
        _paste_back_4k(device)
        _secondary_ops(device)
        launched = {name: count for name, count in build.LAUNCHES.items()
                    if count}
    if launched:
        raise AssertionError(f"the face and secondary-op paths launched "
                             f"{launched}")
    _say("face-and-secondary-ops", kernels_launched=0)
    torch.cuda.empty_cache()


def _counted(run) -> tuple[object, dict]:
    """``run()``'s result and the kernel launches it made, the counts set
    to 0 just before and read just after."""
    from vrgdg_tpu_torch.kernels import build

    build.reset_launch_counts()
    result = run()
    torch.cuda.synchronize()
    return result, {k: v for k, v in build.LAUNCHES.items() if v}


def _expect(label: str, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"{label} launched {counts}, expected {want}")


def _add(total: dict, counts: dict) -> None:
    for name, count in counts.items():
        total[name] = total.get(name, 0) + count


def _parallel_grades(device, config, lut, ref_stats, card: str,
                     launches: dict) -> None:
    """Phase 16's lines 1-2: the fused grade_on_mesh at 4K x 3 on two
    mesh entries of the card, and the eager stack height- and
    frame-sharded at 1080p x 2."""
    from vrgdg_tpu_torch.core.params import AdjustSettings
    from vrgdg_tpu_torch.ops.grade import grade
    from vrgdg_tpu_torch.parallel import grade_on_mesh, make_mesh

    count, height, width = PARALLEL_FUSED
    frames = _frames((count, height, width), 1600, device)
    mesh = make_mesh(devices=[device] * 2)
    run = lambda: grade_on_mesh(frames, config, mesh, lut=lut,  # noqa: E731
                                ref_stats=ref_stats)
    sharded, counts = _counted(run)
    _expect("fused grade_on_mesh", counts,
            {"grade_phase1": 2, "grade_phase2": 2})
    _add(launches, counts)
    single = grade(frames, config, lut=lut, ref_stats=ref_stats)
    if sharded.shape != frames.shape or not torch.equal(sharded, single):
        raise AssertionError("fused grade_on_mesh differs from one device")
    mesh_ms = _cuda_ms(run, 5)
    single_ms = _cuda_ms(lambda: grade(frames, config, lut=lut,
                                       ref_stats=ref_stats), 5)
    _say("parallel-fused", frames=f"{count}x{height}x{width}",
         mesh="[cuda:0]x2", padded_to=4, trimmed_to=count,
         vs_one_device="bit-identical", grain="on",
         grade_phase1_launches=counts.get("grade_phase1", 0),
         grade_phase2_launches=counts.get("grade_phase2", 0),
         mesh_ms=f"{mesh_ms:.4f}", one_device_ms=f"{single_ms:.4f}",
         note="sharding_cost_on_one_card_not_a_multi_card_speedup",
         card=f"'{card}'")
    del frames, sharded, single

    eager = dataclasses.replace(config, fused_mode="eager",
                                adjust=AdjustSettings.normalize({
                                    **FLAGSHIP["adjust"], "clarity": 30.0,
                                    "sharpen": 10.0}))
    count, height, width = PARALLEL_EAGER
    frames = _frames((count, height, width), 1601, device)
    single = grade(frames, eager, lut=lut, ref_stats=ref_stats)
    spatial = grade_on_mesh(frames, eager, make_mesh(devices=[device] * 2,
                                                     spatial=2),
                            lut=lut, ref_stats=ref_stats, spatial=True)
    err = _max_err(spatial, single)
    _check("spatial eager grade", err, BOUNDS["spatial"])
    dp = grade_on_mesh(frames, eager, mesh, lut=lut, ref_stats=ref_stats)
    if not torch.equal(dp, single):
        raise AssertionError("frame-sharded eager grade differs from one "
                             "device")
    _say("parallel-spatial", frames=f"{count}x{height}x{width}",
         mesh="data=1,space=2", stack="flagship+clarity30+sharpen10",
         grain="eager", err=f"{err:.3g}<={BOUNDS['spatial']:g}",
         frame_dp="bit-identical")
    del frames, single, spatial, dp
    torch.cuda.empty_cache()


def _parallel_enhance(device, launches: dict) -> None:
    """Phase 16's line 3: the enhancer step on two mesh entries of the
    card, frame-sharded then height-sharded, and a height shard's
    ``film_grain`` against the whole frame's rows."""
    from vrgdg_tpu_torch.core.params import EnhancerSettings
    from vrgdg_tpu_torch.jobs import enhancer
    from vrgdg_tpu_torch.kernels.grain_cuda import film_grain_kernel
    from vrgdg_tpu_torch.parallel import make_mesh

    settings = EnhancerSettings.normalize(ENHANCE)
    (count, src_h, src_w), (out_w, out_h) = PARALLEL_ENHANCE, ENHANCE_SIZE
    frames = np.random.default_rng(1602).integers(
        0, 256, (count, src_h, src_w, 3), np.uint8)
    single = enhancer.apply_effects_batch(frames, settings, out_h, out_w, 5,
                                          device=device)
    dp, counts = _counted(lambda: enhancer.apply_effects_batch(
        frames, settings, out_h, out_w, 5,
        mesh=make_mesh(devices=[device] * 2)))
    _expect("enhance step, data=2", counts, {"film_grain": 2})
    _add(launches, counts)
    if dp.shape != single.shape or not np.array_equal(dp, single):
        raise AssertionError("frame-sharded enhance step differs from one "
                             "device")
    spatial, counts = _counted(lambda: enhancer.apply_effects_batch(
        frames, settings, out_h, out_w, 5,
        mesh=make_mesh(devices=[device] * 2, spatial=2)))
    _expect("enhance step, space=2", counts, {"film_grain": 2})
    _add(launches, counts)
    err = float(np.abs(spatial - single).max())
    _check("spatial enhance step", err, BOUNDS["spatial"])
    del dp, spatial, single

    whole_frames = _frames((1, out_h, out_w), 1603, device)
    args = (FLAGSHIP["grain_intensity"], FLAGSHIP["saturation_mix"],
            FLAGSHIP["seed"])
    whole = film_grain_kernel(whole_frames, *args, frame_start=9)
    half = out_h // 2
    shard = film_grain_kernel(whole_frames[:, half:].contiguous(), *args,
                              frame_start=9, row_start=half,
                              frame_height=out_h)
    if not torch.equal(shard, whole[:, half:]):
        raise AssertionError("a height shard's film_grain differs from the "
                             "whole frame's rows")
    _say("parallel-enhance", frames=count,
         size=f"{src_h}x{src_w}->{out_h}x{out_w}",
         frame_dp="bit-identical", film_grain_launches_dp=2,
         space2_err=f"{err:.3g}<={BOUNDS['spatial']:g}",
         film_grain_launches_space2=2,
         film_grain_rows=f"[{half},{out_h})_bit-identical")
    del whole_frames, whole, shard
    torch.cuda.empty_cache()


def _parallel_nccl(device) -> None:
    """Phase 16's line 4: a one-rank NCCL group (in a process of its own,
    with a time limit): ``initialize_distributed`` on the card, a global
    mesh, ``grade_on_mesh`` through the NCCL all-gather against one
    device, then the group destroyed."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    started = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.parallel",
         f"127.0.0.1:{port}", "1", "0"], capture_output=True, text=True,
        timeout=180, cwd=os.path.dirname(os.path.abspath(__file__)))
    line = (done.stdout.strip().splitlines() or [""])[-1]
    if done.returncode != 0 or "GRADE OK" not in line \
            or "backend=nccl" not in line:
        raise AssertionError(f"NCCL self-check failed (exit "
                             f"{done.returncode}): {line}\n"
                             f"{done.stderr[-2000:]}")
    _say("parallel-nccl", world_size=1, result=f"'{line}'",
         all_gather="bit-identical",
         seconds=f"{time.perf_counter() - started:.2f}")


def _parallel_scheduler(device) -> None:
    """Phase 16's line 5: two ``enhance --shard-index`` processes share
    the card on a seeded 120-frame 1080p clip at 12 fps (two segments);
    their joined output against an in-process ``render_job``'s, byte for
    byte."""
    from vrgdg_tpu_torch.entry import (SCHEDULER_SETTINGS,
                                       run_scheduler_workers)
    from vrgdg_tpu_torch.jobs import enhancer

    frames, fps, (width, height) = SCHEDULER_CLIP
    with tempfile.TemporaryDirectory() as folder:
        clip = _write_clip(os.path.join(folder, "clip.mp4"), frames, fps,
                           width, height, 1604)
        started = time.perf_counter()
        final = run_scheduler_workers(clip, os.path.join(folder, "dist"),
                                      str(device), timeout=300)
        shards_s = time.perf_counter() - started
        registry = enhancer.JobRegistry()
        started = time.perf_counter()
        enhancer.render_job("single", {"source_path": clip,
                                       "settings": dict(SCHEDULER_SETTINGS)},
                            registry=registry,
                            base_folder=os.path.join(folder, "single"),
                            device=device)
        single_s = time.perf_counter() - started
        snap = registry.snapshot("single")
        if snap.get("status") != "complete":
            raise AssertionError(f"render_job: {snap.get('error')}")
        with open(final["output_path"], "rb") as a, \
                open(snap["output_path"], "rb") as b:
            if a.read() != b.read():
                raise AssertionError("two-process scheduler output differs "
                                     "from render_job's")
    _say("parallel-scheduler", frames=frames, fps_in=fps,
         size=f"{width}x{height}", segments=final["total_segments"],
         processes=2, output="byte-identical",
         two_process_wall_s=f"{shards_s:.3f}",
         one_process_wall_s=f"{single_s:.3f}")


def parallel_phase(device, config, lut, ref_stats, card: str) -> dict:
    """Phase 16: the mesh, the enhancer on a mesh, NCCL at world size 1,
    the segment scheduler and the dry run, on mesh entries that all name
    the card (the shard arithmetic, not a multi-card speed-up); returns
    the launches of the counted mesh runs."""
    from vrgdg_tpu_torch.entry import dryrun_multichip

    started = time.perf_counter()
    launches: dict = {}
    _parallel_grades(device, config, lut, ref_stats, card, launches)
    _parallel_enhance(device, launches)
    _parallel_nccl(device)
    _parallel_scheduler(device)
    result = dryrun_multichip(4, devices=[device] * 4)
    _say("parallel-dryrun", devices="[cuda:0]x4",
         result=json.dumps(result, separators=(",", ":")),
         phase_s=f"{time.perf_counter() - started:.2f}")
    return launches


class _Server:
    """Phase 17's app (``vrgdg_tpu_torch.server``, aiohttp) on 127.0.0.1
    in this process, its event loop on a thread of its own, so
    ``kernels/build.py``'s launch counts see its requests; :meth:`call`
    sends one real socket request and prints its line."""

    def __init__(self, device, base: str):
        import asyncio
        import threading

        from aiohttp import web

        from vrgdg_tpu_torch import server

        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(server.create_app(base_folder=base,
                                                      device=device))
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        port = self.runner.addresses[0][1]
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{port}"
        self.calls = 0

    def call(self, method: str, path: str, json_body=None, params=None,
             data: bytes | None = None, headers=None, status: int = 200,
             **fields):
        """``(status, body, wall ms)``; fails unless the status is
        ``status`` and a JSON body says ``ok: true`` (``ok: false`` where a
        refusal is asked for)."""
        import urllib.error
        import urllib.parse
        import urllib.request

        url = self.url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = dict(headers or {})
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        request = urllib.request.Request(url, data=data, method=method,
                                         headers=headers)
        started = time.perf_counter()
        try:
            with urllib.request.urlopen(request, timeout=600) as response:
                got, raw = response.status, response.read()
                kind = response.headers.get("Content-Type", "")
        except urllib.error.HTTPError as exc:
            got, raw = exc.code, exc.read()
            kind = exc.headers.get("Content-Type", "")
        wall_ms = (time.perf_counter() - started) * 1e3
        self.calls += 1
        body = json.loads(raw) if kind.startswith("application/json") \
            else raw
        if got != status or (isinstance(body, dict)
                             and body.get("ok") is not (status < 400)):
            raise AssertionError(f"{method} {path}: {got} {str(body)[:2000]}")
        _say("server", request=f"'{method} {path}'", status=got,
             wall_ms=f"{wall_ms:.3f}", **fields)
        return got, body, wall_ms

    def close(self) -> None:
        import asyncio

        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)
        self.loop.close()


def _multipart(name: str, filename: str, data: bytes,
               fields: dict | None = None) -> tuple[bytes, str]:
    """A multipart body: the text ``fields``, then one file part."""
    return _multipart_files([(name, filename, data)], fields)


def _multipart_files(files, fields: dict | None = None) -> tuple[bytes, str]:
    """A multipart body: the text ``fields``, then the file parts
    ``(name, filename, bytes)``."""
    boundary = "vrgdgsmoke" + "7" * 16
    body = b"".join(
        (f"--{boundary}\r\nContent-Disposition: form-data; "
         f'name="{key}"\r\n\r\n{value}\r\n').encode()
        for key, value in (fields or {}).items())
    for name, filename, data in files:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"; filename="{filename}"\r\n'
                 "Content-Type: application/octet-stream\r\n\r\n"
                 ).encode() + data + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def _click_track(path: str) -> str:
    """A seeded stereo click track (decaying noise bursts on the beat) as
    a 16-bit WAV."""
    import wave

    seconds, rate, bpm = SERVER_CLICKS
    rng = np.random.default_rng(1717)
    n = int(seconds * rate)
    y = rng.normal(0.0, 0.003, n)
    burst = np.exp(-np.linspace(0.0, 6.0, int(0.02 * rate)))
    for start in np.arange(0.0, seconds, 60.0 / bpm):
        first = int(start * rate)
        end = min(n, first + burst.size)
        y[first:end] += 0.9 * burst[:end - first] * rng.normal(
            0.0, 1.0, end - first)
    pcm = (np.clip(y, -1, 1) * 32767).round().astype("<i2")
    with wave.open(path, "wb") as handle:
        handle.setnchannels(2)
        handle.setsampwidth(2)
        handle.setframerate(rate)
        handle.writeframes(np.repeat(pcm[:, None], 2, axis=1).tobytes())
    return path


def _wait_job(srv: _Server, job_id: str, limit_s: float = 300.0) -> dict:
    """Poll ``render/status`` (quietly) until the job ends."""
    import urllib.request

    deadline = time.perf_counter() + limit_s
    url = f"{srv.url}/vrgdg/video_enhancer/render/status?job_id={job_id}"
    while time.perf_counter() < deadline:
        with urllib.request.urlopen(url, timeout=60) as response:
            job = json.loads(response.read())["job"]
        if job["status"] in {"complete", "failed", "canceled"}:
            if job["status"] != "complete":
                raise AssertionError(f"render {job_id}: {job['status']}: "
                                     f"{job.get('error')}")
            return job
        time.sleep(0.1)
    raise AssertionError(f"render {job_id} did not end in {limit_s} s")


def _same_frames(label: str, a: str, b: str) -> None:
    if not np.array_equal(_decode(a), _decode(b)):
        raise AssertionError(f"{label}: outputs differ")


def _server_grade(srv, device, folder, clip,
                  reference) -> tuple[dict, str, dict]:
    """Phase 17's check 2: the fused ``grade_video`` by request against
    the in-process applier, then the ``xla`` name, which launches neither
    grade kernel: its eager LUT launches ``lut_apply`` once a batch."""
    from vrgdg_tpu_torch.api import appliers

    payload = {"input": clip, "lut": FLAGSHIP["lut_name"],
               "strength": FLAGSHIP["lut_strength"],
               "adjust": FLAGSHIP["adjust"], "reference_image": reference,
               "match_strength": FLAGSHIP["match_strength"],
               "sharpen_strength": FLAGSHIP["sharpen_strength"],
               "grain_intensity": FLAGSHIP["grain_intensity"],
               "saturation_mix": FLAGSHIP["saturation_mix"],
               "seed": FLAGSHIP["seed"], "batch_size": SERVER_GRADE_BATCH,
               "preserve_audio": False}
    out = os.path.join(folder, "graded_pallas.mp4")
    frames = SERVER_GRADE_CLIP[0]
    batches = -(-frames // SERVER_GRADE_BATCH)
    (_, body, _), counts = _counted(lambda: srv.call(
        "POST", "/vrgdg/music_builder/post_process/grade_video",
        {**payload, "fused_mode": "pallas", "output": out},
        mode="pallas", frames=frames, batch=SERVER_GRADE_BATCH))
    result = body["result"]
    _expect("grade_video pallas", counts,
            {"grade_phase1": batches, "grade_phase2": batches})
    lone = appliers.grade_video(
        clip, os.path.join(folder, "graded_inproc.mp4"),
        lut_name=FLAGSHIP["lut_name"], lut_strength=FLAGSHIP["lut_strength"],
        adjust=FLAGSHIP["adjust"], reference_image=reference,
        match_strength=FLAGSHIP["match_strength"],
        sharpen_strength=FLAGSHIP["sharpen_strength"],
        grain_intensity=FLAGSHIP["grain_intensity"],
        saturation_mix=FLAGSHIP["saturation_mix"], seed=FLAGSHIP["seed"],
        batch_size=SERVER_GRADE_BATCH, preserve_audio=False,
        fused_mode="fused", device=device)
    launches = dict(counts)
    _same_frames("grade_video by request vs in process", out,
                 lone["output"])
    if (result["processed_frames"], result["fused_mode"]) != (frames,
                                                              "pallas"):
        raise AssertionError(f"grade_video result: {result}")
    _say("server-grade", mode="pallas", launches=json.dumps(counts),
         elapsed_s=f"{result['elapsed_seconds']:.3f}",
         stage_seconds=json.dumps({k: round(v, 3) for k, v in
                                   result["stage_seconds"].items()},
                                  separators=(",", ":")),
         in_process_elapsed_s=f"{lone['elapsed_seconds']:.3f}",
         vs_in_process="byte-identical")
    (_, body, _), counts = _counted(lambda: srv.call(
        "POST", "/vrgdg/music_builder/post_process/grade_video",
        {**payload, "fused_mode": "xla",
         "output": os.path.join(folder, "graded_xla.mp4")}, mode="xla"))
    _expect("grade_video xla", counts, {"lut_apply": batches})
    _say("server-grade", mode="xla", launches=json.dumps(counts),
         elapsed_s=f"{body['result']['elapsed_seconds']:.3f}")
    return payload, out, launches


def _render_batches() -> int:
    """Batches of phase 17's render: the 24 frames at the auto batch of
    its 4K output."""
    from vrgdg_tpu_torch.core.params import auto_batch_size

    return -(-SERVER_RENDER_CLIP[0] // auto_batch_size(*ENHANCE_SIZE))


def _server_enhancer(srv, device, folder, clip) -> tuple[dict, dict, dict]:
    """Phase 17's check 4: upload, load, preview (one ``film_grain``
    launch), a render by request against an in-process ``start_render``
    of the same payload (one launch a batch), the media route's
    containment and an unknown job's 404."""
    from vrgdg_tpu_torch.jobs import enhancer as enh
    from vrgdg_tpu_torch.runtime import video_io

    with open(clip, "rb") as handle:
        data, content_type = _multipart("video", "server clip.mp4",
                                        handle.read())
    _, body, _ = srv.call("POST", "/vrgdg/video_enhancer/upload", data=data,
                          headers={"Content-Type": content_type},
                          bytes=len(data))
    uploaded = body["video"]["path"]
    with open(uploaded, "rb") as a, open(clip, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("the uploaded file differs from the clip")
    _, body, _ = srv.call("POST", "/vrgdg/video_enhancer/load",
                          {"path": uploaded})
    frames, _, (width, height) = SERVER_RENDER_CLIP
    if (body["video"]["frame_count"], body["video"]["width"]) != (frames,
                                                                 width):
        raise AssertionError(f"load: {body['video']}")
    settings = {**ENHANCE, "preserve_audio": False,
                "output_name": "served.mp4"}
    (_, body, _), counts = _counted(lambda: srv.call(
        "POST", "/vrgdg/video_enhancer/preview",
        {"source_path": uploaded, "timestamp": 0.5, "settings": settings}))
    _expect("enhancer preview", counts, {"film_grain": 1})
    launches = dict(counts)
    out_w, out_h = ENHANCE_SIZE
    if (body["output_width"], body["output_height"]) != (out_w, out_h):
        raise AssertionError(f"preview: {body}")
    payload = {"source_path": uploaded, "settings": settings}
    batches = _render_batches()

    def render():
        _, started, _ = srv.call("POST", "/vrgdg/video_enhancer/render/start",
                                 payload)
        return _wait_job(srv, started["job"]["job_id"])

    job, counts = _counted(render)
    _expect("render by request", counts, {"enhance_step": batches})
    _add(launches, counts)
    srv.call("GET", "/vrgdg/video_enhancer/render/status",
             params={"job_id": job["job_id"]}, job_status=job["status"],
             stage_seconds_total=json.dumps(
                 {k: round(v, 3) for k, v in
                  job["stage_seconds_total"].items()},
                 separators=(",", ":")))
    registry = enh.JobRegistry()
    lone = enh.start_render(payload, registry=registry,
                            base_folder=os.path.join(folder, "inproc"),
                            device=device)
    deadline = time.perf_counter() + 600
    while registry.snapshot(lone["job_id"]).get("status") in {
            "queued", "running", "encoding"}:
        if time.perf_counter() > deadline:
            raise AssertionError("the in-process render did not end")
        time.sleep(0.1)
    lone = registry.snapshot(lone["job_id"])
    if lone.get("status") != "complete":
        raise AssertionError(f"in-process render: {lone.get('error')}")
    _same_frames("render by request vs in process", job["output_path"],
                 lone["output_path"])
    meta = video_io.probe_video(job["output_path"])
    if (meta["frame_count"], meta["width"], meta["height"]) != (
            frames, out_w, out_h):
        raise AssertionError(f"render output: {meta}")
    _say("server-render", frames=frames, size=f"{width}x{height}->"
         f"{out_w}x{out_h}", film_grain_launches=counts.get("film_grain", 0),
         vs_in_process="byte-identical",
         stage_seconds_total=json.dumps(
             {k: round(v, 3) for k, v in job["stage_seconds_total"].items()},
             separators=(",", ":")))
    _, served, _ = srv.call("GET", "/vrgdg/video_enhancer/media",
                            params={"path": job["output_path"]})
    with open(job["output_path"], "rb") as handle:
        if served != handle.read():
            raise AssertionError("the media route served other bytes")
    srv.call("GET", "/vrgdg/video_enhancer/media",
             params={"path": "/etc/passwd"}, status=404)
    srv.call("GET", "/vrgdg/video_enhancer/render/status",
             params={"job_id": "no_such_job"}, status=404)
    return payload, job, launches


def _server_concurrent(srv, folder, grade, graded, render, rendered) -> dict:
    """Phase 17's check 5: a second render and, while it runs, the fused
    ``grade_video`` from another request thread; both outputs against
    their lone runs."""
    import threading

    from vrgdg_tpu_torch.kernels import build

    build.reset_launch_counts()
    _, body, _ = srv.call("POST", "/vrgdg/video_enhancer/render/start",
                          {**render, "settings": {**render["settings"],
                                                  "output_name": "again.mp4"}})
    job_id = body["job"]["job_id"]
    states = {}
    out = os.path.join(folder, "graded_concurrent.mp4")

    def grade_request():
        # send the grade once the render is under way
        deadline = time.perf_counter() + 60
        while _job_status(srv, job_id) == "queued" \
                and time.perf_counter() < deadline:
            time.sleep(0.02)
        states["render_before"] = _job_status(srv, job_id)
        try:
            srv.call("POST", "/vrgdg/music_builder/post_process/grade_video",
                     {**grade, "fused_mode": "pallas", "output": out},
                     mode="pallas", concurrent="with-render")
        except AssertionError as exc:
            states["error"] = exc
        states["render_after"] = _job_status(srv, job_id)

    worker = threading.Thread(target=grade_request)
    worker.start()
    worker.join(timeout=600)
    job = _wait_job(srv, job_id)
    torch.cuda.synchronize()
    if "error" in states:
        raise states["error"]
    if worker.is_alive() or "render_after" not in states:
        raise AssertionError("the concurrent grade request did not finish")
    counts = {k: v for k, v in build.LAUNCHES.items() if v}
    batches = -(-SERVER_GRADE_CLIP[0] // SERVER_GRADE_BATCH)
    _expect("render and grade at once", counts,
            {"grade_phase1": batches, "grade_phase2": batches,
             "enhance_step": _render_batches()})
    if states["render_before"] == "complete":
        raise AssertionError("the render ended before the grade started")
    _same_frames("concurrent grade vs alone", out, graded)
    _same_frames("concurrent render vs alone", job["output_path"],
                 rendered["output_path"])
    _say("server-concurrent", render_at_grade_start=states["render_before"],
         render_at_grade_end=states["render_after"],
         launches=json.dumps(counts), outputs="byte-identical")
    return counts


def _job_status(srv, job_id: str) -> str:
    import urllib.request

    url = f"{srv.url}/vrgdg/video_enhancer/render/status?job_id={job_id}"
    with urllib.request.urlopen(url, timeout=60) as response:
        return json.loads(response.read())["job"]["status"]


def _serve_command(kind: str) -> None:
    """Phase 17's check 10: ``python -m vrgdg_tpu_torch.cli serve`` in a
    process of its own answers ``/vrgdg/health`` with the card's name
    within SERVE_START_LIMIT_S, then is stopped."""
    import socket
    import urllib.request

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    with tempfile.TemporaryDirectory() as folder:
        started = time.perf_counter()
        process = subprocess.Popen(
            [sys.executable, "-m", "vrgdg_tpu_torch.cli", "serve", "--port",
             str(port)], cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "VRGDG_TPU_OUTPUT": folder},
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        try:
            body = None
            while time.perf_counter() - started < SERVE_START_LIMIT_S:
                if process.poll() is not None:
                    raise AssertionError(
                        f"serve exited {process.returncode}: "
                        f"{process.stderr.read().decode()[-2000:]}")
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/vrgdg/health",
                            timeout=10) as response:
                        body = json.loads(response.read())
                    break
                except OSError:
                    time.sleep(0.25)
            answered = time.perf_counter() - started
            if body is None or not body.get("ok") \
                    or kind not in body.get("backend", ""):
                raise AssertionError(f"serve did not answer /vrgdg/health "
                                     f"with the card in "
                                     f"{SERVE_START_LIMIT_S} s: {body}")
        finally:
            process.terminate()
            try:
                process.wait(timeout=30)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait(timeout=30)
    _say("server-serve", command="'python -m vrgdg_tpu_torch.cli serve'",
         health_s=f"{answered:.3f}", limit_s=SERVE_START_LIMIT_S,
         backend=f"'{body['backend']}'", stopped=process.returncode)


def server_phase(device, kind: str) -> dict:
    """Phase 17: the port's HTTP server on the card, driven by requests;
    returns the launches of its counted runs (the fused grade request, the
    enhancer preview and render, and the concurrent pair)."""
    from vrgdg_tpu_torch.api import appliers

    started = time.perf_counter()
    launches: dict = {}
    srv = None
    with tempfile.TemporaryDirectory() as folder:
        try:
            srv = _Server(device, os.path.join(folder, "served"))
            frames, fps, (width, height) = SERVER_GRADE_CLIP
            grade_clip = _write_clip(os.path.join(folder, "grade.mp4"),
                                     frames, fps, width, height, 1701)
            frames, fps, (width, height) = SERVER_RENDER_CLIP
            render_clip = _write_clip(os.path.join(folder, "render.mp4"),
                                      frames, fps, width, height, 1702)
            other_clip = _write_clip(os.path.join(folder, "other.mp4"),
                                     frames, fps, width, height, 1703)
            (still_h, still_w), _ = STILL_SIZES
            still = _still(os.path.join(folder, "still.png"), still_h,
                           still_w, 1704)
            reference = _still(os.path.join(folder, "reference.png"), 64, 64,
                               1705)
            wav = _click_track(os.path.join(folder, "clicks.wav"))

            # 1: health, catalog, panel
            _, body, _ = srv.call("GET", "/vrgdg/health")
            if kind not in body["backend"]:
                raise AssertionError(f"health backend: {body['backend']}")
            _, body, _ = srv.call("GET", "/vrgdg/music_builder/luts")
            if len(body["luts"]) != 18:
                raise AssertionError(f"{len(body['luts'])} LUTs, not 18")
            _, page, _ = srv.call("GET", "/vrgdg/ui")
            if b"/vrgdg/" not in page:
                raise AssertionError("the panel page is not served")
            # 2: the fused grade by request
            grade, graded, counts = _server_grade(srv, device, folder,
                                                  grade_clip, reference)
            _add(launches, counts)
            # 3: a 4K still through the LUT route
            out = os.path.join(folder, "lut_route.png")
            _, body, _ = srv.call(
                "POST", "/vrgdg/music_builder/luts/apply_image",
                {"input": still, "lut": FLAGSHIP["lut_name"],
                 "strength": FLAGSHIP["lut_strength"], "output": out})
            lone = appliers.apply_lut_to_image(
                still, FLAGSHIP["lut_name"],
                os.path.join(folder, "lut_inproc.png"),
                FLAGSHIP["lut_strength"], device=device)
            with open(out, "rb") as a, open(lone["output"], "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("apply_image by request differs")
            _say("server-image", size=f"{still_h}x{still_w}",
                 elapsed_s=f"{body['result']['elapsed_seconds']:.3f}",
                 stage_seconds=json.dumps(
                     {k: round(v, 3) for k, v in
                      body["result"]["stage_seconds"].items()},
                     separators=(",", ":")),
                 vs_in_process="byte-identical")
            # 4: the enhancer
            render, rendered, counts = _server_enhancer(srv, device, folder,
                                                        render_clip)
            _add(launches, counts)
            # 5: two request threads on one card
            _add(launches, _server_concurrent(srv, folder, grade, graded,
                                              render, rendered))
            # 6: compare
            _, body, _ = srv.call(
                "POST", "/vrgdg/compare/video",
                {"input_a": render_clip, "input_b": other_clip,
                 "mode": "side_by_side", "batch_size": 8},
                mode="side_by_side")
            result = body["result"]
            shape = _decode(result["output"]).shape
            if shape[:3] != (SERVER_RENDER_CLIP[0], height, 2 * width + 2):
                raise AssertionError(f"compare/video: {shape}")
            _say("server-compare", mode="side_by_side",
                 size=f"{shape[1]}x{shape[2]}",
                 processed_fps=f"{result['processed_fps']:.2f}",
                 stage_seconds=json.dumps(
                     {k: round(v, 3) for k, v in
                      result["stage_seconds"].items()},
                     separators=(",", ":")))
            _, body, _ = srv.call(
                "POST", "/vrgdg/compare/grid",
                {"paths": [render_clip, other_clip], "labels": ["a", "b"]})
            grid = body["result"]
            decoded = _decode(grid["output"])
            if (grid["frames"], grid["tiles"], decoded.shape[0]) != (
                    SERVER_RENDER_CLIP[0], 2, SERVER_RENDER_CLIP[0]):
                raise AssertionError(f"compare/grid: {grid}")
            # 7: face fix without a detector
            _, body, _ = srv.call(
                "POST", "/vrgdg/face_fix/estimate_anchors",
                {"video_path": grade_clip, "whole_scene": True,
                 "anchor_interval": 8})
            if body["frame_count"] != SERVER_GRADE_CLIP[0] \
                    or not body["anchor_indices"]:
                raise AssertionError(f"estimate_anchors: {body}")
            # 8: beats and audio
            _, body, _ = srv.call("POST",
                                  "/vrgdg/music_builder/beats/analyze",
                                  {"mix_path": wav})
            beat_data = body["result"]
            if abs(beat_data["bpm"] - SERVER_CLICKS[2]) > 6.0:
                raise AssertionError(f"beats: {beat_data['bpm']} bpm")
            _, body, _ = srv.call(
                "POST", "/vrgdg/music_builder/beats/scene_srt",
                {"beat_data": beat_data, "min_duration": 1.0,
                 "max_duration": 2.0, "seed": 3})
            if "-->" not in body["result"]["srt_text"]:
                raise AssertionError("scene_srt wrote no scene")
            _, body, _ = srv.call("POST", "/vrgdg/music_builder/audio/peaks",
                                  {"path": wav})
            if len(body["result"]["peaks"]) < 500:
                raise AssertionError("audio/peaks: too few peaks")
            _, body, _ = srv.call(
                "POST", "/vrgdg/music_builder/create_silent_audio",
                {"project_folder": os.path.join(folder, "project"),
                 "duration": 2.5})
            if not os.path.isfile(body["audio_path"]):
                raise AssertionError("create_silent_audio wrote no file")
            _say("server-beats", bpm=f"{beat_data['bpm']:.2f}",
                 beats=len(beat_data["beats"]))
            # 9: a cross-origin mutation
            srv.call("POST", "/vrgdg/video_enhancer/load",
                     {"path": render_clip}, status=403,
                     headers={"Origin": "http://elsewhere.example"})
        finally:
            if srv is not None:
                srv.close()
    # 10: the serve command
    _serve_command(kind)
    _say("server-kernels", **{name: launches.get(name, 0) for name in
                              ("grade_phase1", "grade_phase2",
                               "film_grain")},
         phase_s=f"{time.perf_counter() - started:.2f}")
    return launches


# phase 18: the host-only stores by request
BUILDER_STILL = (1080, 1920)                           # H, W
BUILDER_SCENES = 12
BUILDER_MIX = (60.0, 44100)                            # seconds, rate
BUILDER_CLIP = (24, 24.0, (1920, 1080))                # frames, fps, W x H
BUILDER_LIMIT_S = 60.0
BUILDER_CLOCK = 1767225600.25                          # 2026-01-01 UTC
# file-system times in the stores' answers (their own clocks are frozen)
_STORE_TIMES = frozenset({"updated", "modified", "mtime"})
_EPOCH = re.compile(r"\d{10}")


class _FrozenClock:
    """The ``time`` module with its clock held at one instant."""

    def __init__(self, now: float):
        self._now = now

    def time(self) -> float:
        return self._now

    def strftime(self, fmt: str, moment=None) -> str:
        return time.strftime(fmt, time.localtime(self._now)
                             if moment is None else moment)

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def _frozen_store_clocks(now: float):
    """Hold the stores' clocks at ``now``, so a request and its in-process
    twin name their time-stamped files alike; the files' own times stay
    real."""
    from datetime import datetime

    from vrgdg_tpu_torch.api import (builder, instructions, krea2_studio,
                                     lora_dataset, prompt_creator,
                                     scene_render, start_storyboard,
                                     storyboard, text_files, video_editor,
                                     workflow_runner)
    from vrgdg_tpu_torch.runtime import text_tools

    class Frozen(datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.fromtimestamp(now, tz)

    scene_clock = _SceneClock(now)
    saved = []
    for module in (builder, instructions, lora_dataset, storyboard,
                   text_files, video_editor, prompt_creator,
                   start_storyboard, workflow_runner, krea2_studio,
                   text_tools, scene_render):
        clock = scene_clock if module is scene_render else _FrozenClock(now)
        for name, real, fake in (("time", time, clock),
                                 ("datetime", datetime, Frozen)):
            if getattr(module, name, None) is real:
                saved.append((module, name, real))
                setattr(module, name, fake)
    try:
        yield scene_clock
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def _store_canon(value, root: str, drop=_STORE_TIMES):
    """A store's answer with its root as ``<root>`` and file times (the
    keys in ``drop``) left out."""
    if isinstance(value, dict):
        return {k: _store_canon(v, root, drop) for k, v in value.items()
                if k not in drop}
    if isinstance(value, (list, tuple)):
        return [_store_canon(v, root, drop) for v in value]
    if isinstance(value, str):
        return _EPOCH.sub("#", value.replace(root, "<root>"))
    return value


def _store_bytes(name: str, data: bytes, root: str, drop=_STORE_TIMES):
    if name.endswith(".json"):
        try:
            return _store_canon(json.loads(data.decode("utf-8-sig")), root,
                                drop)
        except ValueError:
            pass
    if os.path.splitext(name)[1] in (".txt", ".srt", ".json", ".yaml"):
        return _store_canon(data.decode("utf-8"), root)
    return data


def _store_tree(root: str, drop=_STORE_TIMES) -> dict:
    found = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            with open(path, "rb") as handle:
                found[os.path.relpath(path, root)] = _store_bytes(
                    name, handle.read(), root, drop)
    return found


def _zip_members(data: bytes, root: str) -> dict:
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(data)) as archive:
        return {info.filename: _store_bytes(info.filename,
                                            archive.read(info), root)
                for info in archive.infolist()}


def _seeded_wav(path: str, seconds: float, rate: int, seed: int) -> str:
    """A seeded stereo 16-bit WAV: a tone under noise, a burst a beat."""
    import wave

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    y = 0.2 * np.sin(2 * np.pi * 220.0 * t)[:, None] \
        + rng.normal(0.0, 0.03, (t.size, 2))
    y[(t % 0.5 < 0.02)] *= 3.0
    pcm = (np.clip(y, -1, 1) * 32767).round().astype("<i2")
    with wave.open(path, "wb") as handle:
        handle.setnchannels(2)
        handle.setsampwidth(2)
        handle.setframerate(rate)
        handle.writeframes(pcm.tobytes())
    return path


class _Twin:
    """Phase 18's requests, each beside the in-process call of the same
    function on a twin root: equal answers once each root reads
    ``<root>`` and file times are left out."""

    def __init__(self, srv: _Server, served: str, twin: str,
                 before=None, drop=_STORE_TIMES):
        # ``before(root)`` runs just before each side's call
        self.srv, self.served, self.twin = srv, served, twin
        self.before = before or (lambda root: None)
        self.drop = drop

    @staticmethod
    def _fill(value, root: str):
        return json.loads(json.dumps(value).replace("{root}", root))

    def __call__(self, method: str, path: str, payload, fn, flat=True,
                 status: int = 200):
        # distinct file times, so the stores' mtime orderings never tie
        time.sleep(0.012)
        params = self._fill(payload, self.served)
        self.before(self.served)
        if method == "GET":
            _, body, _ = self.srv.call(method, path, params=params or None,
                                       status=status)
        else:
            _, body, _ = self.srv.call(method, path, params, status=status)
        self.before(self.twin)
        try:
            result = fn(self._fill(payload, self.twin))
            want = {"ok": True, **result} if flat \
                else {"ok": True, "result": result}
        except Exception as exc:  # noqa: BLE001 — refusals are answers
            want = {"ok": False, "error": str(exc)}
        want = json.loads(json.dumps(want))
        if _store_canon(body, self.served, self.drop) \
                != _store_canon(want, self.twin, self.drop):
            raise AssertionError(f"{method} {path}: {str(body)[:600]} "
                                 f"!= in process {str(want)[:600]}")
        return body


def _builder_requests(srv: _Server, served: str, twin: str,
                      media: dict) -> int:
    """Phase 18's scenario by request, each request against its twin:
    the request count."""
    import shutil

    import cv2

    from vrgdg_tpu_torch.api import builder as mvb
    from vrgdg_tpu_torch.api import instructions as instr
    from vrgdg_tpu_torch.api import lora_dataset as lds
    from vrgdg_tpu_torch.api import storyboard as sbd
    from vrgdg_tpu_torch.api import text_files as tfl
    from vrgdg_tpu_torch.api import video_editor as ved
    from vrgdg_tpu_torch.server.routes import _remake_next

    step = _Twin(srv, served, twin)
    both = (served, twin)
    builder = "/vrgdg/music_builder/"
    project = "{root}/Chip Clip"
    span = BUILDER_MIX[0] / BUILDER_SCENES
    segments = [{"id": f"s{n}", "start": span * (n - 1), "end": span * n,
                 "label": f"Scene {n}", "lyric_text": f"line {n}",
                 "t2i_prompt": f"a wide shot {n}",
                 "i2v_prompt": f"slow pan {n}", "timeline_note": f"note {n}"}
                for n in range(1, BUILDER_SCENES + 1)]

    # 1-2: the project and its 12-scene timeline over the 60 s mix
    step("POST", builder + "new_project", {"project_name": "Chip Clip"},
         lambda p: mvb.new_project(p, twin))
    step("POST", builder + "save_session",
         {"project_folder": project, "audio_path": media["mix"],
          "session": {"segments": segments}},
         lambda p: mvb.save_session(p, twin))
    step("GET", builder + "list_projects", {},
         lambda p: mvb.list_projects(twin, ""))
    # 3: a 1080p scene image and reference from a data URL
    for name, payload, fn in (
            ("save_scene_image", {"scene_number": 3}, mvb.save_scene_image),
            ("save_flux_reference_image",
             {"reference_type": "subject", "name": "Hero"},
             mvb.save_reference_image)):
        step("POST", builder + name,
             {"project_folder": project, "image_data": media["still_url"],
              **payload}, fn)
    # 4-5: scene audio, the 60 s timeline mix, a trim, the analysis
    body = step("POST", builder + "save_scene_audio",
                {"project_folder": project, "scene_number": 1,
                 "source_path": media["scene_wav"]}, mvb.save_scene_audio)
    scene_audio = body["saved_path"]
    mixed = [dict(seg) for seg in segments]
    mixed[0]["custom_audio_path"] = media["scene_wav"]
    body = step("POST", builder + "prepare_scene_audio_mix",
                {"project_folder": project, "segments": mixed,
                 "global_audio_path": media["mix"]}, mvb.mix_scene_audio)
    if abs(body["duration"] - BUILDER_MIX[0]) > 0.05 \
            or body["scene_count"] != BUILDER_SCENES:
        raise AssertionError(f"mix: {body['duration']} s, "
                             f"{body['scene_count']} scenes")
    step("POST", builder + "trim_scene_audio",
         {"project_folder": project, "source_path": media["mix"],
          "scene_number": 4, "start": 15.0, "duration": 5.0},
         mvb.trim_scene_audio)
    step("POST", builder + "analyze_audio", {"audio_path": media["mix"]},
         lambda p: mvb.analyze_audio(p, twin))
    step("POST", builder + "analyze_audio", {"audio_path": media["still"]},
         lambda p: mvb.analyze_audio(p, twin), status=400)
    # 6-7: the final frame by cv2 (no ffmpeg here), the scan, the restore
    for root in both:
        videos = os.path.join(root, "Chip Clip", "rendered_scene_videos")
        os.makedirs(videos)
        shutil.copyfile(media["clip"],
                        os.path.join(videos, "video_0001-audio.mp4"))
    body = step("POST", builder + "extract_video_final_frame",
                {"project_folder": project, "scene_number": 1,
                 "source_path": project
                 + "/rendered_scene_videos/video_0001-audio.mp4"},
                mvb.extract_final_frame)
    if not np.array_equal(cv2.imread(body["saved_path"]),
                          _decode(media["clip"])[-1]):
        raise AssertionError("the final frame is not the clip's last frame")
    step("POST", builder + "scan_scene_videos", {"project_folder": project},
         lambda p: mvb.scan_scene_videos(p["project_folder"]))
    step("POST", builder + "restore_scene_video",
         {"project_folder": project, "scene_number": 1,
          "source_path": media["take"]}, mvb.restore_scene_video)
    _, served_audio, _ = srv.call("GET", builder + "audio",
                                  params={"path": scene_audio})
    with open(scene_audio, "rb") as handle:
        if served_audio != handle.read():
            raise AssertionError("the audio route served other bytes")
    srv.call("GET", builder + "audio", params={"path": media["mix"]},
             status=404)
    # 9: the instruction store
    base = {"project_folder": project, "key": "t2v", "scene_id": "s1"}
    for name, payload, fn in (
            ("get_instruction", base, instr.get_instruction),
            ("save_instruction", {**base, "scope": "all_scenes",
                                  "text": "every scene"},
             instr.save_instruction),
            ("save_instruction", {**base, "text": "only s1"},
             instr.save_instruction),
            ("reset_instruction", {**base, "scope": "scene"},
             instr.reset_instruction),
            ("save_instruction_preset", {"key": "krea2_t2i",
                                         "name": "Look", "text": "body"},
             lambda p: instr.save_preset(p, twin)),
            ("list_instruction_presets", {"key": "zimage_t2i"},
             lambda p: instr.list_presets(p, twin)),
            ("load_instruction_preset", {"key": "ernie_t2i",
                                         "name": "Look"},
             lambda p: instr.load_preset(p, twin))):
        step("POST", builder + name, payload, fn)
    step("GET", builder + "instruction_keys", {}, lambda p: {"keys": [
        {"key": key, "label": entry["label"],
         "preset_group": instr.preset_group(key),
         "preset_group_label": instr.preset_group_label(key)}
        for key, entry in instr.REGISTRY.items()]})
    # 8: the streamed export and the multipart import
    _, exported, _ = srv.call("GET", builder + "export_project",
                              params={"project_folder":
                                      os.path.join(served, "Chip Clip")})
    zip_path, _ = mvb.export_project(os.path.join(twin, "Chip Clip"))
    try:
        with open(zip_path, "rb") as handle:
            if _zip_members(exported, served) != _zip_members(handle.read(),
                                                             twin):
                raise AssertionError("export_project: other ZIP members")
        data, content_type = _multipart(
            "project_zip", "chip.vrgdg.zip", exported,
            fields={"project_name": "Imported"})
        _, body, _ = srv.call("POST", builder + "import_project", data=data,
                              headers={"Content-Type": content_type})
        want = {"ok": True, **mvb.import_project(zip_path, "Imported", twin)}
    finally:
        os.remove(zip_path)
    if _store_canon(body, served) != _store_canon(json.loads(json.dumps(
            want)), twin):
        raise AssertionError("import_project differs from in process")
    # 10: text files, the audio library, the popup
    step("POST", builder + "save_text_file",
         {"path": "{root}/notes.txt", "content": "hello"}, tfl.save_text_file)
    step("POST", builder + "load_text_file", {"path": "{root}/notes.txt"},
         tfl.load_text_file)
    for text in ("chapter one\n", "\nchapter two"):
        step("POST", "/vrgdg/text_files/save_concat",
             {"folder_name": "story", "file_name": "tale", "concat": True,
              "text": text}, lambda p: tfl.save_text_concat(p, twin),
             flat=False)
    step("POST", "/vrgdg/text_files/save_advanced",
         {"folder_name": "story", "file_name": "scene", "text": "one"},
         lambda p: tfl.save_text_advanced(p, twin), flat=False)
    step("GET", "/vrgdg/text_files/files", {"folder": "story"},
         lambda p: tfl.list_folder_files("story", output_root=twin))
    with open(media["scene_wav"], "rb") as handle:
        wav_bytes = handle.read()
    data, content_type = _multipart("audio", "Chip Song.wav", wav_bytes)
    _, body, _ = srv.call("POST", "/vrgdg/audio/upload", data=data,
                          headers={"Content-Type": content_type})
    want = {"ok": True, **tfl.save_audio_upload("Chip Song.wav", wav_bytes,
                                                False, twin)}
    if _store_canon(body, served) != _store_canon(want, twin):
        raise AssertionError("audio/upload differs from in process")
    step("GET", "/vrgdg/audio/list", {}, lambda p: tfl.list_audio(twin))
    step("POST", "/vrgdg/test_popup/save_text",
         {"concept": "a city at dusk", "full_lyrics": "oh"},
         lambda p: tfl.popup_save_text(p, twin))
    step("GET", "/vrgdg/test_popup/config", {},
         lambda p: tfl.popup_config(twin))
    # storyboard
    board = "{root}/board"
    storyboard = {"projectVideoEngine": "ltx", "scenes": [
        {"label": seg["label"], "image_prompt": seg["t2i_prompt"],
         "video_prompt": "she sings to the camera", "lyrics": seg["lyric_text"]}
        for seg in segments]}
    step("POST", "/vrgdg/storyboard/load", {"project_folder": board},
         lambda p: {"storyboard": sbd.load_storyboard(p)})
    step("POST", "/vrgdg/storyboard/save",
         {"project_folder": board, "storyboard": storyboard},
         lambda p: {"storyboard": sbd.save_storyboard(p)})
    step("POST", "/vrgdg/storyboard/import_reference_image",
         {"project_folder": board, "kind": "location", "name": "Pier",
          "image_data": media["still_url"]}, sbd.import_reference_image)
    step("POST", "/vrgdg/storyboard/export_prompts",
         {"project_folder": board, "storyboard": storyboard},
         sbd.export_prompts)
    # video editor and its remake queue
    for root in both:
        edit = os.path.join(root, "edit")
        os.makedirs(edit)
        for number in (1, 2, 3):
            shutil.copyfile(media["clip"],
                            os.path.join(edit, f"video_{number:04d}.mp4"))
        with open(os.path.join(edit, "cut.srt"), "w",
                  encoding="utf-8") as handle:
            handle.write(mvb.segments_to_srt(segments[:3]))
    edit = "{root}/edit"
    session = {"project_folder": edit, "clips": {
        f"video_{n:04d}.mp4": {"name": f"video_{n:04d}.mp4",
                               "clip_number": n,
                               "path": f"{edit}/video_{n:04d}.mp4",
                               "selected_for_remake": n != 2}
        for n in (1, 2, 3)}}

    roots = (twin,)
    step("POST", "/vrgdg/video_editor/list_clips", {"folder_path": edit},
         lambda p: ved.list_clips(p["folder_path"], "", roots))
    step("POST", "/vrgdg/video_editor/save_session",
         {"folder_path": edit, "session": session},
         lambda p: ved.save_session(p["folder_path"], p["session"],
                                    roots))
    step("POST", "/vrgdg/video_editor/save_frame",
         {"folder_path": edit, "clip_name": "video_0002.mp4",
          "frame_time": 0.5, "image_data": media["still_url"]},
         lambda p: ved.save_frame(p, roots))
    session_path = edit + "/vrgdg_temp/editor_session.json"
    step("POST", "/vrgdg/video_editor/load_clip",
         {"session_path": session_path, "clip_number": 3},
         lambda p: ved.load_clip(p["session_path"], 3, ""))
    for index in range(3):
        body = step("POST", "/vrgdg/video_editor/remake/next",
                    {"session_path": session_path,
                     "srt_file": edit + "/cut.srt",
                     "audio_path": media["mix"], "fps": 24,
                     "audio_output": "{root}/remake_%d.wav" % index},
                    _remake_next)
    if body["is_valid"]:
        raise AssertionError("the remake queue did not drain")
    # LoRA dataset
    dataset = "{root}/dataset"
    step("POST", "/vrgdg/lora_dataset/save_pair",
         {"dataset_folder": dataset, "index": 1, "image": media["still"],
          "caption": "a red door"}, lds.save_pair)
    step("POST", "/vrgdg/lora_dataset/save_ic_pair",
         {"dataset_folder": dataset, "index": 1,
          "reference": media["still"], "target": media["still_url"],
          "instruction": "make it night"}, lds.save_ic_pair)
    step("POST", "/vrgdg/lora_dataset/list", {"dataset_folder": dataset},
         lds.list_dataset)
    # the project's end, and a refusal outside the root
    step("POST", builder + "delete_project",
         {"project_folder": "{root}/Imported"},
         lambda p: mvb.delete_project(p, twin))
    step("POST", builder + "delete_project",
         {"project_folder": media["folder"]},
         lambda p: mvb.delete_project(p, twin), status=400)
    return srv.calls


def _builder_commands(folder: str, media: dict) -> dict:
    """The ``builder`` and ``humo`` commands of ``vrgdg_tpu_torch.cli``
    in this process; their seconds by action."""
    import shutil

    root = os.path.join(folder, "cli_root")
    session = os.path.join(folder, "session.json")
    span = BUILDER_MIX[0] / BUILDER_SCENES
    with open(session, "w", encoding="utf-8") as handle:
        json.dump({"segments": [{"id": f"c{n}", "start": span * (n - 1),
                                 "end": span * n, "label": f"Scene {n}"}
                                for n in range(1, BUILDER_SCENES + 1)]},
                  handle)
    project = os.path.join(root, "Cli Clip")
    seconds = {}

    def run(*argv):
        started = time.perf_counter()
        result = _cli_json(list(argv))
        seconds[" ".join(argv[:2])] = round(time.perf_counter() - started, 3)
        return result

    run("builder", "new", "Cli Clip", "--output-root", root)
    run("builder", "save", project, "--session", session, "--audio",
        media["mix"], "--output-root", root)
    listed = run("builder", "list", "--output-root", root)
    loaded = run("builder", "load", project)
    if [p["name"] for p in listed["projects"]] != ["Cli Clip"] \
            or len(loaded["session"]["segments"]) != BUILDER_SCENES:
        raise AssertionError(f"builder list/load: {listed} {loaded}")
    run("builder", "scan", project)
    analyzed = run("builder", "analyze", media["mix"], "--output-root", root)
    scenes = os.path.join(folder, "segments.json")
    with open(scenes, "w", encoding="utf-8") as handle:
        json.dump([{"start": 0.0, "end": 2.0,
                    "custom_audio_path": media["scene_wav"]},
                   {"start": 2.0, "end": 3.0}], handle)
    mixed = run("builder", "mix", project, "--session", scenes)
    zip_path = os.path.join(folder, "cli.vrgdg.zip")
    run("builder", "export", project, "-o", zip_path)
    imported = run("builder", "import", zip_path, "--name", "Cli Back",
                   "--output-root", root)
    run("builder", "delete", imported["project_folder"], "--output-root",
        root)
    if abs(analyzed["duration"] - BUILDER_MIX[0]) > 0.05 \
            or abs(mixed["duration"] - 3.0) > 0.05 \
            or os.path.isdir(imported["project_folder"]):
        raise AssertionError(f"builder analyze/mix/import: "
                             f"{analyzed['duration']} {mixed['duration']} "
                             f"{imported}")
    plan = run("humo", "plan", media["mix"])
    split = run("humo", "split-set", media["mix"], "-o",
                os.path.join(folder, "set0"))
    chunk = run("humo", "chunk", media["mix"], "--index", "1",
                "--durations", "2,3.5,4", "-o", os.path.join(folder, "chunks"))
    sets = os.path.join(folder, "sets")
    os.makedirs(sets)
    for index in (1, 2):
        shutil.copyfile(media["clip"],
                        os.path.join(sets, f"set{index}-audio.mp4"))
    grid = run("humo", "grid", sets, "--labels", "one,two", "-o",
               os.path.join(folder, "grid.mp4"))
    final = run("humo", "final", sets, "--threshold", "2", "--audio",
                media["mix"])
    if len(split["segments"]) != 16 or not os.path.isfile(chunk["wav"]) \
            or final.get("skipped") or grid["tiles"] != 2 \
            or grid["frames"] != BUILDER_CLIP[0] or not plan:
        raise AssertionError(f"humo: {split} {chunk} {final} {grid}")
    return seconds


def builder_phase(device) -> None:
    """Phase 18: the host-only stores (builder, instruction store, text
    and audio libraries, storyboard, video editor, LoRA dataset) by
    request on the port's server with the card as its device, each
    request beside the in-process call on a twin root, then the
    ``builder`` and ``humo`` commands; none of the six kernels may
    launch."""
    import base64
    import shutil

    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        served = os.path.join(folder, "served")
        twin = os.path.join(folder, "twin")
        media_folder = os.path.join(folder, "media")
        os.makedirs(twin)
        os.makedirs(media_folder)
        height, width = BUILDER_STILL
        still = _still(os.path.join(media_folder, "still.png"), height,
                       width, 1801)
        with open(still, "rb") as handle:
            still_url = "data:image/png;base64," + base64.b64encode(
                handle.read()).decode()
        seconds, rate = BUILDER_MIX
        frames, fps, (clip_w, clip_h) = BUILDER_CLIP
        media = {
            "folder": media_folder, "still": still, "still_url": still_url,
            "mix": _seeded_wav(os.path.join(media_folder, "mix.wav"),
                               seconds, rate, 1802),
            "scene_wav": _seeded_wav(os.path.join(media_folder, "scene.wav"),
                                     5.0, rate, 1803),
            "clip": _write_clip(os.path.join(media_folder, "scene.mp4"),
                                frames, fps, clip_w, clip_h, 1804),
            "take": _write_clip(os.path.join(media_folder, "take.mp4"),
                                frames // 2, fps, clip_w, clip_h, 1805)}
        srv = None
        with _frozen_store_clocks(BUILDER_CLOCK):
            try:
                srv = _Server(device, served)
                requests, counts = _counted(
                    lambda: _builder_requests(srv, served, twin, media))
            finally:
                if srv is not None:
                    srv.close()
        _expect("builder requests", counts, {})
        trees = _store_tree(served), _store_tree(twin)
        if trees[0] != trees[1]:
            names = sorted(set(trees[0]) ^ set(trees[1])) or sorted(
                name for name in trees[0] if trees[0][name] != trees[1][name])
            raise AssertionError(f"served and twin roots differ: {names[:8]}")
        wavs = sum(name.endswith(".wav") for name in trees[0])
        request_s = time.perf_counter() - started
        command_seconds, counts = _counted(
            lambda: _builder_commands(folder, media))
        _expect("builder and humo commands", counts, {})
        shutil.rmtree(served)
    elapsed = time.perf_counter() - started
    _say("builder", requests=requests, files=len(trees[0]), wavs=wavs,
         vs_twin="equal", final_frame="cv2 last frame",
         ffmpeg=f"'{shutil.which('ffmpeg') or 'absent'}'",
         kernels="none launched", requests_s=f"{request_s:.2f}",
         commands=json.dumps(command_seconds, separators=(",", ":")),
         phase_s=f"{elapsed:.2f}", limit_s=BUILDER_LIMIT_S)
    if elapsed > BUILDER_LIMIT_S:
        raise AssertionError(f"phase 18 took {elapsed:.1f} s, over "
                             f"{BUILDER_LIMIT_S} s")


WORKFLOW_STILL = (1080, 1920)                          # H, W
WORKFLOW_SCENES = 12
WORKFLOW_MIX = (60.0, 44100)                           # seconds, rate
WORKFLOW_LIMIT_S = 45.0
WORKFLOW_SEED = 1901
# the catalog's model names as the builders' templates name them (a
# backslash is a subfolder of the category's folder)
WORKFLOW_MODELS = {
    "loras": ["a.safetensors", "sub\\b.safetensors",
              "licon\\LTX-2.3-Licon-MSR-V1.safetensors",
              "ltx-2.3-22b-ic-lora-ingredients-0.9.safetensors",
              "lora_weights.safetensors",
              "minimax_h3_turbo_4step_ema_ckpt850.safetensors"],
    "unet": ["z_image_turbo_bf16.safetensors", "model.gguf"],
    "diffusion_models": ["krea2_turbo_fp8_scaled.safetensors",
                         "minimax_h3_ref2va_pruned_int8_convrot.safetensors"],
    "clip": ["qwen_3_4b.safetensors"],
    "text_encoders": ["qwen3vl_4b_fp8_scaled.safetensors",
                      "qwen3vl_32b_minimax_h3_nvfp4_awq.safetensors"],
    "vae": ["qwen_image_vae.safetensors", "ae.safetensors",
            "minimax_h3_video_vae_fp16.safetensors",
            "minimax_h3_audio_vae_fp32.safetensors"],
    "upscale_models": ["4x.safetensors"],
}
# phase 19's answers also carry the Krea2 dataset's signature, a hash
# over its files' times
_WORKFLOW_DROP = _STORE_TIMES | {"signature"}
# the slideshow's scratch folder is a tempfile.mkdtemp name
_SLIDESHOW_SCRATCH = re.compile(r"_slideshow_[^/'\"]+")


class _SceneClock(_FrozenClock):
    """``scene_render``'s clock: held at one instant, except that a sleep
    moves it on at once (the render routes poll a file until its size
    settles); :meth:`reset` puts it back, so a request and its twin see
    the same times."""

    def __init__(self, now: float):
        super().__init__(now)
        self._start = now

    def sleep(self, seconds) -> None:
        self._now += max(0.0, float(seconds))

    def reset(self) -> None:
        self._now = self._start


class RecordingRunner:
    """ffmpeg and ffprobe on ``scene_render``'s runner seam: each command
    is recorded, the LUT a filter graph reads is kept, and each output is
    written (a seeded frame by cv2 for a PNG, a WAV of silence for a WAV,
    a few bytes for other media), so the routes' checks of their outputs
    pass where no ffmpeg is installed."""

    def __init__(self, frame: tuple[int, int] = WORKFLOW_STILL):
        self.frame = frame
        self.commands: list[list[str]] = []
        self.cubes: list[bytes] = []

    def __call__(self, cmd, *, check=False, cwd=None):
        import types
        import wave

        import cv2

        cmd = [str(part) for part in cmd]
        self.commands.append(cmd)
        done = types.SimpleNamespace(returncode=0, stdout="", stderr="")
        if "ffprobe" in os.path.basename(cmd[0]):
            done.stdout = ("4.000000\n" if "format=duration" in cmd
                           else "640x360\n")
            return done
        for part in cmd:
            if "lut3d=file='" in part:
                name = part.split("lut3d=file='", 1)[1].split("'", 1)[0]
                with open(os.path.join(cwd or "", name), "rb") as handle:
                    self.cubes.append(handle.read())
        target = os.path.join(cwd or "", cmd[-1])
        ext = os.path.splitext(target)[1].lower()
        if ext == ".png":
            # a frame keyed by the file's name: the grabs of a request and
            # of its twin have equal pixels
            rng = np.random.default_rng(sum(os.path.basename(target)
                                            .encode()))
            level, spread = rng.uniform(40, 200, 3), rng.uniform(8, 50, 3)
            frame = rng.normal(level, spread, (*self.frame, 3))
            if not cv2.imwrite(target, np.clip(frame, 0, 255)
                               .astype(np.uint8)):
                raise RuntimeError(f"cv2 could not write {target}")
        elif ext == ".wav":
            seconds = float(cmd[cmd.index("-t") + 1]) if "-t" in cmd \
                else 1.0
            with wave.open(target, "wb") as handle:
                handle.setnchannels(2)
                handle.setsampwidth(2)
                handle.setframerate(44100)
                handle.writeframes(bytes(4 * int(round(seconds * 44100))))
        else:
            with open(target, "wb") as handle:
                handle.write(b"media:" + os.path.basename(target).encode())
        return done


def command_plan(commands, root: str) -> list:
    """Recorded commands with the root as ``<root>`` and the slideshow's
    scratch folder named alike."""
    return [[_SLIDESHOW_SCRATCH.sub("_slideshow_#",
                                    part.replace(root, "<root>"))
             for part in cmd] for cmd in commands]


def workflow_model_root(folder: str, seed: int) -> str:
    """A model root of empty files named like the catalog's models, with
    two seeded LoRA names besides."""
    rng = np.random.default_rng(seed)
    names = {category: list(found)
             for category, found in WORKFLOW_MODELS.items()}
    names["loras"] += [f"seeded_{int(rng.integers(10 ** 6)):06d}"
                       ".safetensors" for _ in range(2)]
    for category, found in names.items():
        for name in found:
            path = os.path.join(folder, category, *name.split("\\"))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            open(path, "wb").close()
    return folder


def workflow_payloads(rng, media: dict) -> dict:
    """One seeded payload for each of the 16 builders, with explicit
    seeds; ``{root}`` stands for the root of the side that sends it.
    ``media``: ``audio``, ``srt``, ``image``, ``image2``, ``frames`` (a
    folder), ``h3_project`` (a folder) and ``loras`` (names)."""

    def seed():
        return int(rng.integers(0, 2 ** 40))

    def size(low=256, high=2048):
        return int(rng.integers(low, high))

    def loras():
        fields = {"use_custom_loras": True,
                  "lora_count": int(rng.integers(1, 4))}
        for slot in range(1, 5):
            fields[f"lora_{slot}"] = str(rng.choice(
                media["loras"] + ["missing.safetensors", "[none]"]))
            fields[f"strength_{slot}"] = float(rng.uniform(-2, 2))
        return fields

    def scene():
        return {"audio_path": media["audio"], "srt_path": media["srt"],
                "project_folder": "{root}/wf_project",
                "scene_number": int(rng.integers(1, 4)),
                "prompt_number_one_based": int(rng.integers(1, 4)),
                "fps": 24, "seed": seed(),
                "tail_loss_frames": int(rng.integers(0, 12)),
                "pre_frames": int(rng.integers(0, 12))}

    return {
        "zimage": {"prompt": "a scenic view", "seed": seed(),
                   "first_pass_width": size(),
                   "second_pass_height": str(size()),
                   "batch_size": int(rng.integers(1, 4)),
                   "ltx_two_pass_mode": bool(rng.random() < 0.5),
                   **loras()},
        "krea2": {"prompt": "a castle on a hill", "seed": seed(),
                  "width": size(), "height": size(),
                  "first_pass_width": size(), "first_pass_height": size(),
                  "use_zimage_enhance": True,
                  "zimage_enhance_strength": float(rng.uniform(0, 1))},
        "krea2_2pass": {"prompt": "portrait in rain", "seed": seed(),
                        "aspect_ratio": "16:9 (Widescreen)",
                        "cfg": float(rng.uniform(0.5, 2.0)),
                        "image_to_image_creativity": int(
                            rng.integers(0, 10)),
                        "use_loras": False, **loras()},
        "ernie_image": {"prompt": "neon city", "seed": seed(),
                        "width": size(), "height": size(), **loras()},
        "flux_klein": {"prompt": "two subjects dancing in a large hall",
                       "seed": seed(), "width": size(), "height": size(),
                       "image_ingredients": [{"path": media["image"]}],
                       **loras()},
        "nb_image": {"prompt": "a quiet village under snowfall at dusk",
                     "api_key": "AIzaSyFakeKey1234567890",
                     "image_ingredients": [{"path": media["image2"]}]},
        "z_upscale_enhance": {"prompt": "enhance this", "seed": seed(),
                              "width": size(), "height": size(),
                              "enhance_amount": int(rng.integers(0, 20)),
                              "source_image_path": media["image"],
                              **loras()},
        "i2v": {**scene(), "i2v_prompt": "singer on a rooftop",
                "image_folder": media["frames"],
                "image_index_zero_based": int(rng.integers(0, 3)),
                "width": size(), "height": size(),
                "use_gguf_model": True, "unet_name": "model.gguf",
                **loras()},
        "t2v": {**scene(), "t2v_prompt": "city time-lapse",
                "width": size(), "height": size(), **loras()},
        "rtv": {**scene(), "t2v_prompt": "band performing",
                "msr_lora_name": "licon/LTX-2.3-Licon-MSR-V1.safetensors",
                "msr_reference_strength": "25 - balanced",
                "msr_background_mode": "neutral",
                "rtv_references": {"subjects": [{"path": media["image"]}],
                                   "use_subject_placeholder": False},
                **loras()},
        "ingredients": {**scene(), "t2v_prompt": "ingredient shot",
                        "ingredients_image_path": media["image"],
                        "width": size(64), "height": size(64)},
        "id_lora": {"id_lora_prompt": "close-up performance",
                    "source_image_path": media["image"],
                    "reference_audio_path": media["audio"],
                    "project_folder": "{root}/wf_project", "fps": 24,
                    "duration": float(rng.uniform(2, 8)),
                    "pass1_seed": seed(),
                    "identity_guidance_scale": float(rng.uniform(1, 20)),
                    "id_lora_name": "lora_weights.safetensors",
                    "crf": int(rng.integers(10, 40)), **loras()},
        "flf": {"i2v_prompt": "sunrise to sunset",
                "audio_path": media["audio"], "srt_path": media["srt"],
                "project_folder": "{root}/wf_project",
                # names in the ingest folder: two files copied in at
                # one frozen instant would get one name
                "first_frame": {"path": "first_frame.png"},
                "last_frame": {"path": "last_frame.png"},
                "first_guide_strength": float(rng.uniform(0, 1)),
                "last_guide_interpolation": "lanczos", **loras()},
        "minimax_h3": {"audio_mode": "built_in_audio",
                       "prompt": "drummer in the rain",
                       "project_folder": media["h3_project"],
                       "scene_number": int(rng.integers(1, 8)),
                       "timeline_start_seconds": float(rng.integers(0, 10)),
                       "scene_duration_seconds": float(rng.integers(2, 8)),
                       "warmup_frames": int(rng.integers(0, 30)),
                       "cooldown_frames": int(rng.integers(0, 30)),
                       "aspect_ratio": "16:9 (Widescreen)",
                       "megapixels": float(rng.uniform(0.5, 4)),
                       "seed": seed(), "steps": int(rng.integers(4, 40)),
                       "image_paths": [media["image"]]},
        "transcribe": {"audio_path": media["audio"],
                       "srt_path": media["srt"],
                       "reference_lyrics": "la la", "language": "english",
                       "fill_aggressiveness": int(rng.integers(0, 5)),
                       "model_name": "large-v3"},
        "timestamped_transcribe": {
            "audio_path": media["audio"], "segment_mode": "reference_lines",
            "min_gap_seconds": float(rng.uniform(0, 10)),
            "max_scene_seconds": float(rng.uniform(5, 30))},
    }


def _workflow_media(folder: str) -> dict:
    """Phase 19's shared inputs under ``folder``: 1080p stills (PNG bytes
    too), the seeded 60 s stereo WAV, a 12-scene SRT, the model root."""
    import base64

    from vrgdg_tpu_torch.api import builder as mvb

    height, width = WORKFLOW_STILL
    seconds, rate = WORKFLOW_MIX
    frames = os.path.join(folder, "frames")
    h3_project = os.path.join(folder, "h3_project")
    os.makedirs(frames)
    os.makedirs(h3_project)
    stills = [_still(os.path.join(frames, f"frame_{n:03d}.png"), height,
                     width, 1910 + n) for n in range(3)]
    span = seconds / WORKFLOW_SCENES
    segments = [{"id": f"s{n}", "start": span * (n - 1), "end": span * n,
                 "label": f"Scene {n}", "lyric_text": f"line {n}",
                 "t2i_prompt": f"a wide shot {n}"}
                for n in range(1, WORKFLOW_SCENES + 1)]
    srt = os.path.join(folder, "scenes.srt")
    with open(srt, "w", encoding="utf-8") as handle:
        handle.write(mvb.segments_to_srt(segments))
    pngs = []
    for path in stills[:2]:
        with open(path, "rb") as handle:
            pngs.append(handle.read())
    models = workflow_model_root(os.path.join(folder, "models"),
                                 WORKFLOW_SEED)
    return {
        "folder": folder, "frames": frames, "h3_project": h3_project,
        "image": stills[0], "image2": stills[1], "pngs": pngs,
        "data_url": "data:image/png;base64,"
        + base64.b64encode(pngs[0]).decode(),
        "audio": _seeded_wav(os.path.join(folder, "mix.wav"), seconds,
                             rate, 1902),
        "srt": srt, "segments": segments, "models": models,
        "loras": sorted(name for _, _, names in os.walk(
            os.path.join(models, "loras")) for name in names)}


def _with_registered(result: dict) -> dict:
    """The model-root GET's answer: the root and whether it is a
    folder."""
    result["registered"] = bool(result.get("models_root")
                                and os.path.isdir(result["models_root"]))
    return result


def _workflow_runner_requests(step, srv, served: str, twin: str,
                              media: dict, runners: dict) -> dict:
    """The workflow runner's 30 paths (the 16 builders, clear_memory,
    the model root, the choices) and the scene-render routes through
    the recording runner; returns ``{"ffmpeg_commands": n}``."""
    import shutil

    from vrgdg_tpu_torch.api import scene_render as sr
    from vrgdg_tpu_torch.api import workflow_runner as wr
    from vrgdg_tpu_torch.runtime import video_io

    base = "/vrgdg/workflow_runner/"
    step("GET", base + "model_root", {},
         lambda p: _with_registered(wr.load_model_root(twin)))

    def save_root(p):
        result = wr.save_model_root(p.get("models_root", ""), twin)
        wr.set_default_catalog(None)
        return result

    step("POST", base + "model_root", {"models_root": media["models"]},
         save_root)
    step("GET", base + "model_root", {},
         lambda p: _with_registered(wr.load_model_root(twin)))
    step("GET", base + "lora_list", {}, lambda p: wr.lora_list())
    step("GET", base + "i2v_choices", {}, lambda p: wr.i2v_choices())
    step("GET", base + "builders", {}, lambda p: {
        "builders": sorted(list(wr.BUILDERS) + ["clear_memory"])})
    payloads = workflow_payloads(np.random.default_rng(WORKFLOW_SEED),
                                 media)
    if sorted(payloads) != sorted(wr.BUILDERS):
        raise AssertionError(f"payloads for {sorted(payloads)}")
    for key, payload in payloads.items():
        body = step("POST", base + f"build_{key}_prompt", payload,
                    lambda p, key=key: wr.BUILDERS[key](p, base=twin))
        if not isinstance(body.get("prompt"), dict) or not body["prompt"]:
            raise AssertionError(f"build_{key}_prompt: {str(body)[:300]}")
    step("POST", base + "build_clear_memory_prompt", {},
         lambda p: wr.build_clear_memory_prompt())
    # a seed of -1 draws one (not comparable with a twin)
    step.before(served)
    _, body, _ = srv.call("POST", base + "build_minimax_h3_prompt",
                          {**payloads["minimax_h3"], "seed": -1})
    if not 0 <= body["used_seed"] <= 2 ** 64 - 1:
        raise AssertionError(f"drawn seed {body['used_seed']}")

    # the scene-render routes: ffmpeg on the seam, the roots' scene files
    for root in (served, twin):
        scenes = os.path.join(root, "scenes")
        for relative in ("rendered_scene_videos/video_0001-audio.mp4",
                         "rendered_scene_videos/video_0002-audio.mp4",
                         "image_to_video_clips_a/video_0003_take-audio.mp4",
                         "image_to_video_clips_a/video_0004-audio.mp4",
                         "clips/take.mp4", "clips/long_take.mp4",
                         "insert.mp4"):
            path = os.path.join(scenes, relative)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as handle:
                handle.write(b"clip:" + relative.encode())
        os.makedirs(os.path.join(scenes, "text_to_video_clips_old"))
        os.makedirs(os.path.join(root, "renders"))
        shutil.copyfile(media["image"],
                        os.path.join(root, "renders", "gen_0001.png"))
    scenes = "{root}/scenes"
    videos = scenes + "/rendered_scene_videos"
    real_find = video_io.find_ffmpeg
    video_io.find_ffmpeg = lambda: "ffmpeg"
    try:
        step("POST", base + "collect_scene_video",
             {"project_folder": scenes, "scene_number": 3,
              "existing_action": "backup", "source_path":
              scenes + "/image_to_video_clips_a/video_0003_take-audio.mp4"},
             sr.collect_scene_video)
        step("POST", base + "collect_scene_video",
             {"project_folder": scenes, "scene_number": 1,
              "existing_action": "backup",
              "source_path": scenes + "/clips/take.mp4"},
             sr.collect_scene_video)
        step("POST", base + "trim_scene_video",
             {"project_folder": scenes, "scene_number": 2,
              "source_path": scenes + "/clips/long_take.mp4",
              "start": 1.25,
              "duration": 3.5, "label": "Best Take!",
              "mark_as_audio_video": True}, sr.trim_scene_video)
        step("POST", base + "find_scene_video_output",
             {"project_folder": scenes, "scene_number": 4},
             sr.find_scene_video_output)
        step("POST", base + "match_scene_video_start_color",
             {"project_folder": scenes, "fade_seconds": 1.5,
              "strength": 0.7, "video_path": videos + "/video_0002-audio.mp4",
              "reference_video_path": videos + "/video_0001-audio.mp4"},
             sr.match_scene_start_color)
        step("POST", base + "stitch_scene_videos",
             {"project_folder": scenes,
              "scene_paths": [f"{videos}/video_{n:04d}-audio.mp4"
                              for n in (1, 2, 3)],
              "scene_audio_items": [{"path": media["audio"],
                                     "start": 5.0 * n, "duration": 5.0}
                                    for n in range(3)],
              "overlay_items": [{"path": scenes + "/insert.mp4",
                                 "start": 1.0, "end": 2.5,
                                 "source_start": 0.25}],
              "scene_timing_items": [{"start": 0.0, "end": 5.0},
                                     {"start": 5.0, "end": 10.0},
                                     {"start": 10.0, "end": 15.0}],
              "timeline_fps": 24, "width": 1280, "height": 720,
              "output_prefix": "FINAL_VIDEO"}, sr.stitch_scene_videos)
        step("POST", base + "render_image_slideshow",
             {"project_folder": scenes, "audio_path": media["audio"],
              "audio_start": 2.0, "width": 1920, "height": 1080, "fps": 24,
              "image_items": [{"path": media["image"], "duration": 2.5},
                              {"path": media["image2"], "duration": 3.0}]},
             sr.render_image_slideshow)
        step("POST", base + "save_image",
             {"image": {"filename": "gen_0001.png", "subfolder": "renders",
                        "type": "output"}, "save_folder": "Approved"},
             lambda p: sr.save_generated_image(p, base=twin))
        step("POST", base + "prepare_scene_audio_clip",
             {"audio_path": media["audio"], "project_folder": scenes,
              "scene_number": 5, "start_seconds": 12.5,
              "duration_seconds": 4.0},
             lambda p: wr.prepare_scene_audio_clip(p, base=twin))
    finally:
        video_io.find_ffmpeg = real_find
        sr.set_ffmpeg_runner(None)
    plans = [command_plan(runners[root].commands, root)
             for root in (served, twin)]
    if plans[0] != plans[1] or not plans[0]:
        raise AssertionError("the ffmpeg command plans differ")
    cubes = [runners[root].cubes for root in (served, twin)]
    if cubes[0] != cubes[1] or len(cubes[0]) != 1 \
            or not cubes[0][0].startswith(b'TITLE "VRGDG opening'):
        raise AssertionError("the colour-match cubes differ")
    # without the runner the default seam runs; with no ffmpeg installed
    # each render route fails with find_ffmpeg_path's message
    if shutil.which("ffmpeg") is None:
        body = step("POST", base + "trim_scene_video",
                    {"project_folder": scenes, "scene_number": 2,
                     "source_path": scenes + "/clips/long_take.mp4"},
                    sr.trim_scene_video, status=400)
        if "FFmpeg was not found" not in body["error"]:
            raise AssertionError(f"without ffmpeg: {body}")
    return {"ffmpeg_commands": len(plans[0])}


def _prompt_creator_requests(step, srv, served: str, twin: str,
                             media: dict) -> None:
    """The prompt creator's 13 paths: the multipart audio import, the
    outputs, a draft saved and loaded, the instruction store, the
    hidden Whisper workflow."""
    from vrgdg_tpu_torch.api import pc_instructions as pci
    from vrgdg_tpu_torch.api import prompt_creator as pcr

    base = "/vrgdg/music_prompt_creator/"
    project = "{root}/Chip Prompts"
    with open(media["audio"], "rb") as handle:
        wav = handle.read()
    step.before(served)
    data, content_type = _multipart(
        "audio", "Chip Song!.wav", wav,
        fields={"project_folder": project.replace("{root}", served)})
    _, body, _ = srv.call("POST", base + "import_audio", data=data,
                          headers={"Content-Type": content_type})
    step.before(twin)
    want = {"ok": True, **pcr.import_audio(
        project.replace("{root}", twin), "Chip Song!.wav", wav, twin)}
    if _store_canon(body, served) != _store_canon(want, twin):
        raise AssertionError("import_audio differs from in process")
    audio = body["audio_path"].replace(served, "{root}")
    segments = media["segments"]
    step("POST", base + "save_outputs",
         {"project_folder": project, "full_lyrics": "\n".join(
             seg["lyric_text"] for seg in segments), "subject": "Ann",
          "segments": {f"segment{n}": seg["lyric_text"]
                       for n, seg in enumerate(segments, 1)},
          "prompts": json.dumps({f"Prompt{n}": seg["t2i_prompt"]
                                 for n, seg in enumerate(segments, 1)}),
          "i2v_motion_notes": {"Motion1": "slow pan"},
          "srt_text": open(media["srt"], encoding="utf-8").read()},
         lambda p: pcr.save_outputs(p, twin))
    step("POST", base + "save_draft",
         {"project_folder": project, "full_lyrics": "hello world",
          "corrected_segments_text": '{"segment1": "hello world"}',
          "use_srt_durations": "false", "fixed_scene_duration": 5},
         lambda p: pcr.save_draft(p, twin))
    step("POST", base + "load_draft", {"project_folder": project},
         lambda p: pcr.load_draft(p, twin))
    step("GET", base + "list_drafts", {}, lambda p: pcr.list_drafts(twin))
    step("GET", base + "config", {}, lambda p: pcr.config(twin))
    key = {"project_folder": project, "key": "style_theme"}
    for name, payload, fn in (
            ("get_instruction", key, pci.get_instruction),
            ("save_instruction", {**key, "text": "moody neon"},
             pci.save_instruction),
            ("get_instruction", key, pci.get_instruction),
            ("reset_instruction", key, pci.reset_instruction),
            ("save_instruction_preset", {"key": "style_theme",
                                         "name": "Neon", "text": "neon"},
             pci.save_preset),
            ("list_instruction_presets", {"key": "style_theme"},
             pci.list_presets),
            ("load_instruction_preset", {"key": "style_theme",
                                         "name": "Neon"}, pci.load_preset)):
        step("POST", base + name, payload, lambda p, fn=fn: fn(p, twin))
    step("POST", base + "build_whisper_prompt",
         {"project_folder": project, "audio_path": audio,
          "full_lyrics": "line 1\nline 2", "whisper_language": "english"},
         lambda p: pcr.build_whisper_prompt(p, twin))


def _start_storyboard_requests(step, srv, served: str, media: dict) -> None:
    """A 12-scene builder project with two 1080p scene images, then the
    start storyboard's 8 paths on it."""
    from vrgdg_tpu_torch.api import builder as mvb
    from vrgdg_tpu_torch.api import start_storyboard as ssb
    from vrgdg_tpu_torch.server.routes import (_ssb_save,
                                               _ssb_save_reference)

    builder = "/vrgdg/music_builder/"
    project = "{root}/Chip Board"
    step("POST", builder + "new_project", {"project_name": "Chip Board"},
         lambda p: mvb.new_project(p, step.twin))
    step("POST", builder + "save_session",
         {"project_folder": project, "audio_path": media["audio"],
          "session": {"segments": media["segments"]}},
         lambda p: mvb.save_session(p, step.twin))
    body = step("POST", builder + "save_scene_image",
                {"project_folder": project, "scene_number": 1,
                 "image_data": media["data_url"]}, mvb.save_scene_image)
    # the builder's start frames: scene 1's approved image, scene 2's
    # image as inline data
    segments = [dict(seg) for seg in media["segments"]]
    segments[0]["approved_image_path"] = body["saved_path"].replace(
        step.served, "{root}")
    segments[1]["custom_image_data"] = media["data_url"]
    step("POST", builder + "save_session",
         {"project_folder": project, "session": {"segments": segments}},
         lambda p: mvb.save_session(p, step.twin))

    def route(name, payload, fn, status=200):
        return step("POST", "/vrgdg/start_storyboard/" + name,
                    {"project_folder": project, **payload},
                    lambda p: fn(ssb.project_folder(p["project_folder"]), p),
                    status=status)

    board = route("load", {}, lambda f, p: {"storyboard": ssb.load_board(f)})
    if len(board["storyboard"]["scenes"]) != WORKFLOW_SCENES:
        raise AssertionError(f"board: {len(board['storyboard']['scenes'])} "
                             "scenes")
    edited = board["storyboard"]
    edited["scenes"][0]["note"] = "open on the pier"
    route("save", {"storyboard": json.loads(json.dumps(edited).replace(
        served, "{root}"))}, _ssb_save)
    route("import_project_start_frames", {"overwrite": False},
          lambda f, p: ssb.import_project_start_frames(
              f, bool(p.get("overwrite"))))
    route("save_scene_upload", {"scene_number": 3, "frame": "end",
                                "image_data": media["data_url"]},
          lambda f, p: ssb.save_scene_upload(
              f, p.get("image_data"), p.get("scene_number"),
              p.get("frame", "start")))
    route("save_reference", {"scene_number": 4,
                             "image_data": media["data_url"]},
          _ssb_save_reference)
    route("import_latest", {"scene_number": 5,
                            "source_path": media["image2"]},
          lambda f, p: ssb.import_latest(
              f, p.get("scene_number"), p.get("frame", "start"),
              source_path=p.get("source_path", ""),
              downloads_folder=p.get("downloads_folder")))
    body = route("reimport", {},
                 lambda f, p: {"storyboard": ssb.reimport_board(f)})
    route("load", {"project_folder": media["folder"]},
          lambda f, p: {"storyboard": ssb.load_board(f)}, status=400)
    image = body["storyboard"]["scenes"][0]["image_path"]
    _, served_image, _ = srv.call(
        "GET", "/vrgdg/start_storyboard/image",
        params={"project_folder": project.replace("{root}", served),
                "path": image})
    with open(image, "rb") as handle:
        if served_image != handle.read():
            raise AssertionError("the storyboard image route served "
                                 "other bytes")


def _krea2_requests(step, srv, served: str, twin: str, media: dict) -> None:
    """The Krea2 LoRA Studio's 15 paths: a project, 1080p PNG edit pairs
    by multipart (one pair of two sizes, one file that holds no image),
    samples, the XYZ grid, the run plans."""
    import shutil

    from vrgdg_tpu_torch.api import krea2_studio as k2s
    from vrgdg_tpu_torch.api import workflow_runner as wr
    from vrgdg_tpu_torch.runtime import image_io

    base = "/vrgdg/krea2_studio/"
    project = "{root}/VRGDG_Krea2_Studio/Chip Lora"
    step("GET", base + "defaults", {},
         lambda p: k2s.defaults(output_root=twin))
    step("POST", base + "create_project",
         {"project_name": "Chip Lora", "sample_prompt": "portrait of zz",
          "aspect_ratio": "16:9 (Widescreen)"},
         lambda p: k2s.create_project(p, twin))
    wide = os.path.join(media["folder"], "wide.png")
    if not os.path.isfile(wide):
        _still(wide, WORKFLOW_STILL[0] + 8, WORKFLOW_STILL[1], 1903)
    with open(wide, "rb") as handle:
        wide_png = handle.read()
    # lower-case names: the studio pairs a caption by the image's
    # lower-cased stem
    uploads = {
        "control": [("pair_a.png", media["pngs"][0]),
                    ("pair_b.png", media["pngs"][1]),
                    ("pair_c.png", b"not an image at all")],
        "target": [("pair_a.png", media["pngs"][1]),
                   ("pair_a.txt", b"make it night"),
                   ("pair_b.png", wide_png), ("pair_b.txt", b"widen it"),
                   ("pair_c.png", media["pngs"][0]),
                   ("pair_c.txt", b"fix it")]}
    def import_edit(role, files):
        step.before(served)
        data, content_type = _multipart_files(
            [("files", name, blob) for name, blob in files],
            fields={"project_dir": project.replace("{root}", served),
                    "role": role})
        _, body, _ = srv.call("POST", base + "import_edit_files", data=data,
                              headers={"Content-Type": content_type})
        step.before(twin)
        want = {"ok": True, **k2s.import_edit_files(
            project.replace("{root}", twin), role, files)}
        want = json.loads(json.dumps(want))
        if _store_canon(body, served, _WORKFLOW_DROP) \
                != _store_canon(want, twin, _WORKFLOW_DROP):
            raise AssertionError(f"import_edit_files {role} differs from "
                                 "in process")
        return body

    for role, files in uploads.items():
        body = import_edit(role, files)
    problems = body["dataset_sync"]["problems"]
    unreadable = os.path.join(served, "VRGDG_Krea2_Studio", "Chip Lora",
                              "dataset", "control", "pair_c.png")
    if problems != [
            f"pair_b: control {image_io.image_size(media['image2'])} and "
            f"target {image_io.image_size(wide)} dimensions differ",
            f"pair_c: could not validate image dimensions (cannot identify "
            f"image file {unreadable!r})"]:
        raise AssertionError(f"edit pair problems: {problems}")
    step("POST", base + "save_project",
         {"project_dir": project, "caption_user_notes": "night scenes"},
         k2s.save_project)
    step("POST", base + "record_training_result",
         {"project_dir": project, "latest_lora_path": "/loras/chip.safetensors",
          "completed_steps": 250, "total_target_steps": 500,
          "output_name": "chip"}, k2s.record_training_result)
    step("POST", base + "build_sample_prompt",
         {"project_dir": project, "strength_model": 0.8},
         k2s.build_sample_prompt)
    for root in (served, twin):
        os.makedirs(os.path.join(root, "samples_out"))
        for number, path in enumerate((media["image"], media["image2"])):
            shutil.copyfile(path, os.path.join(root, "samples_out",
                                               f"render_{number}.png"))
    for number, steps in enumerate((250, 500)):
        step("POST", base + "save_sample",
             {"project_dir": project, "step": steps,
              "image": {"filename": f"render_{number}.png",
                        "subfolder": "samples_out"}},
             lambda p: k2s.save_sample(p, twin))
    body = step("POST", base + "create_xyz", {"project_dir": project},
                k2s.create_xyz)
    _, served_xyz, _ = srv.call("GET", base + "file",
                                params={"path": body["xyz_path"]})
    with open(body["xyz_path"].replace(served, twin), "rb") as handle:
        if served_xyz != handle.read():
            raise AssertionError("the XYZ grid differs from in process")
    # the two faulty pairs refuse a run plan until they are replaced
    step("POST", base + "train_plan", {"project_dir": project},
         k2s.train_plan, status=400)
    import_edit("control", [("pair_c.png", media["pngs"][1])])
    body = import_edit("target", [("pair_b.png", media["pngs"][0])])
    if body["dataset_sync"]["problems"] or \
            body["dataset_sync"]["pair_count"] != 3:
        raise AssertionError(f"edit pairs: {body['dataset_sync']}")
    step("POST", base + "train_plan", {"project_dir": project},
         k2s.train_plan)
    step("POST", base + "training_progress", {"project_dir": project},
         lambda p: k2s.training_progress(p.get("project_dir", "")))
    step("POST", base + "list_projects", {},
         lambda p: k2s.list_projects(p, twin))
    step("POST", base + "load_project", {"project_dir": project},
         k2s.load_project)

    def clear_memory(p):
        path, prompt = wr.load_api_template("clear_memory")
        return {"workflow_path": path, "prompt": prompt}

    step("POST", base + "build_clear_memory_prompt", {}, clear_memory)
    srv.call("GET", base + "file", params={"path": media["image"]},
             status=404)


def _workflow_commands(folder: str, media: dict) -> dict:
    """The ``workflow`` command's ``list`` and one ``build``, each equal
    to the in-process call; their seconds."""
    from vrgdg_tpu_torch.api import workflow_runner as wr

    payload = workflow_payloads(np.random.default_rng(WORKFLOW_SEED + 1),
                                media)["zimage"]
    seconds, wanted = {}, (
        (["workflow", "list"],
         lambda: {"builders": sorted(wr.BUILDERS) + ["clear_memory"],
                  "templates": dict(wr.TEMPLATES)}),
        (["workflow", "build", "zimage", "--payload", json.dumps(payload),
          "--models-root", media["models"]],
         lambda: wr.build_zimage_prompt(
             payload, catalog=wr.ModelCatalog(root=media["models"]))))
    for argv, twin in wanted:
        started = time.perf_counter()
        printed = _cli_json(argv)
        seconds[" ".join(argv[:2])] = round(time.perf_counter() - started, 3)
        if printed != json.loads(json.dumps(twin(), default=str)):
            raise AssertionError(f"{' '.join(argv[:3])} prints "
                                 f"{str(printed)[:300]}")
    return seconds


def workflow_phase(device) -> None:
    """Phase 19: the workflow runner (with the scene-render routes on a
    recording runner), the prompt creator, the start storyboard and the
    Krea2 LoRA Studio by request on the port's server with the card as
    its device, each request beside the in-process call on a twin root,
    then the ``workflow`` command; none of the six kernels may launch."""
    import random
    import shutil

    from vrgdg_tpu_torch.api import scene_render as sr
    from vrgdg_tpu_torch.api import workflow_runner as wr

    started = time.perf_counter()
    real_root = wr.DEFAULT_OUTPUT_ROOT
    with tempfile.TemporaryDirectory() as folder:
        served = os.path.join(folder, "served")
        twin = os.path.join(folder, "twin")
        os.makedirs(served)
        os.makedirs(twin)
        media = _workflow_media(os.path.join(folder, "media"))
        runners = {served: RecordingRunner(), twin: RecordingRunner()}
        srv = None
        with _frozen_store_clocks(BUILDER_CLOCK) as scene_clock:

            def before(root):
                # each side: its own output root (the default catalog's
                # model root and MiniMax H3's outputs live there), its own
                # ffmpeg recording, the clocks and random at their start
                wr.DEFAULT_OUTPUT_ROOT = root
                sr.set_ffmpeg_runner(runners[root])
                scene_clock.reset()
                random.seed(WORKFLOW_SEED)

            try:
                srv = _Server(device, served)
                step = _Twin(srv, served, twin, before=before,
                             drop=_WORKFLOW_DROP)

                def requests():
                    found = _workflow_runner_requests(step, srv, served, twin,
                                                      media, runners)
                    _prompt_creator_requests(step, srv, served, twin, media)
                    _start_storyboard_requests(step, srv, served, media)
                    _krea2_requests(step, srv, served, twin, media)
                    return found

                found, counts = _counted(requests)
            finally:
                if srv is not None:
                    srv.close()
                sr.set_ffmpeg_runner(None)
                wr.set_default_catalog(None)
                wr.DEFAULT_OUTPUT_ROOT = real_root
        _expect("workflow requests", counts, {})
        trees = (_store_tree(served, _WORKFLOW_DROP),
                 _store_tree(twin, _WORKFLOW_DROP))
        if trees[0] != trees[1]:
            names = sorted(set(trees[0]) ^ set(trees[1])) or sorted(
                name for name in trees[0] if trees[0][name] != trees[1][name])
            raise AssertionError(f"served and twin roots differ: {names[:8]}")
        request_s = time.perf_counter() - started
        wr.DEFAULT_OUTPUT_ROOT = os.path.join(folder, "cli_root")
        try:
            command_seconds, counts = _counted(
                lambda: _workflow_commands(folder, media))
        finally:
            wr.set_default_catalog(None)
            wr.DEFAULT_OUTPUT_ROOT = real_root
        _expect("workflow command", counts, {})
    elapsed = time.perf_counter() - started
    _say("workflow", requests=srv.calls, files=len(trees[0]),
         vs_twin="equal", kernels="none launched",
         ffmpeg=f"'{shutil.which('ffmpeg') or 'absent'}'",
         requests_s=f"{request_s:.2f}",
         commands=json.dumps(command_seconds, separators=(",", ":")),
         ffmpeg_commands=found["ffmpeg_commands"],
         phase_s=f"{elapsed:.2f}", limit_s=WORKFLOW_LIMIT_S)
    if elapsed > WORKFLOW_LIMIT_S:
        raise AssertionError(f"phase 19 took {elapsed:.1f} s, over "
                             f"{WORKFLOW_LIMIT_S} s")


# --------------------------------------------------------------------------
# Phase 20: lyrics, LLM batches, text pickers and graph plans
# --------------------------------------------------------------------------

# a 4-minute song: reference lines; the ASR run hears about 640 words in
# about 80 segments, each segment 6-10 words
LYRICS_SONG = (240.0, 60)                              # seconds, lines
LYRICS_SCENES = 60
LLM_GROUPS = (60, 10)                                  # groups, batch size
PICKER_ITEMS = 500
GRAPH_LORA_SLOTS = 8
TEXT_LIMIT_S = 90.0
TEXT_SEED = 2001
_LYRIC_VOCAB = ("hold", "me", "now", "neon", "rain", "river", "light",
                "run", "away", "tonight", "fire", "heart", "oh", "we",
                "dance", "slow", "under", "the", "city", "dawn", "falling",
                "into", "you", "again", "stars", "gold", "never", "let",
                "go", "home", "ámbar", "it's", "sky", "wild", "echo")
_SHOT_WORDS = ("wide shot", "slow push-in", "hand-held", "close-up",
               "golden backlight", "neon rain", "orbit", "crane up",
               "silhouette", "rim light", "dolly out", "ámbar haze")


def seeded_song(seed: int, lines: int = LYRICS_SONG[1],
                seconds: float = LYRICS_SONG[0]) -> dict:
    """A seeded song in the ASR word-JSON contract (docs/MIGRATION.md
    #3): ``reference`` lyric text (verse headers, stanza breaks, one
    instrumental marker), ``asr`` (``{"segments": [...], "duration"}``,
    word timings; the ASR run drops and misspells a few words) and
    ``backup`` (a plain transcription of the same audio: segment timings
    only, chunked otherwise)."""
    rng = np.random.default_rng(seed)
    sung = [[str(w) for w in rng.choice(_LYRIC_VOCAB,
                                        size=int(rng.integers(9, 15)))]
            for _ in range(lines)]
    text_lines = []
    for n, line in enumerate(sung):
        if n % 8 == 0:
            text_lines.append(f"[Verse {n // 8 + 1}]")
        if n == lines // 2:
            text_lines.append("[instrumental]")
        text_lines.append(" ".join(line))
        if n % 4 == 3:
            text_lines.append("")
    clock = float(rng.uniform(2.0, 4.0))
    words = []
    for n, line in enumerate(sung):
        if n == lines // 2:
            clock += 12.0                                # the break
        for token in line:
            if rng.random() < 0.08:                      # not heard
                clock += float(rng.uniform(0.2, 0.4))
                continue
            heard = token
            if rng.random() < 0.08:                      # misheard
                heard = token[:-1] + str(rng.choice(list("aeioux"))) \
                    if len(token) > 2 else token + "h"
            start = clock
            clock += float(rng.uniform(0.15, 0.32))
            words.append({"word": heard, "start": round(start, 3),
                          "end": round(clock, 3)})
            clock += float(rng.uniform(0.02, 0.08))
        clock += float(rng.uniform(0.2, 1.0))
    duration = round(max(seconds, clock + 2.0), 3)

    def chunked(low, high, with_words):
        segments, cursor = [], 0
        while cursor < len(words):
            chunk = words[cursor:cursor + int(rng.integers(low, high))]
            segment = {"text": " ".join(w["word"] for w in chunk),
                       "start": chunk[0]["start"], "end": chunk[-1]["end"]}
            if with_words:
                segment["words"] = chunk
            segments.append(segment)
            cursor += len(chunk)
        return {"segments": segments, "duration": duration}

    return {"reference": "\n".join(text_lines), "asr": chunked(6, 11, True),
            "backup": chunked(10, 16, False)}


def scene_srt(duration: float, scenes: int) -> str:
    """An SRT of ``scenes`` equal windows over ``duration`` seconds."""
    from vrgdg_tpu_torch.api import builder as mvb

    span = duration / scenes
    return mvb.segments_to_srt([{"start": span * n, "end": span * (n + 1),
                                 "label": f"Scene {n + 1}"}
                                for n in range(scenes)])


def seeded_story_groups(seed: int, count: int) -> dict:
    """A story-group JSON (``{"groups": [...]}``) of ``count`` groups."""
    rng = np.random.default_rng(seed)
    return {"groups": [
        {"group_index": n + 1,
         "subject": " ".join(rng.choice(_LYRIC_VOCAB, size=3)),
         "camera": str(rng.choice(_SHOT_WORDS)),
         "scene_and_lighting": " ".join(rng.choice(_SHOT_WORDS, size=2)),
         "frame": f"frame {int(rng.integers(1, 99))}"}
        for n in range(count)]}


def seeded_llm_reply(seed: int, batch_index: int, size: int) -> str:
    """An LLM's reply for one batch: its ``promptN`` entries, in a code
    fence after a line of chatter."""
    rng = np.random.default_rng([seed, batch_index])
    prompts = {f"prompt{n + 1}": ", ".join(rng.choice(_SHOT_WORDS, size=3))
               + f", beat {batch_index * size + n + 1}"
               for n in range(size)}
    return ("Here are the prompts for this batch:\n```json\n"
            + json.dumps(prompts, ensure_ascii=False, indent=1) + "\n```")


def damaged_prompt_json(text: str) -> str:
    """Prompt JSON damaged as LLM output is: a code fence, a bare key, a
    stray ``*`` before a key, smart quotes and a trailing comma (the
    damage ``llm_batches.clean_prompt_json`` repairs)."""
    text = text.replace('"prompt2":', "prompt2:", 1)
    text = text.replace('"prompt3":', '*prompt3":', 1)
    text = text.replace('"', "\u201c", 1).replace('"', "\u201d", 1)
    return "```json\n" + text.rstrip()[:-1] + ",}\n```"


def seeded_picker_items(seed: int, count: int) -> str:
    """``count`` picker items, one a line, some bulleted or numbered."""
    rng = np.random.default_rng(seed)
    lines = []
    for n in range(count):
        item = f"{rng.choice(_SHOT_WORDS)} over {rng.choice(_LYRIC_VOCAB)}"
        lines.append(("- " if n % 7 == 0 else f"{n}. " if n % 11 == 0
                      else "") + item)
    return "\n".join(lines)


def seeded_lora_payload(seed: int, slots: int, names) -> dict:
    """A two-pass LoRA loader payload: ``slots`` slots of ``names``,
    each with its own first- and second-pass strengths."""
    rng = np.random.default_rng(seed)
    payload = {"variant": "two_pass", "use_custom_loras": True,
               "lora_count": slots}
    for slot, name in enumerate(names[:slots], 1):
        payload[f"lora_{slot}"] = name
        payload[f"first_pass_strength_{slot}"] = round(
            float(rng.uniform(-1.0, 1.0)), 3)
        payload[f"second_pass_strength_{slot}"] = round(
            float(rng.uniform(-1.0, 1.5)), 3)
    return payload


def seeded_lora_pairs(seed: int, names, shape, rank: int) -> dict:
    """``{name: {"w": {"down", "up", "alpha"}}}``: one seeded rank-``rank``
    pair for a ``shape`` weight per LoRA name."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    return {name: {"w": {
        "down": rng.standard_normal((rank, cols), np.float32),
        "up": rng.standard_normal((rows, rank), np.float32) * 0.05,
        "alpha": float(rank) / 2.0}} for name in names}


def seeded_state_payload(seed: int) -> dict:
    """A group-state payload: per-group targets of node ids."""
    rng = np.random.default_rng(seed)
    targets = [{"action": str(rng.choice(["mute", "active", "bypass"])),
                "node_ids": [int(v) for v in rng.integers(1, 400, 4)]}
               for _ in range(6)]
    return {"mode": "group", "group_targets_json": json.dumps(targets),
            "auto_queue_next": True, "queue_delay_seconds": 0}


def text_media(folder: str, seed: int = TEXT_SEED) -> dict:
    """Phase 20's inputs: the seeded song (and its files under
    ``folder`` for the commands), the 60-scene SRT, the story groups,
    the picker list, the LoRA and state payloads."""
    song = seeded_song(seed)
    srt = scene_srt(song["asr"]["duration"], LYRICS_SCENES)
    groups = seeded_story_groups(seed + 1, LLM_GROUPS[0])
    names = [f"style_{n}.safetensors" for n in range(GRAPH_LORA_SLOTS)]
    files = {"asr": os.path.join(folder, "asr_words.json"),
             "backup": os.path.join(folder, "backup_words.json"),
             "reference": os.path.join(folder, "lyrics.txt"),
             "srt": os.path.join(folder, "scenes.srt"),
             "groups": os.path.join(folder, "groups.json"),
             "reply": os.path.join(folder, "reply.txt"),
             "state": os.path.join(folder, "state.json")}
    os.makedirs(folder, exist_ok=True)
    state = seeded_state_payload(seed + 4)
    for key, content in (("asr", json.dumps(song["asr"])),
                         ("backup", json.dumps(song["backup"])),
                         ("reference", song["reference"]), ("srt", srt),
                         ("groups", json.dumps(groups)),
                         ("reply", seeded_llm_reply(seed, 0, LLM_GROUPS[1])),
                         ("state", json.dumps(state))):
        with open(files[key], "w", encoding="utf-8") as handle:
            handle.write(content)
    return {"song": song, "srt": srt, "groups": groups, "files": files,
            "summary": "a river city at dawn, told in sixty beats",
            "items": seeded_picker_items(seed + 2, PICKER_ITEMS),
            "lora_names": names,
            "lora": seeded_lora_payload(seed + 3, GRAPH_LORA_SLOTS, names),
            "state": state}


def _combine_answer(folder: str) -> dict:
    from vrgdg_tpu_torch.runtime import llm_batches as lbx

    result = lbx.combine_batches(folder, "Scene")
    return {key: result[key] for key in
            ("combined", "text", "path", "files", "count")}


def _text_requests(srv: _Server, served: str, twin: str, media: dict) -> dict:
    """Phase 20's requests, each against its twin call: lyrics in every
    segment mode and the sheet; six plan/save rounds, combine, split,
    the combined-file routes, a remake edit and a refused folder;
    pickers; graph plans.  Returns the answers the phase checks on."""
    from vrgdg_tpu_torch.runtime import combined_files as cbf
    from vrgdg_tpu_torch.runtime import graph_plans as gp
    from vrgdg_tpu_torch.runtime import llm_batches as lbx
    from vrgdg_tpu_torch.runtime import lyric_align as lal
    from vrgdg_tpu_torch.runtime import text_pickers as tp

    step = _Twin(srv, served, twin)
    song, found = media["song"], {}
    asr, duration = song["asr"]["segments"], song["asr"]["duration"]

    for mode in lal.SEGMENT_MODES:
        for gaps in ((True, False) if mode == "reference_lines"
                     else (True,)):
            body = step(
                "POST", "/vrgdg/lyrics/timestamped",
                {"segments": asr, "duration": duration,
                 "reference_lyrics": song["reference"],
                 "segment_mode": mode, "include_instrumental_gaps": gaps},
                lambda p: lal.timestamped_lyrics(
                    lal.segments_from_words(p["segments"]), p["duration"],
                    reference_lyrics=p["reference_lyrics"],
                    segment_mode=p["segment_mode"],
                    include_instrumental_gaps=p[
                        "include_instrumental_gaps"]))
            if not body["segment_count"] or body["segments"][-1][
                    "end"] > duration + 1e-6:
                raise AssertionError(f"lyrics {mode}: {str(body)[:300]}")
            found[f"scenes_{mode}_{'gaps' if gaps else 'no_gaps'}"] = \
                body["segment_count"]
    body = step("POST", "/vrgdg/lyrics/sheet",
                {"segments": asr, "srt_text": media["srt"],
                 "reference_lyrics": song["reference"],
                 "backup_segments": song["backup"]["segments"],
                 "native_align": True},
                lambda p: _sheet_answer(lal.extract_window_lyrics(
                    lal.segments_from_words(p["segments"]),
                    lal.srt_windows(p["srt_text"]),
                    reference_lyrics=p["reference_lyrics"],
                    backup_segments=lal.segments_from_words(
                        p["backup_segments"]), native_align=True)))
    if len(body["texts"]) != LYRICS_SCENES:
        raise AssertionError(f"sheet: {len(body['texts'])} texts")

    groups, size = LLM_GROUPS
    llm_twin = os.path.join(twin, "llm_batches")
    for index in range(groups // size):
        plan = step("POST", "/vrgdg/llm_batches/plan",
                    {"story_groups": media["groups"],
                     "story_summary": media["summary"], "batch_size": size},
                    lambda p: lbx.plan_batch(
                        llm_twin, p["story_groups"], p["story_summary"],
                        batch_size=p["batch_size"]))
        if plan["batch_index"] != index \
                or plan["is_final"] != (index == groups // size - 1):
            raise AssertionError(f"plan {index}: {str(plan)[:300]}")
        folder = "{root}" + plan["folder"][len(served):]
        step("POST", "/vrgdg/llm_batches/save",
             {"folder": folder, "batch_index": index,
              "text": seeded_llm_reply(TEXT_SEED, index, size)},
             lambda p: {"path": lbx.save_batch(
                 os.path.realpath(p["folder"]), "Scene", p["batch_index"],
                 p["text"])})
    combined = step("POST", "/vrgdg/llm_batches/combine", {"folder": folder},
                    lambda p: _combine_answer(os.path.realpath(p["folder"])))
    if combined["count"] != groups:
        raise AssertionError(f"combine: {str(combined)[:300]}")
    split = step("POST", "/vrgdg/llm_batches/split",
                 {"text": damaged_prompt_json(combined["text"]),
                  "index": 1},
                 lambda p: lbx.split_prompt_json(p["text"], folder=None,
                                                 index=p["index"]))
    found["split_prompts"] = sum(1 for value in split["prompts"] if value)
    name = os.path.basename(combined["path"])
    state = step("GET", "/vrgdg/llm_batches/combined_files",
                 {"batch_type": "Text2Image"},
                 lambda p: cbf.combined_files_state(llm_twin,
                                                    p["batch_type"], ""))
    values = step("GET", "/vrgdg/llm_batches/combined_file_prompt_values",
                  {"batch_type": "Text2Image", "combined_json_file": name},
                  lambda p: cbf.combined_file_prompt_values(
                      llm_twin, p["batch_type"], p["combined_json_file"]))
    if state["files"] != [name] or values["prompt_count"] != groups:
        raise AssertionError(f"combined files: {state} "
                             f"{values['prompt_count']}")
    edit = step("POST", "/vrgdg/llm_batches/combined_file_update_prompts",
                {"remake_mode": True, "batch_type": "Text2Image",
                 "combined_json_file": name,
                 "updates": [{"prompt_number": 7, "prompt": "re-shot at dusk",
                              "image_index": "2, 3"}]},
                lambda p: cbf.update_combined_file_prompts(llm_twin, p))
    if edit["updated"] < 1:
        raise AssertionError(f"prompt edit: {edit}")
    for root in (served, twin):
        remake = os.path.join(root, "clips", "remake")
        os.makedirs(remake)
        for number in (3, 12, 41):
            open(os.path.join(remake, f"video_{number}_take.mp4"), "wb").close()
    step("POST", "/vrgdg/llm_batches/remake_prompt_indexes",
         {"folder_path": "{root}/clips"},
         lambda p: cbf.remake_prompt_state(p["folder_path"]))
    _, refused, _ = srv.call("POST", "/vrgdg/llm_batches/save",
                             {"folder": served, "batch_index": 0,
                              "text": "{}"}, status=400)
    if refused["error"] != \
            "folder must live under the managed llm_batches root":
        raise AssertionError(f"refusal: {refused}")

    for mode in tp.SELECTION_MODES:
        picked = step("POST", "/vrgdg/text_tools/pick",
                      {"index": 137, "items": media["items"],
                       "label": "Shot", "selection_mode": mode, "seed": 42,
                       "pick_count": 2},
                      lambda p: tp.pick_text(
                          p["index"], p["items"], label=p["label"],
                          selection_mode=p["selection_mode"], seed=p["seed"],
                          pick_count=p["pick_count"]), flat=False)
        if picked["result"]["item_count"] != PICKER_ITEMS:
            raise AssertionError(f"pick {mode}: {str(picked)[:300]}")
    pickers = [{"items": media["items"], "label": "Shot", "index": 9,
                "selection_mode": "random no repeat", "seed": 5},
               {"preset": "Lighting", "index": 3},
               {"items": "# LABEL: Mood\n# PICK_COUNT: 2\ncalm\nwild\nlost",
                "index": 1}]
    step("POST", "/vrgdg/text_tools/multi_pick",
         {"pickers": pickers, "joiner": "comma"},
         lambda p: tp.run_multi_picker(p["pickers"], p["joiner"]), flat=False)

    lora_plan = step("POST", "/vrgdg/graph/lora_plan", media["lora"],
                     gp.lora_plan_from_payload, flat=False)["result"]
    step("POST", "/vrgdg/graph/state_plan", media["state"],
         gp.state_plan_from_payload, flat=False)
    if len(lora_plan["first_pass"]) != GRAPH_LORA_SLOTS \
            or len(lora_plan["second_pass"]) != GRAPH_LORA_SLOTS:
        raise AssertionError(f"lora plan: {lora_plan}")
    found["lora_plan"] = lora_plan
    return found


def _sheet_answer(out: dict) -> dict:
    return {"sheet": out["sheet"], "texts": out["texts"],
            "windows": [list(window) for window in out["windows"]]}


def _merge_plan_on_card(device, plan: dict, reps: int = 5) -> dict:
    """The graph route's LoRA plan applied by ``ops.lora.apply_lora_plan``
    to a 4096 x 4096 weight with rank-16 pairs on the card, held against
    the same call on the CPU; its CUDA-event ms."""
    from vrgdg_tpu_torch.ops import lora

    rows, cols, rank = LORA
    names = sorted({name for name, _ in plan["first_pass"]})
    pairs = seeded_lora_pairs(TEXT_SEED + 5, names, (rows, cols), rank)
    weight = torch.from_numpy(np.random.default_rng(TEXT_SEED + 6)
                              .standard_normal((rows, cols), np.float32))
    want = lora.apply_lora_plan({"w": weight}, plan, pairs.__getitem__)
    on_card = {"w": weight.to(device)}
    got = lora.apply_lora_plan(on_card, plan, pairs.__getitem__)
    relative = max(_max_err(got[key]["w"].cpu(), want[key]["w"])
                   / float(want[key]["w"].abs().max())
                   for key in ("first_pass", "second_pass"))
    _check("apply_lora_plan card vs CPU (relative)", relative,
           BOUNDS["lora_relative"])
    if got["first_pass"]["w"].device != torch.device(device):
        raise AssertionError("apply_lora_plan left the card")
    card_pairs = {name: {"w": {key: (torch.from_numpy(value).to(device)
                                     if isinstance(value, np.ndarray)
                                     else value)
                               for key, value in pair["w"].items()}}
                  for name, pair in pairs.items()}
    ms = _cuda_ms(lambda: lora.apply_lora_plan(on_card, plan,
                                               card_pairs.__getitem__), reps)
    merges = len(plan["first_pass"]) + len(plan["second_pass"])
    _say("graph-lora-merge", weight=f"{rows}x{cols}", rank=rank,
         merges=merges, relative_err=f"{relative:.3g}"
         f"<={BOUNDS['lora_relative']:g}", ms=f"{ms:.4f}",
         ms_per_merge=f"{ms / merges:.4f}")
    return {"relative": relative, "ms": ms, "merges": merges}


def _lut_examples(device, folder: str) -> dict:
    """The port's LUT examples tool on the card into ``folder``, each
    graded frame held against the CPU's."""
    import cv2

    from vrgdg_tpu_torch.tools import generate_lut_examples as gle

    started = time.perf_counter()
    graded = gle.grade_examples(device=device)
    written = gle.write_examples(graded, folder)
    seconds = time.perf_counter() - started
    plain = gle.grade_examples(device="cpu")
    worst, levels = 0.0, 0
    for name, frame in graded.items():
        worst = max(worst, float(np.abs(frame - plain[name]).max()))
        levels += int((gle.quantize(frame) != gle.quantize(plain[name]))
                      .sum())
    _check("LUT examples card vs CPU", worst, BOUNDS["lut_examples"])
    for path in written:
        image = cv2.imread(path)
        if image is None or image.shape != (gle.HEIGHT, gle.WIDTH, 3):
            raise AssertionError(f"LUT example {path} does not decode")
    _say("lut-examples", luts=len(written), seconds=f"{seconds:.3f}",
         max_abs_err=f"{worst:.3g}<={BOUNDS['lut_examples']:g}",
         uint8_values_apart=levels, folder="temporary")
    return {"luts": len(written), "seconds": seconds}


def _text_commands(folder: str, media: dict) -> dict:
    """The ``lyrics``, ``llm-batch`` and ``graph`` commands, each in a
    process of its own (three lanes side by side; the ``llm-batch``
    actions in order), each output equal to the in-process call; their
    seconds."""
    import threading

    from vrgdg_tpu_torch.runtime import graph_plans as gp
    from vrgdg_tpu_torch.runtime import llm_batches as lbx
    from vrgdg_tpu_torch.runtime import lyric_align as lal

    files, song = media["files"], media["song"]
    repo = os.path.dirname(os.path.abspath(__file__))
    seconds, failures = {}, []
    os.makedirs(folder)

    def run(*argv, label=None):
        started = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "vrgdg_tpu_torch.cli", *argv], cwd=repo,
            capture_output=True, text=True, timeout=300, check=False)
        seconds[label or " ".join(argv[:2])] = round(
            time.perf_counter() - started, 3)
        if done.returncode != 0:
            raise AssertionError(f"{' '.join(argv[:2])} exited "
                                 f"{done.returncode}: {done.stderr[-2000:]}")
        return done.stdout

    segments = lal.segments_from_words(song["asr"]["segments"])
    lyrics_json = os.path.join(folder, "timestamped.json")

    def lyrics():
        printed = json.loads(run("lyrics", files["asr"], "--reference",
                                 files["reference"], "--segment-mode",
                                 "reference_lines", "-o", lyrics_json,
                                 label="lyrics"))
        with open(lyrics_json, encoding="utf-8") as handle:
            written = json.load(handle)
        want = lal.timestamped_lyrics(
            segments, song["asr"]["duration"],
            reference_lyrics=song["reference"],
            segment_mode="reference_lines")
        if written != json.loads(json.dumps(want)) or printed != {
                "output": lyrics_json, "segment_count":
                want["segment_count"], "duration": want["duration"]}:
            raise AssertionError(f"lyrics command: {printed}")
        sheet = run("lyrics", files["asr"], "--reference", files["reference"],
                    "--sheet-srt", files["srt"], "--backup", files["backup"],
                    "--native-align", label="lyrics --sheet-srt")
        want = lal.extract_window_lyrics(
            segments, lal.srt_windows(media["srt"]),
            reference_lyrics=song["reference"],
            backup_segments=lal.segments_from_words(
                song["backup"]["segments"]), native_align=True)["sheet"]
        if sheet != want + "\n":
            raise AssertionError(f"lyrics --sheet-srt: {sheet[:300]}")

    def llm_batch():
        steps = {}
        for side in ("command", "twin"):
            root = os.path.join(folder, side, "llm_batches")
            if side == "command":
                plan = json.loads(run("llm-batch", "plan", root, "--groups",
                                      files["groups"], "--summary",
                                      media["summary"]))
                saved = json.loads(run("llm-batch", "save", plan["folder"],
                                       "--index", "0", "--text",
                                       files["reply"]))
                combined = json.loads(run("llm-batch", "combine",
                                          plan["folder"]))
                split = json.loads(run("llm-batch", "split", combined["path"],
                                       "--index", "0"))
            else:
                plan = lbx.plan_batch(root, media["groups"], media["summary"])
                with open(files["reply"], encoding="utf-8-sig") as handle:
                    saved = {"path": lbx.save_batch(plan["folder"], "Scene",
                                                    0, handle.read())}
                result = lbx.combine_batches(plan["folder"], "Scene")
                combined = {key: result[key]
                            for key in ("path", "files", "count")}
                with open(combined["path"], encoding="utf-8-sig") as handle:
                    split = lbx.split_prompt_json(handle.read(), index=0)
            steps[side] = _store_canon(json.loads(json.dumps(
                [plan, saved, combined, split], default=str)),
                os.path.join(folder, side))
        if steps["command"] != steps["twin"]:
            raise AssertionError(f"llm-batch commands: "
                                 f"{str(steps['command'])[:600]}")

    def graph():
        for argv, want in (
                (["graph", "lora-plan", "--payload",
                  json.dumps(media["lora"])],
                 gp.lora_plan_from_payload(media["lora"])),
                (["graph", "state-plan", "--payload", "@" + files["state"]],
                 gp.state_plan_from_payload(media["state"]))):
            if json.loads(run(*argv)) != json.loads(json.dumps(want)):
                raise AssertionError(f"{' '.join(argv[:2])} differs")

    def lane(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            failures.append(exc)

    lanes = [threading.Thread(target=lane, args=(fn,))
             for fn in (lyrics, llm_batch, graph)]
    for thread in lanes:
        thread.start()
    for thread in lanes:
        thread.join(timeout=600)
    if failures or any(thread.is_alive() for thread in lanes):
        raise AssertionError(f"commands failed: {failures}")
    return seconds


def text_phase(device) -> None:
    """Phase 20: lyrics, LLM batches and combined files, text pickers and
    graph plans by request on the port's server with the card as its
    device, each answer against its in-process twin; the graph's LoRA
    plan applied on the card; the ``lyrics``, ``llm-batch`` and ``graph``
    commands in processes of their own; the LUT examples tool on the
    card.  None of the six kernels may launch.  The commands' processes
    (about 10 s each to start on the card's host) run beside the rest."""
    from concurrent.futures import ThreadPoolExecutor

    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder, \
            ThreadPoolExecutor(1) as pool:
        served = os.path.join(folder, "served")
        twin = os.path.join(folder, "twin")
        os.makedirs(served)
        os.makedirs(twin)
        media = text_media(os.path.join(folder, "media"))
        commands = pool.submit(_text_commands, os.path.join(folder, "cli"),
                               media)
        srv = None
        try:
            srv = _Server(device, served)
            found, counts = _counted(
                lambda: _text_requests(srv, served, twin, media))
        finally:
            if srv is not None:
                srv.close()
        _expect("text requests", counts, {})
        trees = (_store_tree(served), _store_tree(twin))
        if trees[0] != trees[1]:
            names = sorted(set(trees[0]) ^ set(trees[1])) or sorted(
                name for name in trees[0] if trees[0][name] != trees[1][name])
            raise AssertionError(f"served and twin roots differ: {names[:8]}")
        request_s = time.perf_counter() - started
        merged, counts = _counted(
            lambda: _merge_plan_on_card(device, found.pop("lora_plan")))
        _expect("graph LoRA merge", counts, {})
        examples, counts = _counted(
            lambda: _lut_examples(device, os.path.join(folder, "examples")))
        _expect("LUT examples", counts, {})
        command_seconds = commands.result(timeout=600)
    elapsed = time.perf_counter() - started
    _say("text", requests=srv.calls, files=len(trees[0]), vs_twin="equal",
         kernels="none launched", requests_s=f"{request_s:.2f}",
         scenes=json.dumps(found, separators=(",", ":")),
         lora_merge_ms=f"{merged['ms']:.4f}",
         lut_examples_s=f"{examples['seconds']:.3f}",
         commands=json.dumps(command_seconds, separators=(",", ":")),
         phase_s=f"{elapsed:.2f}", limit_s=TEXT_LIMIT_S)
    if elapsed > TEXT_LIMIT_S:
        raise AssertionError(f"phase 20 took {elapsed:.1f} s, over "
                             f"{TEXT_LIMIT_S} s")


# phase 21: the port's bench at 8 steps a chain without the host-CPU
# oracle (the full bench runs 64: python3 -m vrgdg_tpu_torch.bench), the
# perf lab's LUT variants against apply_lut on the card, and its layout
# A/B (plane vs rowmajor) at 4K x 2 over 2 steps
BENCH_STEPS = 8
BENCH_LAYOUT_STEPS = 2
BENCH_LIMIT_S = 60.0
# kernels each layout of the A/B must launch
LAYOUT_KERNELS = {"plane": ("grade_phase1_planes", "grade_phase2_planes"),
                  "rowmajor": ("grade_phase1", "grade_phase2_planes")}


def _launched(label: str, launches: dict, kernels) -> None:
    for kernel in kernels:
        if not launches.get(kernel):
            raise AssertionError(f"{label} launched no {kernel}: {launches}")


def bench_phase(device, card: str) -> dict:
    """Phase 21: ``vrgdg_tpu_torch.bench.run`` on the card (every config
    and stage with fps > 0, the fused configs launching both grade
    kernels, the kernel-grain config and the enhance step ``film_grain``),
    the perf lab's LUT variants within 1e-6 of ``apply_lut`` and its
    plane/rowmajor A/B launching the planes kernels.  Returns the launches of the bench's
    configs and the A/B, each counted from 0 around its own run."""
    from vrgdg_tpu_torch import bench
    from vrgdg_tpu_torch.tools import perf_lab

    started = time.perf_counter()
    result = bench.run(device, steps=BENCH_STEPS, oracle=False)
    configs = result["configs"]
    launches: dict = {}
    for name, detail in configs.items():
        if not detail["fps"] > 0:
            raise AssertionError(f"bench {name}: fps {detail['fps']}")
        _add(launches, detail["launches"])
    for name in ("fused_4k_pallas2", "fused_4k_pallas2_adjust"):
        _launched(f"bench {name}", configs[name]["launches"],
                  ("grade_phase1", "grade_phase2"))
    for name in ("fused_4k_pallas_grain", "enhance_step_1080p_to_4k"):
        _launched(f"bench {name}", configs[name]["launches"], ("film_grain",))
    stages = result["stage_ms_per_4k_frame"]
    if set(stages) != set(bench.STAGES) or not all(
            ms > 0 for ms in stages.values()):
        raise AssertionError(f"bench stages: {stages}")
    parity = {name: perf_lab.parity(name, device)
              for name in perf_lab.VARIANTS}
    layouts = perf_lab.phase1_layout_ab(steps=BENCH_LAYOUT_STEPS,
                                        device=device, card=card)
    for layout, kernels in LAYOUT_KERNELS.items():
        _launched(f"perf_lab {layout}", layouts[layout]["launches"], kernels)
        _add(launches, layouts[layout]["launches"])
    elapsed = time.perf_counter() - started
    _say("bench", steps=BENCH_STEPS,
         fps=json.dumps({k: round(v["fps"], 2) for k, v in configs.items()},
                        separators=(",", ":")),
         device_ms_per_frame=json.dumps(
             {k: round(v["device_ms_per_frame"], 4)
              for k, v in configs.items()}, separators=(",", ":")),
         stage_ms=json.dumps({k: round(v, 4) for k, v in stages.items()},
                             separators=(",", ":")),
         elementwise_gbps=f"{result['elementwise_gbps']:.1f}",
         gather_grows_per_s=f"{result['gather_grows_per_s']:.4f}",
         copy_4k_x2_ms=f"{result['copy_4k_x2_ms']:.4f}",
         headline=f"'{result['headline_mode']}'",
         lut_variant_max_err=f"{max(parity.values()):.3g}<=1e-6",
         layout_device_ms=json.dumps(
             {k: round(v["device_ms_per_batch"], 4)
              for k, v in layouts.items()}, separators=(",", ":")),
         launches=json.dumps(launches, separators=(",", ":")),
         phase_s=f"{elapsed:.2f}", limit_s=BENCH_LIMIT_S, card=f"'{card}'")
    if elapsed > BENCH_LIMIT_S:
        raise AssertionError(f"phase 21 took {elapsed:.1f} s, over "
                             f"{BENCH_LIMIT_S} s")
    return launches


# --------------------------------------------------------------------------
# Phase 22: every adjust slider grade_phase1 fuses, and film_grain's edges
# --------------------------------------------------------------------------

# seeded uniform frames made with numpy, the flagship LUT at 8, colour
# match 0.7, unsharp 1.5 zero border, grain off; each of the eleven
# sliders alone (the bipolar ones at -100, 37 and 100, the intensity-only
# ones at 37 and 100), then all eleven from a seeded draw within +-80
SWEEP_SHAPE = (2, 64, 3840)
SWEEP_SEED = 2201
SWEEP_BIPOLAR = ("temperature", "tint", "exposure", "contrast",
                 "saturation", "highlights", "shadows", "whites", "blacks")
SWEEP_INTENSITY = ("vignette", "fade")
# Under colour match these leave a and b (saturation) or the whole frame
# (contrast) flat, and the transfer scales a flat channel's float32
# rounding by ref_std / 1e-5 (the reference's math, ROADMAP queue 3): only
# phase 1 is judged, the stack's difference is printed
SWEEP_FLAT = (("saturation", -100.0), ("contrast", -100.0))
SWEEP_LIMIT_S = 30.0
# film_grain's edges at the sweep's shape: (intensity, saturation_mix,
# seed, frame_start); the last one's key wraps past 2**31 - 1
GRAIN_EDGES = ((0.05, 0.0, 42, 5), (0.05, 1.0, 42, 5), (1.0, 0.5, 42, 5),
               (0.05, 0.5, 2 ** 31 - 1, 5))


def sweep_cases() -> list:
    """``(slider or "all", settings)`` of phase 22, in order."""
    cases = [(name, {name: value}) for name in SWEEP_BIPOLAR
             for value in (-100.0, 37.0, 100.0)]
    cases += [(name, {name: value}) for name in SWEEP_INTENSITY
              for value in (37.0, 100.0)]
    rng = np.random.default_rng(SWEEP_SEED)
    drawn = {name: float(rng.uniform(-80.0, 80.0)) for name in SWEEP_BIPOLAR}
    drawn.update({name: float(rng.uniform(0.0, 80.0))
                  for name in SWEEP_INTENSITY})
    return cases + [("all", drawn)]


def partials_err(lab: torch.Tensor, partials: torch.Tensor) -> float:
    """The rule for phase 1's partials (tests/test_torch_cuda.py uses it
    too): each frame's rows are the float64 chunk sums (and sums of
    squares) of the kernel's own BHWC LAB, within rtol 1e-12 and atol
    1e-9; returns the largest difference and raises outside."""
    from vrgdg_tpu_torch.kernels.grade_cuda import PHASE1_BLOCK

    batch, pixels = lab.shape[0], lab.shape[1] * lab.shape[2]
    rows = torch.nn.functional.pad(
        lab.reshape(batch, -1, 3).double(),
        (0, 0, 0, partials.shape[1] * PHASE1_BLOCK - pixels))
    rows = rows.reshape(batch, partials.shape[1], PHASE1_BLOCK, 3)
    sums = torch.cat([rows.sum(2), (rows * rows).sum(2)], dim=-1)
    if not torch.allclose(partials, sums, rtol=1e-12, atol=1e-9):
        raise AssertionError("phase 1's partials are not the chunk sums of "
                             "its LAB")
    return _max_err(partials, sums)


def coefficients_err(lab_k, lab_p, coeff_k, coeff_p, ref_std,
                     strength: float) -> float:
    """The rule for the stats barrier's A/B at every frame size
    (tests/test_torch_cuda.py uses it too).  A = s sigma_ref / sigma +
    (1 - s) and B = s (mu_ref - mu A') divide by each frame's LAB std, so
    the kernel's and the plain version's LAB, an ulp or two apart, move
    them by up to s sigma_ref |d sigma| / sigma^2 (and B also by |d mu|
    gain + |mu| d gain).  That change, measured from the two BHWC LABs in
    float64, twice over, plus 1e-5 is the bound: about 1e-5 on frames of
    many pixels, where the ulps average out, and wider on a frame of a
    few.  Returns the largest error and raises outside."""
    def stats(lab):
        x = lab.reshape(lab.shape[0], -1, 3).double()
        return x.mean(1), x.std(1) + 1e-5

    (mean_k, std_k), (mean_p, std_p) = stats(lab_k), stats(lab_p)
    ref = ref_std.reshape(1, 3).double()
    gain = ref / torch.minimum(std_k, std_p)
    d_gain = ref * (std_k - std_p).abs() / (std_k * std_p)
    d_b = (mean_k - mean_p).abs() * gain \
        + torch.maximum(mean_k.abs(), mean_p.abs()) * d_gain
    bound = 1e-5 + 2 * strength * torch.cat([d_gain, d_b], dim=1)
    err = (coeff_k.double() - coeff_p.double()).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"A/B coefficients {float(err.max())} past "
                             f"their bound by {float((err - bound).max())}")
    return float(err.max())


def _grain_edges(frames) -> float:
    """``film_grain`` at :data:`GRAIN_EDGES` against its plain version, and
    each batch of 2 bit for bit as frames 0 and 1 graded apart."""
    from vrgdg_tpu_torch.kernels.grain_cuda import film_grain_kernel
    from vrgdg_tpu_torch.ops.grain import film_grain

    worst = 0.0
    for intensity, mix, seed, start in GRAIN_EDGES:
        label = f"grain {intensity:g}/{mix:g}/seed {seed}/start {start}"
        got = film_grain_kernel(frames, intensity, mix, seed,
                                frame_start=start)
        err = _max_err(got, film_grain(frames, intensity, mix, seed,
                                       frame_start=start))
        _check(label, err, BOUNDS["rgb_grain_on"])
        split = torch.cat([
            film_grain_kernel(frames[0:1], intensity, mix, seed, start),
            film_grain_kernel(frames[1:2], intensity, mix, seed, start + 1)])
        if not torch.equal(got, split):
            raise AssertionError(f"{label}: frames[0:2] != frames[0:1] + "
                                 "frames[1:2]")
        _say("grain-edge", intensity=intensity, saturation_mix=mix,
             seed=seed, frame_start=start,
             err=f"{err:.3g}<={BOUNDS['rgb_grain_on']:g}",
             split_1_1="bit-identical")
        worst = max(worst, err)
    return worst


def adjust_sweep_phase(device, card: str) -> tuple[dict, dict]:
    """Phase 22: for each case of :func:`sweep_cases`, ``grade_phase1``
    against its plain version (LAB, partials; the A/B coefficients too
    where the frame is not flat) and the fused stack through
    ``grade_prepared`` against the same stack on the plain versions (RGB,
    grain off; printed only for :data:`SWEEP_FLAT`); then ``film_grain``'s
    edges.  Returns the stack runs' launches, each counted from 0 around
    its run, and the worst ``grade_phase1`` and ``film_grain`` errors."""
    from vrgdg_tpu_torch.api import appliers
    from vrgdg_tpu_torch.kernels import grade_cuda as gc
    from vrgdg_tpu_torch.ops.grade import (_active_adjust, grade_prepared,
                                           prepare_operands)

    started = time.perf_counter()
    _, lut, ref_stats = _stack(device)
    frames = torch.from_numpy(np.random.default_rng(SWEEP_SEED).uniform(
        0.0, 1.0, (*SWEEP_SHAPE, 3)).astype(np.float32)).to(device)
    pixels = SWEEP_SHAPE[1] * SWEEP_SHAPE[2]
    strength = FLAGSHIP["match_strength"]
    launches: dict = {}
    rows: dict = {}
    for slider, adjust in sweep_cases():
        config = appliers.grade_config(
            lut=lut, lut_strength=FLAGSHIP["lut_strength"], adjust=adjust,
            ref_stats=ref_stats, match_strength=strength,
            sharpen_strength=FLAGSHIP["sharpen_strength"],
            fused_mode="fused")
        operands = prepare_operands(config, lut=lut, ref_stats=ref_stats,
                                    device=device)
        table, dmin, dmax, ref_mean, ref_std = operands
        settings = _active_adjust(config)
        blend = config.lut.strength / 10.0
        domain = gc.lut_domain(dmin, dmax)
        label = f"sweep {json.dumps(adjust)}"
        lab_k, part_k = gc.phase1(frames, table, domain, blend=blend,
                                  adjust=settings)
        lab_p, part_p = gc.phase1_plain(frames, table, domain, blend=blend,
                                        adjust=settings)
        lab_err = _max_err(lab_k, lab_p)
        _check(f"{label} LAB", lab_err, BOUNDS["lab"])
        row = rows.setdefault(slider, {"values": [], "lab": 0.0,
                                       "partials": 0.0, "coeff": 0.0,
                                       "rgb": 0.0, "rgb_flat": []})
        row["values"].append(",".join(
            f"{name}={value:.2f}" for name, value in adjust.items())
            if slider == "all" else f"{adjust[slider]:g}")
        row["lab"] = max(row["lab"], lab_err)
        row["partials"] = max(row["partials"], partials_err(lab_k, part_k))
        got, counts = _counted(lambda: grade_prepared(frames, config,
                                                      *operands))
        _expect(label, counts, {"grade_phase1": 1, "grade_phase2": 1})
        _add(launches, counts)
        want = gc.fused_post_gather_plain(
            frames, table, dmin, dmax, ref_mean, ref_std, 0, blend=blend,
            match_strength=strength,
            sharpen_strength=config.sharpen.strength, grain_intensity=0.0,
            saturation_mix=0.5, adjust=settings)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: the fused stack gave non-finite "
                                 "values")
        rgb_err = _max_err(got, want)
        if (slider, adjust.get(slider)) in SWEEP_FLAT:
            row["rgb_flat"].append(f"{rgb_err:.3g}")
        else:
            coeff_k, coeff_p = (gc.stats_barrier(p, pixels, ref_mean,
                                                 ref_std, strength)
                                for p in (part_k, part_p))
            row["coeff"] = max(row["coeff"], coefficients_err(
                lab_k, lab_p, coeff_k, coeff_p, ref_std, strength))
            _check(f"{label} RGB", rgb_err, BOUNDS["rgb_grain_off"])
            row["rgb"] = max(row["rgb"], rgb_err)
        del lab_k, lab_p, part_k, part_p, got, want
    for slider, row in rows.items():
        _say("adjust-sweep", slider=slider, values=",".join(row["values"]),
             lab_err=f"{row['lab']:.3g}<={BOUNDS['lab']:g}",
             partials_err=f"{row['partials']:.3g}",
             coeff_err=f"{row['coeff']:.3g}",
             rgb_err=f"{row['rgb']:.3g}<={BOUNDS['rgb_grain_off']:g}",
             **({"rgb_err_flat_unjudged": ",".join(row["rgb_flat"])}
                if row["rgb_flat"] else {}))
    errors = {"grade_phase1": max(row["lab"] for row in rows.values()),
              "film_grain": _grain_edges(frames)}
    elapsed = time.perf_counter() - started
    _say("adjust-sweep", shape=_label(SWEEP_SHAPE),
         cases=len(sweep_cases()),
         launches=json.dumps(launches, separators=(",", ":")),
         phase_s=f"{elapsed:.2f}", limit_s=SWEEP_LIMIT_S, card=f"'{card}'")
    del frames
    torch.cuda.empty_cache()
    if elapsed > SWEEP_LIMIT_S:
        raise AssertionError(f"phase 22 took {elapsed:.1f} s, over "
                             f"{SWEEP_LIMIT_S} s")
    return launches, errors


def lut_phase(device, card: str, reps=10) -> tuple[float, tuple, dict]:
    """Phase 23: ``lut_apply`` against its plain version on the card, and
    Apply LUT's stream.  Returns the kernel's max abs error (0.0: any
    other bit fails the phase), its (kernel, plain) ms at
    :data:`TIMED_SHAPE` on uniform frames and the stream's launches."""
    from vrgdg_tpu_torch.api import appliers, paths
    from vrgdg_tpu_torch.core.cube import GLOBAL_LUT_CACHE, corner_bundle
    from vrgdg_tpu_torch.ops.lut import (apply_lut_bundle,
                                         apply_lut_bundle_plain)

    lut = GLOBAL_LUT_CACHE.load(paths.safe_lut_path(FLAGSHIP["lut_name"]))
    bundle = torch.from_numpy(corner_bundle(lut.table)).to(device)
    dmin = torch.from_numpy(np.float32(lut.domain_min)).to(device)
    dmax = torch.from_numpy(np.float32(lut.domain_max)).to(device)
    timed = None
    for index, shape in enumerate(LUT_SHAPES):
        pixels = int(np.prod(shape))
        bytes_ms = (24 * pixels + bundle.numel() * 4) / HBM_BYTES_PER_S * 1e3
        gather_bytes = LUT_GATHER_BYTES * pixels
        for content, frames in (
                ("uniform", _frames(shape, 230 + index, device)),
                ("smooth", _smooth_frames(shape, 240 + index, device))):
            def kernel():
                return apply_lut_bundle(frames, bundle, dmin, dmax,
                                        LUT_STRENGTH)

            def plain():
                return apply_lut_bundle_plain(frames, bundle, dmin, dmax,
                                              LUT_STRENGTH)

            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"lut_apply differs from its plain "
                                     f"version at {shape}, {content}")
            kernel_ms, plain_ms = _timed_pair(kernel, plain, reps)
            if tuple(shape) == TIMED_SHAPE and content == "uniform":
                timed = (kernel_ms, plain_ms)
            _say("lut-kernel", shape=_label(shape), content=content,
                 vs_plain="bit-identical", lut_apply_ms=f"{kernel_ms:.4f}",
                 plain_ms=f"{plain_ms:.4f}", bytes_ms=f"{bytes_ms:.4f}",
                 l2_gather_gb=f"{gather_bytes / 1e9:.3f}",
                 l2_gather_tb_s=f"{gather_bytes / kernel_ms / 1e9:.3f}",
                 share_of_bytes=f"{100 * bytes_ms / kernel_ms:.1f}%",
                 card=f"'{card}'")
            del frames
        torch.cuda.empty_cache()
    effect, _ = appliers._lut_effect(FLAGSHIP["lut_name"], LUT_STRENGTH,
                                     None, device)
    launches = _stream_runs("lut-stream", effect, device, card,
                            (LUT_STREAM,), ("lut_apply",), per_batch=True)
    return 0.0, timed, launches


# phase 24: the enhancer's fused step at the benchmark's settings
# (perfbench/configs/enhance_4k.json), 720p and 1080p to 4K, one frame
ENHANCE_CELL = dict(upscale_resolution="4k", sharpen_strength=0.5,
                    grain_enabled=True, grain_intensity=0.04,
                    saturation_mix=0.5, seed=42, use_accelerator=True)
ENHANCE_KERNEL_SIZES = (((720, 1280), (2160, 3840)),
                        ((1080, 1920), (2160, 3840)))


def _enhance_least_ms(src, dst) -> tuple[float, str]:
    """The enhance step's least time (perfbench's enhance_step_roofline):
    uint8 in and out at the HBM peak, or Lanczos-4's 8 taps a sample in
    the cheaper pass order at the float32 peak, whichever is longer."""
    (sh, sw), (dh, dw) = src, dst
    nbytes = 3 * (sh * sw + dh * dw)
    flops = 2 * 8 * 3 * min(dh * sw + dh * dw, sh * dw + dh * dw)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / FP32_OPS_PER_S * 1e3}
    bound_by = max(terms, key=terms.get)
    return terms[bound_by], bound_by


def enhance_kernel_phase(device, card: str, reps=20) -> None:
    """Phase 24: ``enhance_step`` against the torch chain it replaces on
    the card (dequantize -> ``_enhance_step`` -> quantize; at most one
    level apart on at most 0.1% of values) at 720p and 1080p -> 4K x 1,
    both timed by CUDA events beside the step's least time, and the fused
    step's peak device memory (no float32 4K frame)."""
    from vrgdg_tpu_torch.core.params import EnhancerSettings
    from vrgdg_tpu_torch.jobs import enhancer
    from vrgdg_tpu_torch.kernels import enhance_cuda
    from vrgdg_tpu_torch.runtime import video_io

    settings = EnhancerSettings.normalize(ENHANCE_CELL)
    for index, (src, dst) in enumerate(ENHANCE_KERNEL_SIZES):
        generator = torch.Generator(device="cpu").manual_seed(250 + index)
        frames = torch.randint(0, 256, (1, *src, 3), dtype=torch.uint8,
                               generator=generator).to(device)

        def kernel():
            return enhancer._enhance_step_uint8(frames, settings, *dst, 0)

        def chain():
            return video_io.quantize_on_device(enhancer._enhance_step(
                video_io.dequantize_on_device(frames), settings, *dst, 0))

        got, want = kernel(), chain()
        diff = (got.int() - want.int()).abs()
        share = float((diff > 0).float().mean())
        if int(diff.max()) > 1 or share > 1e-3:
            raise AssertionError(f"enhance_step vs the chain at {src}: max "
                                 f"{int(diff.max())} levels, {share:.2e}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        kernel()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - before
        if peak >= 4 * got.numel():
            raise AssertionError(f"the fused step allocated {peak} bytes")
        kernel_ms, chain_ms = _timed_pair(kernel, chain, reps)
        least_ms, bound_by = _enhance_least_ms(src, dst)
        _say("enhance-kernel", size=f"{_label(src)}->{_label(dst)}x1",
             vs_chain=f"max_{int(diff.max())}_share_{share:.2e}",
             enhance_step_ms=f"{kernel_ms:.4f}", chain_ms=f"{chain_ms:.4f}",
             least_ms=f"{least_ms:.5f}", bound_by=bound_by,
             share_of_bound=f"{100 * least_ms / kernel_ms:.2f}%",
             tile_h=enhance_cuda.plan(*src, *dst)[0],
             peak_bytes=peak, card=f"'{card}'")
        del frames, got, want
        torch.cuda.empty_cache()


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
    with tempfile.TemporaryDirectory() as folder:
        cubin, sass_build = _start_sass_probe(folder)
        built = build.load_libraries()
        sass = _finish_sass_probe(cubin, sass_build)
    _say("build", seconds=f"{time.perf_counter() - started:.2f}",
         **{f"nvcc_{stem}_seconds": f"{b.seconds:.2f}"
            for stem, b in built.items()})
    for stem, library in built.items():
        for line in library.log.splitlines():
            # each kernel's name, then its registers, shared memory, spills
            if any(key in line for key in ("entry function", "registers",
                                           "spill")):
                print(f"  ptxas {stem}:", line.strip(), flush=True)
    _say("sass-ops", **{name: ",".join(f"{k}={v}" for k, v in ops.items())
                        for name, ops in sass.items()})

    config, lut, ref_stats = _stack(device)
    bounds = kernel_bounds(TIMED_SHAPE, lut.size ** 3 * 24 * 4, sass,
                           _sm_clock_hz())
    errors, times = kernels_vs_plain(device, config, lut, ref_stats, SHAPES)
    determinism(device, config, lut, ref_stats)
    launches = main_path(device, config, lut, ref_stats, card)
    errors["film_grain"], times["film_grain"] = grain_vs_plain(device)
    launches.update(grain_path(device, lut, ref_stats, card))
    layout_errors, layout_times, layout_launches = layouts(
        device, config, lut, ref_stats, SHAPES)
    errors.update(layout_errors)
    times.update(layout_times)
    for name, count in layout_launches.items():
        launches[name] = launches.get(name, 0) + count
    (errors["weighted_row_sum"], times["weighted_row_sum"],
     probe_launches, mv_ms) = probe(device)
    library_ms = {"weighted_row_sum": mv_ms}
    launches.update(probe_launches)
    file_phase(device, config, lut)
    resample_phase(device)
    _add(launches, enhance_path(device, card))
    enhancer_job(device)
    _add(launches, images_and_compare(device))
    face_repair_and_secondary_ops(device)
    for name, count in parallel_phase(device, config, lut, ref_stats,
                                      card).items():
        launches[name] = launches.get(name, 0) + count
    _add(launches, server_phase(device, kind))
    builder_phase(device)
    workflow_phase(device)
    text_phase(device)
    _add(launches, bench_phase(device, card))
    sweep_launches, sweep_errors = adjust_sweep_phase(device, card)
    _add(launches, sweep_launches)
    for name, err in sweep_errors.items():
        errors[name] = max(errors[name], err)
    errors["lut_apply"], times["lut_apply"], lut_launches = lut_phase(
        device, card)
    _add(launches, lut_launches)
    enhance_kernel_phase(device, card)

    for name in SOURCES:
        if launches.get(name, 0) == 0:
            raise AssertionError(f"no path launched {name}")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "issue_ms": bounds[name][2],
         "library_ms": library_ms.get(name)}
        for name, (source, replaces) in SOURCES.items()]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
