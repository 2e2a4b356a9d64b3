#!/usr/bin/env python3
"""Time the mappings of ``lut_variants.cu`` beside the shipped ``lut_apply``
on one card.

    python3 kernel_variants/lut_variants.py [--reps N] [--rounds R]

Builds ``lut_variants.cu`` (which includes the shipped
``vrgdg_tpu_torch/kernels/csrc/lut.cu``) with the package's nvcc flags into
a temporary folder, and loads the shipped kernel as the package builds it.
At 1080p x 8 (Apply LUT's batch) and 4K x 2, on ``chip_smoke.py``'s seeded
uniform frames and on its smooth frames (neighbouring pixels share LUT
cells, as in real footage), with the flagship LUT at 10: the shipped
kernel bit for bit against its plain version on the card, every variant
but the float32 yardstick bit for bit against the shipped kernel, then R
rounds, each round the shipped kernel followed by every variant:
CUDA-event ms over N launches after a warm-up.  Prints the card's name and
power limit, the ptxas lines of the shipped kernel and of the variants,
then one ``VARIANT`` JSON line per kernel, shape and content.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# in the order of the launcher's switch in lut_variants.cu
VARIANTS = ("direct_t128_p1", "direct_t256_p1", "direct_t512_p1",
            "direct_t256_p2", "direct_t256_p1_min8", "staged_t256",
            "fp32_yardstick")
# timed only: not the plain version's bits
YARDSTICKS = ("fp32_yardstick",)
SHAPES = ((8, 1080, 1920), (2, 2160, 3840))
STRENGTH = 10.0


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build(folder: str) -> tuple[ctypes.CDLL, str]:
    """nvcc on lut_variants.cu; the loaded library and nvcc's log."""
    from vrgdg_tpu_torch.kernels import build

    target = os.path.join(folder, "liblut_variants.so")
    done = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", target,
         os.path.join(HERE, "lut_variants.cu")],
        capture_output=True, text=True, errors="replace", timeout=600,
        check=False)
    if done.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on lut_variants.cu:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(target)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.vrgdg_lut_variant.argtypes = [i32, i32, ptr, i64, i32, ptr, i32, ptr,
                                      ptr, f32, ptr, ptr]
    lib.vrgdg_lut_variant.restype = i32
    lib.vrgdg_cuda_error_string.argtypes = [i32]
    lib.vrgdg_cuda_error_string.restype = ctypes.c_char_p
    return lib, done.stdout + done.stderr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from vrgdg_tpu_torch.api import paths
    from vrgdg_tpu_torch.core.cube import GLOBAL_LUT_CACHE, corner_bundle
    from vrgdg_tpu_torch.kernels import build, lut_cuda
    from vrgdg_tpu_torch.ops.lut import (apply_lut_bundle,
                                         apply_lut_bundle_plain)

    if not torch.cuda.is_available():
        print("lut_variants: no CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    device = torch.device("cuda", 0)
    print(cs._nvidia_smi(), flush=True)
    shipped_log = build.load_libraries()["lut"].log
    lut = GLOBAL_LUT_CACHE.load(paths.safe_lut_path(cs.FLAGSHIP["lut_name"]))
    bundle = torch.from_numpy(corner_bundle(lut.table)).to(device)
    dmin = torch.from_numpy(np.float32(lut.domain_min)).to(device)
    dmax = torch.from_numpy(np.float32(lut.domain_max)).to(device)
    size = lut_cuda.lut_size(bundle)
    blend = lut_cuda.blend_factor(STRENGTH)
    stream = torch.cuda.current_stream(device).cuda_stream
    with tempfile.TemporaryDirectory() as folder:
        lib, log = _build(folder)
        for text in (shipped_log, log):
            for line in text.splitlines():
                if any(key in line for key in ("entry function", "registers",
                                               "spill")):
                    print("  ptxas", line.strip()[:160], flush=True)

        def variant(index, frames):
            out = torch.empty_like(frames)
            code = lib.vrgdg_lut_variant(
                index, device.index, frames.data_ptr(),
                frames.numel() // 3, 3, bundle.data_ptr(), size,
                dmin.data_ptr(), dmax.data_ptr(), blend, out.data_ptr(),
                stream)
            if code != 0:
                message = lib.vrgdg_cuda_error_string(code).decode()
                raise RuntimeError(f"{VARIANTS[index]}: CUDA error {code} "
                                   f"({message})")
            return out

        for index_shape, shape in enumerate(SHAPES):
            for content, frames in (
                    ("uniform", cs._frames(shape, 230 + index_shape, device)),
                    ("smooth", cs._smooth_frames(shape, 240 + index_shape,
                                                 device))):
                label = cs._label(shape)
                kernels = {"shipped": lambda x=frames: apply_lut_bundle(
                    x, bundle, dmin, dmax, STRENGTH)}
                shipped = kernels["shipped"]()
                if not torch.equal(shipped, apply_lut_bundle_plain(
                        frames, bundle, dmin, dmax, STRENGTH)):
                    raise AssertionError(f"shipped {label} {content} differs "
                                         "from the plain version")
                for index, name in enumerate(VARIANTS):
                    got = variant(index, frames)
                    same = torch.equal(got, shipped)
                    if not same and name not in YARDSTICKS:
                        raise AssertionError(f"{name} {label} {content} "
                                             "differs from the shipped kernel")
                    print(f"[check] {name} {label} {content} "
                          f"bit_identical={same} max_abs="
                          f"{cs._max_err(got, shipped):.3g}", flush=True)
                    kernels[name] = (lambda i, x: lambda: variant(i, x))(
                        index, frames)
                times = {name: [] for name in kernels}
                for _ in range(args.rounds):
                    for name, fn in kernels.items():
                        times[name].append(cs._cuda_ms(fn, args.reps))
                for name, values in times.items():
                    print("VARIANT " + json.dumps({
                        "kernel": name, "shape": label, "content": content,
                        "ms": [round(v, 5) for v in values],
                        "median_ms": round(float(np.median(values)), 5),
                        "ms_per_frame": round(float(np.median(values))
                                              / shape[0], 5)}), flush=True)
                del frames
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
