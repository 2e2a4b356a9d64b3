#!/usr/bin/env python3
"""Time the asynchronous-copy variants of the fused grade's two kernels
beside the shipped ``grade_phase1`` and ``grade_phase2`` on one card.

    python3 kernel_variants/grade_variants.py [--reps N] [--rounds R]

Builds ``grade_variants.cu`` (which includes the shipped
``vrgdg_tpu_torch/kernels/csrc/grade.cu``) with the package's nvcc flags
into a temporary folder, and loads the shipped kernels as the package
builds them.  At 4K x 2 and 1080p x 8 on the flagship stack of
``chip_smoke.py``, each variant is checked against the plain PyTorch
versions within ``chip_smoke.BOUNDS`` (LAB and A/B for phase 1, RGB with
grain off and on for phase 2), then timed in R rounds, each round the
shipped kernel followed by every variant: CUDA-event ms over N launches
after a warm-up, phase 1 on the smoke's seeded uniform frames and on its
smooth frame, phase 2 on phase 1's LAB.  Phase 2's layouts: the shipped
``grade_phase2`` (BHWC) and ``grade_phase2_planes`` (channel planes) and the
same body reading one layout and writing the other, each bit for bit
against ``grade_phase2`` and timed in the same rounds, grain off and on, so
the planes kernel's extra time splits into its reads and its writes.
Prints the card's name and power limit, the ptxas lines of the variants,
then one ``VARIANT`` JSON line per kernel and shape.  Needs a CUDA card.
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
# in the order of the launchers' switch in grade_variants.cu
PHASE1_VARIANTS = ("ring_t256_p4_s3", "ring_t128_p4_s3", "ring_t256_p2_s3",
                   "ring_t512_p1_s2", "direct_t256_p4")
PHASE2_VARIANTS = ("tiles64x32_persistent_double_buffer",
                   "tiles64x32_one_per_block")
# the shipped phase-2 body with mixed layouts: name -> (launcher's variant,
# LAB in planes, RGB out in planes)
LAYOUT_VARIANTS = {"planes_lab_bhwc_rgb": (2, True, False),
                   "bhwc_lab_planes_rgb": (3, False, True)}
SHAPES = ((2, 2160, 3840), (8, 1080, 1920))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _build(folder: str) -> tuple[ctypes.CDLL, str]:
    """nvcc on grade_variants.cu; the loaded library and nvcc's log."""
    from vrgdg_tpu_torch.kernels import build

    target = os.path.join(folder, "libgrade_variants.so")
    done = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", target,
         os.path.join(HERE, "grade_variants.cu")],
        capture_output=True, text=True, errors="replace", timeout=600,
        check=False)
    if done.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on grade_variants.cu:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(target)
    ptr, i32, f32, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32)
    lib.vrgdg_variant_phase1.argtypes = [
        i32, i32, ptr, ptr, i32, ptr, f32, f32, i32, build.AdjustParams, i32,
        i32, i32, ptr, ptr, ptr]
    lib.vrgdg_variant_phase2.argtypes = [
        i32, i32, ptr, ptr, i32, i32, i32, f32, f32, f32, f32, u32, ptr, ptr]
    lib.vrgdg_variant_phase1.restype = i32
    lib.vrgdg_variant_phase2.restype = i32
    lib.vrgdg_cuda_error_string.argtypes = [i32]
    lib.vrgdg_cuda_error_string.restype = ctypes.c_char_p
    return lib, done.stdout + done.stderr


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.vrgdg_cuda_error_string(code).decode()})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from vrgdg_tpu_torch.kernels import build
    from vrgdg_tpu_torch.kernels import grade_cuda as gc
    from vrgdg_tpu_torch.ops.grade import _active_adjust, prepare_operands

    if not torch.cuda.is_available():
        print("grade_variants: no CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    device = torch.device("cuda", 0)
    print(cs._nvidia_smi(), flush=True)
    build.load_libraries()
    with tempfile.TemporaryDirectory() as folder:
        lib, log = _build(folder)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas", line.strip()[:160], flush=True)

        config, lut, ref_stats = cs._stack(device)
        table, dmin, dmax, ref_mean, ref_std = prepare_operands(
            config, lut=lut, ref_stats=ref_stats, device=device)
        blend = config.lut.strength / 10.0
        adjust = _active_adjust(config)
        flags, params = gc._adjust_args(adjust)
        domain = gc.lut_domain(dmin, dmax)
        size = round(table.shape[0] ** (1.0 / 3.0))
        match = config.color_match.match_strength
        grain = config.grain
        stream = torch.cuda.current_stream(device).cuda_stream

        def phase1_variant(index, src):
            batch, height, width, _ = src.shape
            lab = torch.empty_like(src)
            partials = torch.empty(
                (batch, -(-height * width // gc.PHASE1_BLOCK), 6),
                dtype=torch.float64, device=device)
            _check(lib, lib.vrgdg_variant_phase1(
                index, device.index, src.data_ptr(), table.data_ptr(), size,
                domain.data_ptr(), blend, 1.0 - blend, flags, params, batch,
                height, width, lab.data_ptr(), partials.data_ptr(), stream),
                PHASE1_VARIANTS[index])
            return lab, partials

        def phase2_variant(index, lab, coeff, intensity):
            batch, height, width, _ = lab.shape
            out = torch.empty_like(lab)
            _check(lib, lib.vrgdg_variant_phase2(
                index, device.index, lab.data_ptr(), coeff.data_ptr(), batch,
                height, width, config.sharpen.strength, intensity,
                grain.saturation_mix, 1.0 - grain.saturation_mix,
                grain.seed & 0xFFFFFFFF, out.data_ptr(), stream),
                PHASE2_VARIANTS[index])
            return out

        for shape in SHAPES:
            label = cs._label(shape)
            pixels = shape[1] * shape[2]
            frames = cs._frames(shape, 100, device)
            smooth = cs._smooth_frames(shape, 120, device)
            lab_p, part_p = gc.phase1_plain(frames, table, domain,
                                            blend=blend, adjust=adjust)
            coeff_p = gc.stats_barrier(part_p, pixels, ref_mean, ref_std,
                                       match)
            lab_k, _ = gc.phase1(frames, table, domain, blend=blend,
                                 adjust=adjust)
            phase1 = {"shipped": lambda src: gc.phase1(
                src, table, domain, blend=blend, adjust=adjust)}
            errors = {"shipped": {}}
            for index, name in enumerate(PHASE1_VARIANTS):
                lab_v, part_v = phase1_variant(index, frames)
                coeff_v = gc.stats_barrier(part_v, pixels, ref_mean,
                                           ref_std, match)
                lab_err = cs._max_err(lab_v, lab_p)
                coeff_err = cs._max_err(coeff_v, coeff_p)
                cs._check(f"{name} {label} LAB", lab_err, cs.BOUNDS["lab"])
                cs._check(f"{name} {label} A/B", coeff_err,
                          cs.BOUNDS["coeff"])
                errors[name] = {"lab_err": lab_err, "coeff_err": coeff_err,
                                "lab_vs_shipped": cs._max_err(lab_v, lab_k)}
                phase1[name] = (lambda i: lambda src: phase1_variant(i, src)
                                )(index)
            phase2 = {"shipped": lambda intensity: gc.phase2(
                lab_p, coeff_p, sharpen_strength=config.sharpen.strength,
                grain_intensity=intensity,
                saturation_mix=grain.saturation_mix, seed_base=grain.seed)}
            for index, name in enumerate(PHASE2_VARIANTS):
                for tag, intensity in (("off", 0.0), ("on", grain.intensity)):
                    want = gc.phase2_plain(
                        lab_p, coeff_p,
                        sharpen_strength=config.sharpen.strength,
                        grain_intensity=intensity,
                        saturation_mix=grain.saturation_mix,
                        seed_base=grain.seed)
                    got = phase2_variant(index, lab_p, coeff_p, intensity)
                    err = cs._max_err(got, want)
                    cs._check(f"{name} {label} RGB grain {tag}", err,
                              cs.BOUNDS[f"rgb_grain_{tag}"])
                    errors.setdefault(name, {})[f"rgb_err_grain_{tag}"] = err
                    errors[name][f"vs_shipped_grain_{tag}"] = cs._max_err(
                        got, phase2["shipped"](intensity))
                phase2[name] = (lambda i: lambda intensity: phase2_variant(
                    i, lab_p, coeff_p, intensity))(index)

            times = {name: {"uniform": [], "smooth": []} for name in phase1}
            times.update({name: {"grain_on": []} for name in phase2
                          if name != "shipped"})
            times["shipped"]["grain_on"] = []
            for _ in range(args.rounds):
                for name, run in phase1.items():
                    times[name]["uniform"].append(
                        cs._cuda_ms(lambda: run(frames), args.reps))
                    times[name]["smooth"].append(
                        cs._cuda_ms(lambda: run(smooth), args.reps))
                for name, run in phase2.items():
                    times[name]["grain_on"].append(cs._cuda_ms(
                        lambda: run(grain.intensity), args.reps))
            for name in phase1:
                print("VARIANT " + json.dumps(
                    {"kernel": "grade_phase1", "variant": name,
                     "shape": label, "ms_uniform": times[name]["uniform"],
                     "ms_smooth": times[name]["smooth"], **errors[name]}),
                    flush=True)
            for name in phase2:
                print("VARIANT " + json.dumps(
                    {"kernel": "grade_phase2", "variant": name,
                     "shape": label, "ms": times[name]["grain_on"],
                     **(errors[name] if name != "shipped" else {})}),
                    flush=True)
            layout_times(lib, cs, args, shape, lab_p, coeff_p, config, stream)
            del frames, smooth, lab_p, lab_k
            torch.cuda.empty_cache()
    return 0


def layout_times(lib, cs, args, shape, lab, coeff, config, stream) -> None:
    """Phase 2's layouts at ``shape`` on BHWC ``lab``: each bit for bit
    against the shipped ``grade_phase2``, then timed in rounds, grain off
    and on; one ``VARIANT`` line each."""
    import torch

    from vrgdg_tpu_torch.kernels import grade_cuda as gc

    grain = config.grain
    lab_planes = lab.permute(0, 3, 1, 2).contiguous()
    batch, height, width, _ = lab.shape

    def kwargs(intensity):
        return dict(sharpen_strength=config.sharpen.strength,
                    grain_intensity=intensity,
                    saturation_mix=grain.saturation_mix, seed_base=grain.seed)

    def mixed(index, planes_in, planes_out, intensity):
        out = torch.empty((batch, 3, height, width) if planes_out
                          else (batch, height, width, 3), device=lab.device)
        src = lab_planes if planes_in else lab
        _check(lib, lib.vrgdg_variant_phase2(
            index, lab.device.index, src.data_ptr(), coeff.data_ptr(), batch,
            height, width, config.sharpen.strength, intensity,
            grain.saturation_mix, 1.0 - grain.saturation_mix,
            grain.seed & 0xFFFFFFFF, out.data_ptr(), stream), str(index))
        return out.permute(0, 2, 3, 1) if planes_out else out

    # each returns BHWC (a view of planes output)
    runs = {"shipped_bhwc": lambda i: gc.phase2(lab, coeff, **kwargs(i)),
            "shipped_planes": lambda i: gc.phase2_planes(
                lab_planes, coeff, **kwargs(i)).permute(0, 2, 3, 1)}
    for name, (index, planes_in, planes_out) in LAYOUT_VARIANTS.items():
        runs[name] = (lambda v, a, b: lambda i: mixed(v, a, b, i))(
            index, planes_in, planes_out)
    tags = (("off", 0.0), ("on", grain.intensity))
    for tag, intensity in tags:
        want = gc.phase2(lab, coeff, **kwargs(intensity))
        plain = gc.phase2_plain(lab, coeff, **kwargs(intensity))
        for name, run in runs.items():
            got = run(intensity)
            cs._check(f"{name} grain {tag}", cs._max_err(got, plain),
                      cs.BOUNDS[f"rgb_grain_{tag}"])
            if not torch.equal(got, want):
                raise AssertionError(f"{name} grain {tag} differs from the "
                                     "shipped grade_phase2")
    times = {name: {tag: [] for tag, _ in tags} for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            for tag, intensity in tags:
                times[name][tag].append(cs._cuda_ms(
                    lambda: run(intensity), args.reps))
    for name in runs:
        print("VARIANT " + json.dumps(
            {"kernel": "grade_phase2_layouts", "variant": name,
             "shape": cs._label(shape), "bit_identical_to_grade_phase2": True,
             "ms_grain_off": times[name]["off"],
             "ms_grain_on": times[name]["on"]}), flush=True)
    del lab_planes


if __name__ == "__main__":
    sys.exit(main())
