"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

The sources under ``kernels/csrc/`` have a plain C interface (raw device
pointers, shapes, scalars and a ``cudaStream_t``), so they compile in
seconds without PyTorch's headers and bind through :mod:`ctypes`; no
``ninja`` and no ``torch.utils.cpp_extension`` are needed.  Each ``.cu``
builds into a library of its own (``enhance``, ``grade``, ``grain``,
``lut``, ``probe``), one ``nvcc`` process per source, all started together at first
use, into ``kernels/_build/`` under a name that carries a hash of the
source, the shared headers and the flags, so an edited source rebuilds.
``ptxas -v`` output (registers, shared memory, spills per kernel) is kept
beside each library as ``<name>.log``.

:data:`LAUNCHES` counts the kernel launches of every wrapper; a wrapper
adds one through :func:`check_launch` after its kernel launched, and
nowhere else.  The count is taken under a lock: the server launches
kernels from several request threads at once.

Nothing here runs at import time: the CPU test suite imports every module
of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# -O3 for sm_90a (keep the "a": wgmma/setmaxnreg exist only there).  No
# --use_fast_math: it changes powf/logf/cosf and division, and the
# kernel-vs-plain budgets are ~1e-5.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel, by the name each wrapper counts under
LAUNCHES = {name: 0 for name in (
    "grade_phase1", "grade_phase2", "grade_phase1_planes",
    "grade_phase2_planes", "film_grain", "weighted_row_sum", "lut_apply",
    "enhance_step")}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc / ptxas output of the build


class AdjustParams(ctypes.Structure):
    """Mirror of ``struct AdjustParams`` in ``csrc/grade.cu``."""

    _fields_ = [("offset", ctypes.c_float * 3),
                ("exposure", ctypes.c_float),
                ("contrast", ctypes.c_float),
                ("saturation", ctypes.c_float),
                ("highlights", ctypes.c_float),
                ("shadows", ctypes.c_float),
                ("whites", ctypes.c_float),
                ("blacks", ctypes.c_float),
                ("fade_scale", ctypes.c_float),
                ("fade_lift", ctypes.c_float),
                ("vignette", ctypes.c_float)]


_LOCK = threading.Lock()
_LOADED: dict[str, BuiltLibrary] = {}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise on a launcher's non-zero ``cudaGetLastError()``; else count
    one launch of ``name``."""
    if code != 0:
        message = lib.vrgdg_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({message})")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def find_nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                                   "nvcc"),
                      "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise KernelBuildError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built.")


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as handle:
            h.update(handle.read())
    return h.hexdigest()[:16]


def _targets() -> dict[str, str]:
    """Library stem -> target path, for every ``.cu`` under ``csrc/``."""
    names = sorted(os.listdir(CSRC_DIR))
    headers = [os.path.join(CSRC_DIR, n) for n in names
               if n.endswith((".cuh", ".h"))]
    targets = {}
    for name in names:
        if name.endswith(".cu"):
            stem = name[:-3]
            source = os.path.join(CSRC_DIR, name)
            targets[stem] = os.path.join(
                BUILD_DIR, f"libvrgdg_{stem}_{_digest([source, *headers])}.so")
    return targets


def _bind(stem: str, lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    u32 = ctypes.c_uint32
    lib.vrgdg_cuda_error_string.argtypes = [i32]
    lib.vrgdg_cuda_error_string.restype = ctypes.c_char_p
    signatures = {
        "enhance": {
            "vrgdg_enhance_step": [i32, ptr, i32, i32, i32, ptr, ptr, ptr,
                                   i32, ptr, ptr, ptr, i32, i32, i32, i32,
                                   i32, f32, f32, f32, f32, u32, ptr, ptr],
        },
        "grade": {
            "vrgdg_grade_phase1": [i32, ptr, ptr, i32, ptr, f32, f32, i32,
                                   AdjustParams, i32, i32, i32, ptr, ptr,
                                   ptr],
            "vrgdg_grade_phase1_planes": [i32, ptr, ptr, i32, ptr, f32, f32,
                                          i32, i32, i32, ptr, ptr, ptr],
            "vrgdg_grade_phase2": [i32, ptr, ptr, i32, i32, i32, f32, f32,
                                   f32, f32, u32, ptr, ptr],
            "vrgdg_grade_phase2_planes": [i32, ptr, ptr, i32, i32, i32, f32,
                                          f32, f32, f32, u32, ptr, ptr],
            "vrgdg_phase1_block_size": [],
        },
        "grain": {
            "vrgdg_film_grain": [i32, ptr, i32, i32, i32, i32, i32, i32, f32,
                                 f32, f32, u32, ptr, ptr],
        },
        "lut": {
            "vrgdg_lut_apply": [i32, ptr, i64, i32, ptr, i32, ptr, ptr, f32,
                                ptr, ptr],
        },
        "probe": {
            "vrgdg_weighted_row_sum": [i32, ptr, i64, ptr, ptr],
        },
    }[stem]
    for function, argtypes in signatures.items():
        getattr(lib, function).argtypes = argtypes
        getattr(lib, function).restype = i32


def load_libraries() -> dict[str, BuiltLibrary]:
    """Build (once per source hash, all sources in parallel) and load every
    kernel library, keyed by source stem.

    Raises :class:`KernelBuildError` when nvcc is missing or fails; the
    callers never fall back to the plain versions."""
    with _LOCK:
        if _LOADED:
            return _LOADED
        targets = _targets()
        missing = {stem: target for stem, target in targets.items()
                   if not os.path.isfile(target)}
        seconds = dict.fromkeys(targets, 0.0)
        if missing:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = find_nvcc()
            jobs = {}
            for stem, target in missing.items():
                fd, tmp = tempfile.mkstemp(prefix=f"libvrgdg_{stem}_",
                                           suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                source = os.path.join(CSRC_DIR, stem + ".cu")
                jobs[stem] = (tmp, time.perf_counter(), subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, source],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, errors="replace"))
            failures = []
            for stem, (tmp, started, process) in jobs.items():
                log, _ = process.communicate()
                seconds[stem] = time.perf_counter() - started
                if process.returncode != 0:
                    os.remove(tmp)
                    failures.append(f"nvcc failed on {stem}.cu (exit "
                                    f"{process.returncode}):\n{log}")
                    continue
                with open(missing[stem][:-3] + ".log", "w",
                          encoding="utf-8") as handle:
                    handle.write(log or "")
                os.replace(tmp, missing[stem])
            if failures:
                raise KernelBuildError("\n".join(failures))
        for stem, target in targets.items():
            with open(target[:-3] + ".log", encoding="utf-8") as handle:
                log = handle.read()
            lib = ctypes.CDLL(target)
            _bind(stem, lib)
            _LOADED[stem] = BuiltLibrary(lib=lib, path=target,
                                         seconds=seconds[stem], log=log)
        return _LOADED


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return load_libraries()[stem].lib
