"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

The sources under ``kernels/csrc/`` have a plain C interface (raw device
pointers, shapes, scalars and a ``cudaStream_t``), so they compile in
seconds without PyTorch's headers and bind through :mod:`ctypes`; no
``ninja`` and no ``torch.utils.cpp_extension`` are needed.  The library is
built at first use into ``kernels/_build/``, under a name that carries a
hash of the sources and flags, so an edited source rebuilds.  ``ptxas -v``
output (registers, shared memory, spills per kernel) is kept beside the
library as ``<name>.log``.

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
_LOADED: BuiltLibrary | None = None


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


def _sources() -> list[str]:
    names = sorted(n for n in os.listdir(CSRC_DIR)
                   if n.endswith((".cu", ".cuh", ".h")))
    return [os.path.join(CSRC_DIR, n) for n in names]


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as handle:
            h.update(handle.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vrgdg_grade_phase1.argtypes = [
        i32, ptr, ptr, i32, ptr, f32, f32, i32, AdjustParams, i32, i32, i32,
        ptr, ptr, ptr]
    lib.vrgdg_grade_phase1.restype = i32
    lib.vrgdg_grade_phase2.argtypes = [
        i32, ptr, ptr, i32, i32, i32, f32, f32, f32, f32, ctypes.c_uint32, ptr,
        ptr]
    lib.vrgdg_grade_phase2.restype = i32
    lib.vrgdg_phase1_block_size.argtypes = []
    lib.vrgdg_phase1_block_size.restype = i32
    lib.vrgdg_cuda_error_string.argtypes = [i32]
    lib.vrgdg_cuda_error_string.restype = ctypes.c_char_p


def load_library() -> BuiltLibrary:
    """Build (once per source hash) and load the kernel library.

    Raises :class:`KernelBuildError` when nvcc is missing or fails; the
    caller never falls back to the plain versions."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        sources = _sources()
        cu = [p for p in sources if p.endswith(".cu")]
        name = f"libvrgdg_grade_{_digest(sources)}"
        target = os.path.join(BUILD_DIR, name + ".so")
        log_path = os.path.join(BUILD_DIR, name + ".log")
        seconds = 0.0
        if not os.path.isfile(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = find_nvcc()
            fd, tmp = tempfile.mkstemp(prefix=name, suffix=".so",
                                       dir=BUILD_DIR)
            os.close(fd)
            started = time.perf_counter()
            result = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
                                    capture_output=True, text=True,
                                    errors="replace", check=False)
            seconds = time.perf_counter() - started
            log = (result.stdout or "") + (result.stderr or "")
            if result.returncode != 0:
                os.remove(tmp)
                raise KernelBuildError(
                    f"nvcc failed (exit {result.returncode}):\n{log}")
            with open(log_path, "w", encoding="utf-8") as handle:
                handle.write(log)
            os.replace(tmp, target)
        with open(log_path, encoding="utf-8") as handle:
            log = handle.read()
        lib = ctypes.CDLL(target)
        _bind(lib)
        _LOADED = BuiltLibrary(lib=lib, path=target, seconds=seconds, log=log)
        return _LOADED
