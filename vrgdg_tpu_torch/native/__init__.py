"""Native (C++) runtime components, loaded via ctypes.

Counterpart of :mod:`vrgdg_tpu.native`, which cannot be imported without
JAX (``vrgdg_tpu/__init__.py`` imports it).  ``mp4concat.cpp`` is a copy
of the original's source, the same code (a CPU test holds every code line
equal): a lossless MP4 sample-table merger that joins the enhancer's
segments by stream copy where no ffmpeg binary is present, compiled on
first use with the system g++.  ``stage.cpp`` (the port's own, loaded
by :class:`vrgdg_tpu_torch.runtime.batch_stream.Stager`) copies a
streamed batch into its staging buffer on a pool of threads that never
take the interpreter lock.

Build artifacts go to ``_build/`` beside the source (or
``$VRGDG_TPU_NATIVE_CACHE``) under a name keyed by a hash of the source,
so a source edit triggers exactly one rebuild.  Every entry point raises
:class:`NativeUnavailable` when no compiler is present, and the caller
keeps its re-encode fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}


class NativeUnavailable(RuntimeError):
    """The native component could not be built or loaded."""


def _build_dir() -> str:
    override = os.environ.get("VRGDG_TPU_NATIVE_CACHE", "").strip()
    path = override or os.path.join(_DIR, "_build")
    os.makedirs(path, exist_ok=True)
    return path


def _compile(name: str) -> str:
    """Compile ``<name>.cpp`` into a content-hash-keyed shared object and
    return its path; reuses the cached artifact when the source is
    unchanged."""
    source = os.path.join(_DIR, f"{name}.cpp")
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    target = os.path.join(_build_dir(), f"{name}-{digest}.so")
    if os.path.isfile(target):
        return target
    fd, temp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             "-o", temp, source],
            check=True, capture_output=True, text=True, timeout=120)
        os.replace(temp, target)
    except (subprocess.SubprocessError, OSError) as exc:
        if os.path.exists(temp):
            os.remove(temp)
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeUnavailable(
            f"could not build {name}: {detail.strip()[:500]}") from exc
    return target


def load(name: str) -> ctypes.CDLL:
    """Load (building if needed) the named native library."""
    with _LOCK:
        if name in _LIBS:
            lib = _LIBS[name]
            if lib is None:
                raise NativeUnavailable(f"{name} previously failed to build")
            return lib
        try:
            lib = ctypes.CDLL(_compile(name))
        except NativeUnavailable:
            _LIBS[name] = None
            raise
        except OSError as exc:
            _LIBS[name] = None
            raise NativeUnavailable(f"could not load {name}: {exc}") from exc
        _LIBS[name] = lib
        return lib


def concat_mp4_stream_copy(inputs: list[str], output: str) -> None:
    """Concatenate single-video-track MP4 segments by byte-exact sample
    stream copy (no re-encode, no audio).

    Raises :class:`NativeUnavailable` when the component cannot be built
    and :class:`ValueError` when the inputs violate its contract (codec
    or dimension mismatch, multiple tracks, malformed tables) — callers
    fall back to the re-encode path on either.
    """
    lib = load("mp4concat")
    fn = lib.mp4_concat
    fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                   ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
    fn.restype = ctypes.c_int32
    encoded = [os.fsencode(p) for p in inputs]
    array = (ctypes.c_char_p * len(encoded))(*encoded)
    errbuf = ctypes.create_string_buffer(1024)
    status = fn(array, len(encoded), os.fsencode(output), errbuf, 1024)
    if status != 0:
        raise ValueError(errbuf.value.decode("utf-8", "replace")
                         or "mp4 concat failed")
