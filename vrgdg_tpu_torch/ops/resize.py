"""Resampling: resize / letterbox / crop-to-fill and their exact inverses.

Counterpart of :mod:`vrgdg_tpu.ops.resize`.  The weight tables
(:func:`resample_matrix`, :func:`_tap_plan`) and the name tables are the
original's numpy code, copied: the original module imports ``jax.numpy``,
so it cannot be shared.  The device half runs as torch ops on the frames'
device:

- ``lanczos4`` (the enhancer's cv2-parity path, budget 1e-3 against cv2)
  is two dense products per frame with the same weight matrices, the
  larger source axis contracted first (:func:`_dense_resample`);
- bilinear, bicubic, area and nearest (torch-parity, budget 2e-5) keep
  the separable tap-gather: per axis, at most ``taps`` row gathers and
  multiply-adds (:func:`_resample_axis`).

The dense products run in IEEE float32 whatever the process's TF32
setting (:func:`_ieee_fp32_matmul`), and one frame at a time with one
product shape, so a frame's bits do not depend on the batch it came in.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

# Canonical fit-mode names (the reference's UI strings) plus short aliases.
FIT_STRETCH = "Stretch to dimensions"
FIT_CROP = "Crop to fill"
FIT_LETTERBOX = "Fit with letterbox (preserve all)"
_FIT_ALIASES = {
    "stretch": FIT_STRETCH, FIT_STRETCH: FIT_STRETCH,
    "crop": FIT_CROP, FIT_CROP: FIT_CROP,
    "letterbox": FIT_LETTERBOX, FIT_LETTERBOX: FIT_LETTERBOX,
}

_METHOD_ALIASES = {
    "nearest": "nearest", "Nearest": "nearest",
    "nearest-exact": "nearest-exact", "nearest_exact": "nearest-exact",
    "bilinear": "bilinear", "Bilinear": "bilinear",
    "bicubic": "bicubic", "Bicubic (recommended)": "bicubic",
    "area": "area", "Area": "area",
    "lanczos4": "lanczos4", "lanczos": "lanczos4",
}


def canonical_fit_mode(mode: str) -> str:
    try:
        return _FIT_ALIASES[str(mode)]
    except KeyError:
        raise ValueError(f"Unknown fit mode: {mode!r}") from None


def canonical_method(method: str) -> str:
    try:
        return _METHOD_ALIASES[str(method)]
    except KeyError:
        raise ValueError(f"Unknown resize method: {method!r}") from None


def _cubic_weight(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with torch's A=-0.75."""
    d = np.abs(d)
    w = np.where(d <= 1.0,
                 ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0,
                 np.where(d < 2.0,
                          ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a,
                          0.0))
    return w


def _lanczos_weight(d: np.ndarray, a: int = 4) -> np.ndarray:
    w = np.sinc(d) * np.sinc(d / a)
    return np.where(np.abs(d) < a, w, 0.0)


@functools.lru_cache(maxsize=256)
def resample_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """Dense ``(dst, src)`` resampling matrix for one axis.

    Border taps are clamped into range and accumulated, reproducing
    torch's bounded access / cv2's replicate border.
    """
    method = canonical_method(method)
    src, dst = int(src), int(dst)
    out = np.zeros((dst, src), np.float64)
    if src == dst and method != "area":
        np.fill_diagonal(out, 1.0)
        return out.astype(np.float32)
    scale = src / dst

    if method == "nearest":
        idx = np.minimum((np.arange(dst) * scale).astype(np.int64), src - 1)
        out[np.arange(dst), idx] = 1.0
        return out.astype(np.float32)

    if method == "nearest-exact":
        # torch mode="nearest-exact" / PIL: source index floor((i+0.5)*s)
        idx = np.minimum(((np.arange(dst) + 0.5) * scale).astype(np.int64),
                         src - 1)
        out[np.arange(dst), idx] = 1.0
        return out.astype(np.float32)

    if method == "area":
        # torch adaptive_avg_pool boundaries: floor/ceil integer ranges.
        for i in range(dst):
            start = int(np.floor(i * src / dst))
            end = int(np.ceil((i + 1) * src / dst))
            out[i, start:end] = 1.0 / (end - start)
        return out.astype(np.float32)

    centers = (np.arange(dst) + 0.5) * scale - 0.5
    if method == "bilinear":
        centers = np.maximum(centers, 0.0)  # torch clamps the source index
        base = np.floor(centers).astype(np.int64)
        taps, radius = 2, 0
        weight_fn = None  # handled explicitly
    elif method == "bicubic":
        base = np.floor(centers).astype(np.int64)
        taps, radius = 4, 1
        weight_fn = _cubic_weight
    else:  # lanczos4
        base = np.floor(centers).astype(np.int64)
        taps, radius = 8, 3
        weight_fn = _lanczos_weight

    for i in range(dst):
        x = centers[i]
        b = base[i]
        if method == "bilinear":
            lam = x - b
            pairs = ((min(max(b, 0), src - 1), 1.0 - lam),
                     (min(b + 1, src - 1), lam))
            for j, w in pairs:
                out[i, j] += w
            continue
        offsets = np.arange(taps) - radius
        positions = b + offsets
        weights = weight_fn(x - positions)
        total = weights.sum()
        if method == "lanczos4" and total != 0.0:
            weights = weights / total  # cv2 normalizes the windowed sinc
        for j, w in zip(np.clip(positions, 0, src - 1), weights):
            out[i, j] += w
    return out.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _tap_plan(src: int, dst: int, method: str) -> tuple[np.ndarray, np.ndarray]:
    """Sparse form of :func:`resample_matrix`: per output row, the (at most
    ``taps``) nonzero source indices and weights, zero-padded to a fixed
    width.  Numerically identical to the dense matrix (border-clamped taps
    are pre-accumulated there)."""
    dense = resample_matrix(src, dst, method)
    counts = (dense != 0.0).sum(axis=1)
    taps = max(1, int(counts.max()))
    idx = np.zeros((dst, taps), np.int32)
    weights = np.zeros((dst, taps), np.float32)
    for i in range(dst):
        nz = np.nonzero(dense[i])[0]
        idx[i, :len(nz)] = nz
        weights[i, :len(nz)] = dense[i, nz]
    return idx, weights


@functools.lru_cache(maxsize=16)
def _device_matrix(src: int, dst: int, method: str,
                   device: torch.device) -> torch.Tensor:
    """:func:`resample_matrix` on ``device``, uploaded once (a 1080p -> 4K
    width matrix is 29.5 MB)."""
    return torch.from_numpy(resample_matrix(src, dst, method)).to(device)


_IEEE_LOCK = threading.Lock()
_IEEE_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """Run the block's float32 matmuls in IEEE float32 on CUDA, whatever
    TF32 setting the process chose, and restore that setting after.

    The setting is process-wide, so a matmul on another thread during the
    block runs in float32 too.  Blocks may overlap on several threads (the
    server's requests): the first to enter saves the setting and the last
    to leave restores it, so no block sees another restore TF32 under it.
    A process that used the newer ``fp32_precision`` API refuses reads of
    ``allow_tf32``; that API is used then."""
    flags = torch.backends.cuda.matmul
    with _IEEE_LOCK:
        if _IEEE_STATE["depth"] == 0:
            try:
                name, saved, ieee = "allow_tf32", flags.allow_tf32, False
            except RuntimeError:
                name, saved, ieee = ("fp32_precision", flags.fp32_precision,
                                     "ieee")
            setattr(flags, name, ieee)
            _IEEE_STATE["saved"] = (name, saved)
        _IEEE_STATE["depth"] += 1
    try:
        yield
    finally:
        with _IEEE_LOCK:
            _IEEE_STATE["depth"] -= 1
            if _IEEE_STATE["depth"] == 0:
                setattr(flags, *_IEEE_STATE["saved"])


def _resample_axis(x: torch.Tensor, axis: int, src: int, dst: int,
                   method: str) -> torch.Tensor:
    idx_np, w_np = _tap_plan(src, dst, method)
    taps = idx_np.shape[1]
    idx = torch.from_numpy(idx_np.astype(np.int64)).to(x.device)
    weights = torch.from_numpy(w_np).to(x.device)
    w_shape = [1] * x.ndim
    w_shape[axis] = dst
    out = None
    for t in range(taps):
        term = x.index_select(axis, idx[:, t]) * weights[:, t].reshape(w_shape)
        out = term if out is None else out + term
    return out


def _dense_resample(x: torch.Tensor, target_height: int, target_width: int,
                    method: str, rows: tuple[int, int, int] | None = None
                    ) -> torch.Tensor:
    """Separable resample as two dense float32 products per frame.

    Each product is one 2-D matmul: the height pass multiplies the
    ``(dst_h, src_h)`` matrix into the frame as ``(H, W*C)``; the width
    pass multiplies the frame as ``(H*C, W)`` (channels moved before
    width) into the transposed ``(dst_w, src_w)`` matrix.  Axis order
    follows the MAC count, as in the JAX package: the larger source axis
    is contracted first.  Frames run one at a time, each through the same
    product shapes, so the bits of a frame do not depend on how frames are
    batched (a batched product can pick another cuBLAS algorithm for
    another batch count).

    ``rows = (source_height, first, (start, stop))`` computes only output
    rows ``[start, stop)`` of frames ``source_height`` rows tall, from an
    ``x`` that holds the source rows from ``first`` on (a height shard and
    its halo, :func:`lanczos_support`): the height pass multiplies by that
    block of the matrix.
    """
    src_h, src_w = int(x.shape[1]), int(x.shape[2])
    dst_h, dst_w = int(target_height), int(target_width)
    if rows is None:
        wh = _device_matrix(src_h, dst_h, method, x.device)
    else:
        full_h, first, (start, stop) = rows
        wh = _device_matrix(full_h, dst_h, method, x.device)
        wh = wh[start:stop, first:first + src_h].contiguous()
        src_h, dst_h = full_h, stop - start
    ww_t = _device_matrix(src_w, dst_w, method, x.device).t()

    def by_height(t: torch.Tensor) -> torch.Tensor:
        h, w, c = t.shape
        return (wh @ t.reshape(h, w * c)).reshape(dst_h, w, c)

    def by_width(t: torch.Tensor) -> torch.Tensor:
        h, w, c = t.shape
        planes = t.transpose(1, 2).reshape(h * c, w)
        return (planes @ ww_t).reshape(h, c, dst_w).transpose(1, 2)

    # MACs of the whole frame: height-first = dh*sh*sw + dw*sw*dh ;
    # width-first symmetric
    full_dst_h = int(target_height)
    height_first = full_dst_h * src_h * src_w + dst_w * src_w * full_dst_h
    width_first = dst_w * src_w * src_h + full_dst_h * src_h * dst_w

    def per_frame(frame: torch.Tensor) -> torch.Tensor:
        if src_h == full_dst_h and rows is None:
            return by_width(frame)
        if src_w == dst_w:
            return by_height(frame)
        if height_first <= width_first:
            return by_width(by_height(frame))
        return by_height(by_width(frame))

    with _ieee_fp32_matmul():
        return torch.stack([per_frame(frame) for frame in x])


def lanczos_support(source_height: int, target_height: int, start: int,
                    stop: int) -> tuple[int, int]:
    """The source rows ``[lo, hi)`` that output rows ``[start, stop)`` of
    a lanczos4 resample from ``source_height`` to ``target_height`` rows
    read: the halo a height shard needs."""
    if int(source_height) == int(target_height):
        return int(start), int(stop)
    block = resample_matrix(source_height, target_height, "lanczos4")
    used = np.nonzero(block[start:stop].any(axis=0))[0]
    return int(used[0]), int(used[-1]) + 1


def resample_rows(frames: torch.Tensor, source_height: int, first: int,
                  start: int, stop: int, target_height: int,
                  target_width: int) -> torch.Tensor:
    """Output rows ``[start, stop)`` of the lanczos4 :func:`resample` of
    frames ``source_height`` rows tall to ``(target_height,
    target_width)``, from ``frames``, which holds the source rows from
    ``first`` on and at least :func:`lanczos_support` of the window.
    Equal to those rows of the whole resample within float32 rounding
    (the products sum in another order)."""
    if int(source_height) == int(target_height):
        own = frames[:, start - first:stop - first]
        return resample(own, stop - start, target_width, "lanczos4")
    x = frames.to(torch.float32)
    out = _dense_resample(x, target_height, target_width, "lanczos4",
                          rows=(int(source_height), int(first),
                                (int(start), int(stop))))
    return out.to(frames.dtype)


def resample(frames: torch.Tensor, target_height: int, target_width: int,
             method: str = "bicubic") -> torch.Tensor:
    """Resample a BHWC batch to ``(target_height, target_width)``:
    ``lanczos4`` by :func:`_dense_resample`, every other method by the
    exact tap-gather."""
    method = canonical_method(method)
    src_h, src_w = int(frames.shape[1]), int(frames.shape[2])
    if (src_h, src_w) == (int(target_height), int(target_width)):
        return frames  # all methods are exact identity at equal size
    x = frames.to(torch.float32)
    if method == "lanczos4":
        return _dense_resample(
            x, target_height, target_width, method).to(frames.dtype)
    if src_h != int(target_height):
        x = _resample_axis(x, 1, src_h, int(target_height), method)
    if src_w != int(target_width):
        x = _resample_axis(x, 2, src_w, int(target_width), method)
    return x.to(frames.dtype)


def resize_batch(frames: torch.Tensor, target_width: int, target_height: int,
                 fit_mode: str = FIT_STRETCH,
                 method: str = "bicubic") -> torch.Tensor:
    """Resize an RGB batch with the reference's three fit modes
    (``VRGDG_VideoEnhanceNodes.py:54-86``); output is clamped to [0,1] and
    carries only the first three channels, as in the reference."""
    if frames.ndim != 4 or frames.shape[0] < 1:
        raise ValueError("resize_batch requires a non-empty BHWC batch.")
    fit_mode = canonical_fit_mode(fit_mode)
    src_h, src_w = int(frames.shape[1]), int(frames.shape[2])
    target_width, target_height = int(target_width), int(target_height)
    rgb = frames[..., :3]

    if fit_mode == FIT_STRETCH:
        out = resample(rgb, target_height, target_width, method)
    else:
        if fit_mode == FIT_CROP:
            scale = max(target_width / src_w, target_height / src_h)
        else:
            scale = min(target_width / src_w, target_height / src_h)
        scaled_w = max(1, int(round(src_w * scale)))
        scaled_h = max(1, int(round(src_h * scale)))
        resized = resample(rgb, scaled_h, scaled_w, method)
        if fit_mode == FIT_CROP:
            left = max(0, (scaled_w - target_width) // 2)
            top = max(0, (scaled_h - target_height) // 2)
            out = resized[:, top:top + target_height, left:left + target_width, :]
        else:
            pad_l = max(0, (target_width - scaled_w) // 2)
            pad_r = max(0, target_width - scaled_w - pad_l)
            pad_t = max(0, (target_height - scaled_h) // 2)
            pad_b = max(0, target_height - scaled_h - pad_t)
            out = F.pad(resized, (0, 0, pad_l, pad_r, pad_t, pad_b))
    return torch.clamp(out, 0.0, 1.0)


def restore_batch(frames: torch.Tensor, source_width: int, source_height: int,
                  fit_mode: str = FIT_STRETCH,
                  method: str = "bicubic") -> torch.Tensor:
    """Exact inverse of :func:`resize_batch` back to source dimensions: a
    letterboxed batch has its content box recomputed, cropped and
    stretched; other modes stretch directly
    (``VRGDG_VideoEnhanceNodes.py:89-106``)."""
    if canonical_fit_mode(fit_mode) != FIT_LETTERBOX:
        return resize_batch(frames, source_width, source_height,
                            FIT_STRETCH, method)
    work_h, work_w = int(frames.shape[1]), int(frames.shape[2])
    scale = min(work_w / source_width, work_h / source_height)
    content_w = min(work_w, max(1, int(round(source_width * scale))))
    content_h = min(work_h, max(1, int(round(source_height * scale))))
    left = max(0, (work_w - content_w) // 2)
    top = max(0, (work_h - content_h) // 2)
    content = frames[:, top:top + content_h, left:left + content_w, :]
    return resize_batch(content, source_width, source_height,
                        FIT_STRETCH, method)
