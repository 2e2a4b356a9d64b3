"""Reference-sheet grid compositor (the IC-LoRA "Ingredients" sheet).

Counterpart of :mod:`vrgdg_tpu.ops.grid`.  The layout engines (uniform
grid, strips, wide-bottom, six-panel story, three-row reference,
aspect-packed rows with the partition-scoring search), the compositor
(contain-pad / cover-crop panel fit, gutters, outer padding, analytic
rounded-corner masks) and the MSR frame budget are the original's numpy,
copied; the panel resizes (LANCZOS4) run through
:func:`vrgdg_tpu_torch.ops.resize.resample` on ``device`` (``"cuda"``
unless the caller asks for ``"cpu"``), one upload and one download a
panel.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..runtime.batch_stream import resolve_device

LAYOUTS = ("auto_ltx", "uniform_grid", "horizontal_strip", "vertical_strip",
           "wide_bottom", "six_panel_story", "three_row_reference",
           "aspect_rows")
FIT_MODES = ("contain_pad", "cover_crop")


def parse_color(value, fallback="#000000") -> tuple[float, float, float]:
    text = str(value or "").strip().lstrip("#")
    if len(text) != 6:
        text = str(fallback).lstrip("#")
    try:
        return tuple(int(text[i:i + 2], 16) / 255.0 for i in (0, 2, 4))
    except ValueError:
        return parse_color(fallback, "#000000")


def grid_rects(count: int, columns: int | None = None) -> list[tuple]:
    """Uniform row-major grid in normalized coordinates.

    Behavior spec (``VRGDG_LTXICIngredientsGrid.py:98-110``): without an
    explicit column count, choose the count whose cell grid best fills a
    16:9 canvas — ``ceil(sqrt(count*16/9))`` — clamped to ``[1, count]``;
    rows follow as ``ceil(count/columns)`` and all cells share one size.
    """
    if count <= 0:
        return []
    if not columns or columns <= 0:
        columns = math.ceil(math.sqrt(count * 16 / 9))
    columns = min(count, max(1, int(columns)))
    rows = -(-count // columns)
    rr, cc = np.divmod(np.arange(count), columns)
    return [(c / columns, r / rows, 1 / columns, 1 / rows)
            for r, c in zip(rr.tolist(), cc.tolist())]


def _panel_aspect(shape) -> float:
    """width/height of an (H, W, ...) array shape, clamped to [0.05, 20]."""
    height, width = int(shape[0]), int(shape[1])
    if width <= 0 or height <= 0:
        return 1.0
    return float(np.clip(width / height, 0.05, 20.0))


def _run_boundaries(count: int, rows: int) -> np.ndarray:
    """Every ordered split of ``count`` panels into ``rows`` non-empty
    runs, as a ``(K, rows+1)`` matrix of run boundary indices
    ``[0, b1, .., count]`` in lexicographic cut order."""
    if rows == 1:
        cuts = np.empty((1, 0), np.int64)
    else:
        cuts = np.fromiter(
            itertools.chain.from_iterable(
                itertools.combinations(range(1, count), rows - 1)),
            dtype=np.int64).reshape(-1, rows - 1)
    bounds = np.empty((cuts.shape[0], rows + 1), np.int64)
    bounds[:, 0], bounds[:, -1] = 0, count
    bounds[:, 1:-1] = cuts
    return bounds


def aspect_row_rects(shapes, canvas_width: int,
                     canvas_height: int) -> list[tuple]:
    """Aspect-preserving row packing via vectorized composition search.

    Behavior spec (matches ``VRGDG_LTXICIngredientsGrid.py:140-202``
    layout output): pack the panels, in order, into 1..4 full-width rows
    on a unit canvas of aspect ``A = W/H``.  A row whose panels' aspect
    ratios sum to ``S`` gets normalized height ``A / max(S, 0.05)``.
    Candidate packings are all ordered compositions; each is scored by a
    cost model that is part of the layout behavior: total height ``T``
    overflowing 1.02 costs ``10x`` the overflow plus ``0.05`` per row,
    otherwise the unused vertical space ``1 - T`` plus ``0.035`` per row;
    uneven row heights add ``0.08x`` their spread.  Lowest cost wins
    (first in enumeration order on ties).  Placement: ``T > 1`` compresses
    all heights by ``1/T``; ``T < 0.98`` with several rows spreads the
    slack as ``(1-T)/(rows+1)`` gaps; otherwise the block is centered
    vertically.  Rows are centered horizontally; panel width is
    ``height * aspect / A``.
    """
    count = len(shapes)
    if count <= 0:
        return []
    if count == 1:
        return [(0.0, 0.0, 1.0, 1.0)]
    canvas_aspect = max(0.05, canvas_width / max(1, canvas_height))
    aspects = np.array([_panel_aspect(s) for s in shapes], np.float64)
    prefix = np.concatenate([[0.0], np.cumsum(aspects)])

    best_cost = math.inf
    best_bounds = best_heights = None
    for rows in range(1, min(count, 4) + 1):
        bounds = _run_boundaries(count, rows)
        spans = np.maximum(
            prefix[bounds[:, 1:]] - prefix[bounds[:, :-1]], 0.05)
        heights = canvas_aspect / spans                       # (K, rows)
        totals = heights.sum(axis=1)
        cost = np.where(totals > 1.02,
                        (totals - 1.0) * 10.0 + rows * 0.05,
                        (1.0 - totals) + rows * 0.035)
        cost = cost + (heights.max(axis=1) - heights.min(axis=1)) * 0.08
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost = float(cost[k])
            best_bounds, best_heights = bounds[k], heights[k]

    heights = best_heights
    total = float(heights.sum())
    n_rows = heights.shape[0]
    if total > 1.0:
        heights = heights / total
        gap, y_start = 0.0, 0.0
    elif total < 0.98 and n_rows > 1:
        gap = (1.0 - total) / (n_rows + 1)
        y_start = gap
    else:
        gap, y_start = 0.0, (1.0 - total) / 2.0
    row_tops = y_start + np.concatenate(
        [[0.0], np.cumsum(heights + gap)[:-1]])

    rects = []
    unit_widths = aspects / canvas_aspect   # panel width at unit row height
    for r in range(n_rows):
        lo, hi = int(best_bounds[r]), int(best_bounds[r + 1])
        row_h = float(heights[r])
        panel_w = unit_widths[lo:hi] * row_h
        x_start = max(0.0, (1.0 - float(panel_w.sum())) / 2.0)
        lefts = x_start + np.concatenate([[0.0], np.cumsum(panel_w)[:-1]])
        rects.extend(
            (float(x), float(row_tops[r]), float(w), row_h)
            for x, w in zip(lefts, panel_w))
    return rects


def layout_rects(preset: str, count: int, columns: int = 0) -> list[tuple]:
    """The preset layout table (``:204-262``)."""
    if count <= 0:
        return []
    if preset == "horizontal_strip":
        return [(i / count, 0.0, 1 / count, 1.0) for i in range(count)]
    if preset == "vertical_strip":
        return [(0.0, i / count, 1.0, 1 / count) for i in range(count)]
    if preset == "wide_bottom" and count >= 3:
        top_count = count - 1
        top_rows = 2 if top_count > 4 else 1
        top_height = 0.68 if top_rows == 2 else 0.56
        rects = [(x, y * top_height, w, h * top_height)
                 for x, y, w, h in grid_rects(top_count,
                                              columns if columns > 0
                                              else None)]
        rects.append((0.0, top_height, 1.0, 1.0 - top_height))
        return rects[:count]
    if preset == "six_panel_story" and count >= 6:
        if count > 7:
            return layout_rects("three_row_reference", count, columns)
        rects = [
            (0.0, 0.0, 0.235, 0.52), (0.235, 0.0, 0.385, 0.52),
            (0.62, 0.0, 0.38, 0.52), (0.0, 0.52, 0.37, 0.23),
            (0.37, 0.52, 0.63, 0.23), (0.0, 0.75, 0.37, 0.25),
            (0.37, 0.75, 0.63, 0.25),
        ]
        return rects[:count]
    if preset == "three_row_reference" and count >= 5:
        if count <= 6:
            top = count // 2
            mid = count - top - 1
            rects = [(i / top, 0.0, 1 / top, 0.42) for i in range(top)]
            rects += [(i / mid, 0.42, 1 / mid, 0.28) for i in range(mid)]
            rects.append((0.0, 0.70, 1.0, 0.30))
            return rects
        top = min(3, count)
        mid = min(3, count - top)
        bottom = count - top - mid
        rects = [(i / top, 0.0, 1 / top, 0.40) for i in range(top)]
        rects += [(i / mid, 0.40, 1 / mid, 0.28) for i in range(mid)]
        rects += [(i / bottom, 0.68, 1 / bottom, 0.32)
                  for i in range(bottom)]
        return rects
    if preset == "auto_ltx":
        if 6 <= count <= 7:
            return layout_rects("six_panel_story", count, columns)
        if count >= 5:
            return layout_rects("three_row_reference", count, columns)
    return grid_rects(count, columns if columns > 0 else None)


def _rounded_mask(height: int, width: int, radius: int) -> np.ndarray:
    """Binary rounded-rectangle mask, analytic twin of PIL's
    ``rounded_rectangle`` raster (``:91-95``)."""
    radius = max(0, min(int(radius), width // 2, height // 2))
    if radius == 0:
        return np.ones((height, width), np.float32)
    yy = np.arange(height, dtype=np.float32)[:, None]
    xx = np.arange(width, dtype=np.float32)[None, :]
    cx = np.clip(xx, radius, width - 1 - radius)
    cy = np.clip(yy, radius, height - 1 - radius)
    inside = ((xx - cx) ** 2 + (yy - cy) ** 2) <= radius ** 2
    return inside.astype(np.float32)


def _resized_panel(image: np.ndarray, height: int, width: int,
                   device) -> np.ndarray:
    """An HWC float32 panel's first three channels resampled (lanczos4) on
    ``device``, clipped to [0, 1], back on the host."""
    from .resize import resample

    panel = torch.from_numpy(np.ascontiguousarray(
        image[None, ..., :3], np.float32)).to(device)
    return torch.clamp(resample(panel, height, width, "lanczos4")[0],
                       0.0, 1.0).cpu().numpy()


def _fit_panel(image: np.ndarray, width: int, height: int, fit_mode: str,
               fill_color, device="cuda") -> np.ndarray:
    """contain_pad / cover_crop panel fit using the device LANCZOS4
    resampler."""
    source_h, source_w = image.shape[:2]
    scale_x, scale_y = width / source_w, height / source_h
    scale = max(scale_x, scale_y) if fit_mode == "cover_crop" \
        else min(scale_x, scale_y)
    new_w = max(1, int(round(source_w * scale)))
    new_h = max(1, int(round(source_h * scale)))
    resized = _resized_panel(image, new_h, new_w, device)
    if fit_mode == "cover_crop":
        left = max(0, (new_w - width) // 2)
        top = max(0, (new_h - height) // 2)
        return resized[top:top + height, left:left + width]
    panel = np.empty((height, width, 3), np.float32)
    panel[:] = fill_color
    left = (width - new_w) // 2
    top = (height - new_h) // 2
    panel[top:top + new_h, left:left + new_w] = resized
    return panel


def build_reference_sheet(images, layout: str = "auto_ltx",
                          output_width: int = 768, output_height: int = 448,
                          columns: int = 0, gutter: int = 4,
                          outer_padding: int = 4, corner_radius: int = 3,
                          fit_mode: str = "contain_pad",
                          background_color="#000000",
                          cell_background_color="#b8b8b8",
                          device="cuda") -> np.ndarray:
    """Compose a reference sheet from HWC/BHWC [0,1] images; returns a
    ``(1, H, W, 3)`` float32 array (``:337-404``)."""
    device = resolve_device(device)
    panels = []
    for image in images:
        array = np.asarray(image, np.float32)
        if array.ndim == 4:
            array = array[0]
        if array.shape[-1] == 1:
            array = np.repeat(array, 3, axis=-1)
        panels.append(array[..., :3])
    if not panels:
        raise ValueError("The reference sheet needs at least one image.")
    if layout not in LAYOUTS:
        raise ValueError(f"Unknown layout '{layout}'. Use one of {LAYOUTS}.")
    if fit_mode not in FIT_MODES:
        raise ValueError(f"Unknown fit mode '{fit_mode}'.")

    width = max(64, int(output_width))
    height = max(64, int(output_height))
    gutter = max(0, min(128, int(gutter)))
    padding = max(0, min(128, int(outer_padding)))
    radius = max(0, min(96, int(corner_radius)))
    background = parse_color(background_color, "#000000")
    cell_background = parse_color(cell_background_color, "#b8b8b8")

    if layout == "aspect_rows":
        rects = aspect_row_rects([p.shape for p in panels], width, height)
    else:
        rects = layout_rects(layout, len(panels), max(0, min(12, columns)))

    canvas = np.empty((height, width, 3), np.float32)
    canvas[:] = background
    usable_w = max(1, width - 2 * padding)
    usable_h = max(1, height - 2 * padding)
    inset = gutter // 2
    for panel, (x, y, w, h) in zip(panels, rects):
        left = padding + int(round(x * usable_w)) + inset
        top = padding + int(round(y * usable_h)) + inset
        right = padding + int(round((x + w) * usable_w)) - inset
        bottom = padding + int(round((y + h) * usable_h)) - inset
        panel_w = max(1, right - left)
        panel_h = max(1, bottom - top)
        fitted = _fit_panel(panel, panel_w, panel_h, fit_mode,
                            cell_background, device)
        target = canvas[top:top + panel_h, left:left + panel_w]
        if radius > 0:
            mask = _rounded_mask(panel_h, panel_w,
                                 min(radius, panel_w // 2,
                                     panel_h // 2))[..., None]
            canvas[top:top + panel_h, left:left + panel_w] = \
                target * (1.0 - mask) + fitted * mask
        else:
            canvas[top:top + panel_h, left:left + panel_w] = fitted
    return np.clip(canvas, 0.0, 1.0)[None]


# ---------------------------------------------------------------------------
# Multi-scale-render (MSR) reference batch
# ---------------------------------------------------------------------------

MSR_STRENGTH_FRAMES = {"17": 17, "25": 25, "33": 33, "41": 41}


def msr_frame_count(reference_strength: str, subject_count: int) -> int:
    """Frame budget for an MSR reference batch: explicit 17/25/33/41
    presets, or auto-scaled with the number of subjects
    (``vrgdg_ltx_msr_reference_builder.py:131-148``)."""
    key = str(reference_strength).split(" ")[0].strip()
    if key in MSR_STRENGTH_FRAMES:
        return MSR_STRENGTH_FRAMES[key]
    if subject_count <= 1:
        return 17
    if subject_count == 2:
        return 25
    if subject_count == 3:
        return 33
    return 41


def expand_reference_frames(count_per_image: int, frame_count: int) -> list[int]:
    """Round-robin repeat counts: each of ``count_per_image`` images gets
    ``frame_count // n`` frames, earlier images absorb the remainder
    (``vrgdg_ltx_msr_reference_builder.py:45-52``). Returns the repeat
    count per image index."""
    n = max(1, int(count_per_image))
    base, remainder = divmod(max(0, int(frame_count)), n)
    return [base + (1 if i < remainder else 0) for i in range(n)]


def build_msr_reference(subjects, background=None, width: int = 736,
                        height: int = 1280,
                        reference_strength: str = "auto",
                        neutral_gray: float = 127 / 255.0,
                        device="cuda") -> np.ndarray:
    """Build the multi-scale-render reference batch: every subject image
    (plus the background, or a neutral-gray placeholder) resized to the
    target and repeated round-robin to fill the strength-derived frame
    count. Returns ``(frames, H, W, 3)`` float32 in [0,1].

    LANCZOS4 resize on ``device``, subjects-then-background order, gray
    placeholder 127.
    """
    from .resize import resample

    device = resolve_device(device)
    panels = []
    for image in subjects:
        array = np.asarray(image, np.float32)
        if array.ndim == 4:
            array = array[0]
        panels.append(array[..., :3])
    if not panels:
        raise ValueError("At least one subject image is required.")
    if background is None:
        panels.append(np.full((int(height), int(width), 3), neutral_gray,
                              np.float32))
    else:
        array = np.asarray(background, np.float32)
        if array.ndim == 4:
            array = array[0]
        panels.append(array[..., :3])

    frame_count = msr_frame_count(reference_strength, len(panels) - 1)
    resized = [resample(torch.from_numpy(np.ascontiguousarray(p)).to(
        device)[None], int(height), int(width), method="lanczos4")[0]
        for p in panels]
    repeats = expand_reference_frames(len(resized), frame_count)
    frames = torch.cat([p[None].expand(r, *p.shape)
                        for p, r in zip(resized, repeats) if r > 0], dim=0)
    return torch.clamp(frames, 0.0, 1.0).cpu().numpy()
