"""Image-switch selection math (batch routing without a node graph).

Counterpart of :mod:`vrgdg_tpu.ops.image_switch`: pick one or more of up
to 50 image batches by an index spec and concatenate them along the
batch axis, as torch ops on the batches' device (the spec parsing is the
original's, copied).

- spec strings accept commas/semicolons, ``a-b`` ranges (either order),
  ``all``, ``none``: first-seen order, duplicates dropped;
- selected batches must agree on (H, W, C) and dtype to combine;
- the "002" variant maps index ``0`` to a synthesized blank frame sized
  like the first available input, on its device;
- the index-map variant routes an integer through a ``key=spec`` table
  with a ``same``-or-spec fallback.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = [
    "parse_index_spec", "parse_index_map", "combine_batches",
    "blank_frame", "switch_select", "switch_dynamic", "switch_index_map",
]

_LEGACY_SLOTS = 4  # the fixed-input nodes expose 4 image slots
_MAX_SLOTS = 50    # the dynamic nodes' ceiling (``:144, 189``)

def _token_values(token: str):
    """Expand one spec token: a token containing ``-`` is a range split
    at the FIRST dash (both halves must parse, either order, emitted
    ascending); otherwise a single int.  Yields nothing for junk —
    matching the reference's skip-on-ValueError per token."""
    if "-" in token:
        head, _dash, tail = token.partition("-")
        try:
            bounds = sorted((int(head.strip()), int(tail.strip())))
        except ValueError:
            return
        yield from range(bounds[0], bounds[1] + 1)
    else:
        try:
            yield int(token)
        except ValueError:
            return


def parse_index_spec(spec: str) -> list[int]:
    """Ordered, deduplicated indices from a spec string
    (``VRGDGswtichNodes.py:37-66``).

    ``""``/``none`` -> ``[]``; ``all`` -> ``[1, 2, 3, 4]`` (the legacy
    4-slot expansion — dynamic variants expand ``all`` against their own
    count before calling this); ranges may be written high-low and are
    emitted ascending; unparsable tokens are skipped.
    """
    text = (spec or "").strip().lower()
    if text in ("", "none"):
        return []
    if text == "all":
        return list(range(1, _LEGACY_SLOTS + 1))
    seen: dict[int, None] = {}
    for token in filter(None, (t.strip() for t in re.split(r"[,;]", text))):
        for value in _token_values(token):
            seen.setdefault(value)
    return list(seen)


def parse_index_map(map_text: str) -> dict[int, list[int]]:
    """``key=spec`` lines (``;`` also separates lines) to an index table
    (``VRGDGswtichNodes.py:68-89``); later duplicate keys win."""
    table: dict[int, list[int]] = {}
    # str.splitlines (NOT a plain \n split): the reference accepts every
    # unicode line terminator (\r, \v, \f, \x1c..) as a row break
    for line in (map_text or "").replace(";", "\n").splitlines():
        key_text, eq, spec = line.partition("=")
        if not eq:
            continue
        try:
            table[int(key_text.strip())] = parse_index_spec(spec)
        except ValueError:
            continue
    return table


def combine_batches(images):
    """Concatenate BHWC batches along axis 0, or ``None`` for an empty
    selection; mismatched (H, W, C)/dtype raises the reference's message
    (``VRGDGswtichNodes.py:5-20``)."""
    batches = [torch.as_tensor(image) for image in images]
    if not batches:
        return None
    head = batches[0]
    for other in batches[1:]:
        if other.shape[1:] != head.shape[1:] or other.dtype != head.dtype:
            raise ValueError("Selected images must have the same shape "
                             "and dtype to combine.")
    return head if len(batches) == 1 else torch.cat(batches, dim=0)


def blank_frame(width: int = 1024, height: int = 576, color: int = 0,
                device="cuda") -> torch.Tensor:
    """A (1, H, W, 3) constant frame from a packed 0xRRGGBB int
    (``VRGDGswtichNodes.py:23-28``)."""
    rgb = np.array([(color >> shift) & 0xFF for shift in (16, 8, 0)],
                   np.float32) / 0xFF
    return torch.from_numpy(rgb).to(device).expand(1, height, width, 3)


def _blank_like(candidates, device) -> torch.Tensor:
    """Blank frame sized from the first 4-D candidate, on its device, else
    the default canvas on ``device`` (``VRGDGswtichNodes.py:30-34``)."""
    for image in candidates:
        if image is not None and getattr(image, "ndim", 0) >= 4:
            return blank_frame(width=int(image.shape[2]),
                               height=int(image.shape[1]),
                               device=torch.as_tensor(image).device)
    return blank_frame(device=device)


def _pick(indices, slots, count):
    """In-range, connected slot values for 1-based ``indices``."""
    return [slots[idx - 1] for idx in indices
            if 1 <= idx <= count and slots[idx - 1] is not None]


def switch_select(index: str, images):
    """``VRGDG_ImageSwitch4.select`` (``VRGDGswtichNodes.py:125-139``):
    spec over up to 4 optional slots (``None`` = unconnected)."""
    slots = (list(images) + [None] * _LEGACY_SLOTS)[:_LEGACY_SLOTS]
    return combine_batches(
        _pick(parse_index_spec(index), slots, _LEGACY_SLOTS))


def switch_dynamic(index: str, image_count: int, images,
                   blank_zero: bool = False, device="cuda"):
    """The dynamic N-way switches (``VRGDGswtichNodes.py:160-184``;
    ``blank_zero=True`` = the "002" variant, ``:205-231``).

    ``images`` maps 1-based slot -> batch (dict) or is a positional
    list.  ``all`` expands to the declared count.  With ``blank_zero``,
    an index of 0 anywhere yields one blank frame sized like the first
    connected input; without it, a spec of ``0`` means "no output".
    With no input connected, the blank frame is made on ``device``.
    """
    count = max(1, min(_MAX_SLOTS, int(image_count)))
    text = (index or "").strip().lower()
    if text in ("", "none") or (text == "0" and not blank_zero):
        return None
    if isinstance(images, dict):
        slots = [images.get(slot) for slot in range(1, count + 1)]
    else:
        slots = (list(images) + [None] * count)[:count]
    indices = (list(range(1, count + 1)) if text == "all"
               else parse_index_spec(text))
    if blank_zero and 0 in indices:
        return _blank_like(slots, device)
    return combine_batches(_pick(indices, slots, count))


def switch_index_map(index: int, map_text: str, fallback: str, images):
    """``VRGDG_ImageIndexMap.select`` (``VRGDGswtichNodes.py:265-289``):
    route an integer through the ``key=spec`` table; a miss uses the
    index itself (``fallback="same"``) or the fallback spec."""
    table = parse_index_map(map_text)
    if index in table:
        indices = table[index]
    elif (fallback or "").strip().lower() == "same":
        indices = [index]
    else:
        indices = parse_index_spec(fallback)
    slots = (list(images) + [None] * _LEGACY_SLOTS)[:_LEGACY_SLOTS]
    return combine_batches(_pick(indices, slots, _LEGACY_SLOTS))
