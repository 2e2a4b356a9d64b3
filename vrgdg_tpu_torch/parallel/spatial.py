"""Height sharding: a frame batch split by rows over a space group.

GSPMD gave the JAX package the halo exchange and the ``psum`` of the
colour-match statistics for free (:mod:`vrgdg_tpu.parallel.mesh`).  Here
they are explicit.  :class:`HeightShards` holds a batch whose frames are
split by rows over the devices of one space group (one process's devices,
so every exchange is a device-to-device copy).  Before each stencil a
shard copies the halo rows it reads from the shards that own them
(:meth:`HeightShards.stencil`); the stencils take a
:class:`~vrgdg_tpu_torch.ops.halo.RowWindow`, so they pad only at the
frame's true top and bottom.  What depends on where a row sits in the
whole frame is given the shard's row offset and the frame's height: the
clarity kernel's size, the vignette's centre, grain's Philox counter.

:func:`grade_rows` runs the eager grade stack this way.  Its colour match
sums float64 LAB partials over each shard's own rows, adds them across the
group on the group's first device and applies the per-frame statistics on
every shard.  Stencils and pointwise stages compute what the whole-frame
stack computes; the statistics sum in another order, so the result
matches the unsharded grade within float tolerance (1e-5), the JAX
package's contract for spatial sharding.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.adjust import adjust_stages
from ..ops.color_match import (lab_partials, statistics_from_partials,
                               transfer_lab_statistics)
from ..ops.grade import _SHARPEN_FNS
from ..ops.grain import film_grain
from ..ops.halo import RowWindow
from ..ops.lut import apply_lut, apply_lut_bundle

Stage = Callable[[torch.Tensor, RowWindow], torch.Tensor]


def row_starts(height: int, parts: int) -> list[int]:
    """Row boundaries of ``parts`` near-equal height shards (equal when
    ``parts`` divides ``height``)."""
    return [index * height // parts for index in range(parts + 1)]


def place(frames: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``frames`` on ``device``; a host tensor bound for a card goes
    through pinned memory without blocking the host."""
    if frames.device == device:
        return frames
    if frames.device.type == "cpu" and device.type == "cuda":
        return frames.pin_memory().to(device, non_blocking=True)
    return frames.to(device)


class HeightShards:
    """A BHWC batch split by rows: ``tiles[j]``, on ``devices[j]``, holds
    frame rows ``[starts[j], starts[j + 1])`` of frames ``starts[-1]``
    rows tall."""

    def __init__(self, tiles: list[torch.Tensor], starts: list[int]):
        if len(starts) != len(tiles) + 1:
            raise ValueError("one more row start than tiles is needed")
        self.tiles = list(tiles)
        self.starts = list(starts)

    @classmethod
    def split(cls, frames: torch.Tensor, devices) -> "HeightShards":
        """Split ``frames`` into ``len(devices)`` row shards, each placed
        on its device."""
        starts = row_starts(int(frames.shape[1]), len(devices))
        return cls([place(frames[:, a:b], device) for a, b, device
                    in zip(starts, starts[1:], devices)], starts)

    @property
    def height(self) -> int:
        return self.starts[-1]

    @property
    def devices(self) -> list[torch.device]:
        return [tile.device for tile in self.tiles]

    def window(self, index: int, lo: int, hi: int) -> torch.Tensor:
        """Frame rows ``[lo, hi)`` on shard ``index``'s device, copied from
        the shards that own them."""
        device = self.tiles[index].device
        parts = []
        for tile, start, stop in zip(self.tiles, self.starts,
                                     self.starts[1:]):
            a, b = max(lo, start), min(hi, stop)
            if a < b:
                parts.append(tile[:, a - start:b - start].to(device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def stencil(self, halo: int, stage: Stage) -> "HeightShards":
        """Apply ``stage`` to every shard with ``halo`` rows from its
        neighbours on each side (as far as the frame reaches)."""
        tiles = []
        for index, (start, stop) in enumerate(zip(self.starts,
                                                  self.starts[1:])):
            lo, hi = max(0, start - halo), min(self.height, stop + halo)
            x = self.tiles[index] if halo == 0 else self.window(index, lo, hi)
            tiles.append(stage(x, RowWindow(start, stop - start, self.height,
                                            lo)))
        return HeightShards(tiles, self.starts)

    def map(self, stage: Stage) -> "HeightShards":
        """Apply a per-pixel (or row-position-dependent) ``stage``."""
        return self.stencil(0, stage)

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole frames on ``device``."""
        return torch.cat([tile.to(device) for tile in self.tiles], dim=1)


def color_match_rows(shards: HeightShards, operands: dict,
                     match_strength) -> HeightShards:
    """Colour match over height shards: float64 LAB partials of each
    shard's own rows, summed across the group on its first device, then
    the per-frame statistics applied on every shard."""
    lead = shards.devices[0]
    partials = [lab_partials(tile).to(lead) for tile in shards.tiles]
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    width = shards.tiles[0].shape[2]
    mean, std = statistics_from_partials(total, shards.height * width)

    def stage(tile, rows):
        ref_mean, ref_std = operands[tile.device][3:5]
        stats = (mean.to(tile.device), std.to(tile.device))
        return transfer_lab_statistics(tile, ref_mean, ref_std,
                                       match_strength, stats=stats)

    return shards.map(stage)


def grade_rows(shards: HeightShards, config, operands: dict,
               frame_start: int = 0) -> HeightShards:
    """The eager grade stack (:func:`vrgdg_tpu_torch.ops.grade.grade_prepared`
    with ``fused_mode="eager"``) over height shards.

    ``operands`` maps each shard's device to its
    :func:`~vrgdg_tpu_torch.ops.grade.prepare_operands` tuple.  Grain is
    the eager ``film_grain`` (``grain_mode="eager"``), keyed on the
    absolute frame and on each pixel's row in the whole frame."""
    height = shards.height
    width = int(shards.tiles[0].shape[2])
    if config.lut is not None:
        apply = apply_lut_bundle if config.lut_mode == "bundle" else apply_lut

        def lut_stage(tile, rows):
            table, dmin, dmax = operands[tile.device][:3]
            return apply(tile, table, dmin, dmax, strength=config.lut.strength)

        shards = shards.map(lut_stage)
    if config.adjust is not None:
        for halo, stage in adjust_stages(config.adjust, height, width):
            shards = shards.stencil(halo, stage)
    if config.color_match is not None:
        shards = color_match_rows(shards, operands,
                                  config.color_match.match_strength)
    if config.sharpen is not None and config.sharpen.strength > 0:
        sharpen = _SHARPEN_FNS[config.sharpen.kind]
        shards = shards.stencil(1, lambda x, rows: sharpen(
            x, config.sharpen.strength, config.sharpen.border, rows=rows))
    if config.grain is not None and config.grain.intensity > 0:
        grain = config.grain
        shards = shards.map(lambda tile, rows: film_grain(
            tile, grain.intensity, grain.saturation_mix, grain.seed,
            frame_start=frame_start, row_start=rows.start,
            frame_height=rows.height))
    return shards
