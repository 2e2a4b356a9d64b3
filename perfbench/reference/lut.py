"""Plain reference of Apply LUT (``VRGDG_IV_Adjustments.py:345-361``,
``VRGDG_LUTS.apply_lut``) on one uint8 frame: the ``.cube`` lattice's
trilinear interpolation mixed with the input by ``strength / 10``, as
:func:`perfbench.reference.grade.apply_lut` computes it, between the
uint8 steps of :mod:`.common`.

It runs no matrix product, so TF32 cannot arise and the backends' TF32
switches are left as they are.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import common
from .cube import read_cube
from .grade import apply_lut


class Reference:
    """The expected uint8 frames of one run's clips: in float64, or as the
    ``control`` spec of the configuration says (its ``dtype``)."""

    def __init__(self, config: dict, inputs, root: str, device,
                 control: dict | None = None):
        self.dtype = (getattr(torch, control["dtype"]) if control
                      else torch.float64)
        self.device = device
        self.strength = float(config["stack"]["lut_strength"])
        cube = read_cube(os.path.join(root, config["stack"]["lut"]))
        self.table = torch.from_numpy(cube.table).to(device=device,
                                                     dtype=self.dtype)
        self.domain = [torch.from_numpy(d).to(device=device, dtype=self.dtype)
                       for d in (cube.domain_min, cube.domain_max)]

    def frame(self, clip, index: int, frame_u8: np.ndarray) -> np.ndarray:
        x = common.dequantize(frame_u8, self.device, self.dtype)
        return common.quantize(apply_lut(x, self.table, *self.domain,
                                         self.strength))
