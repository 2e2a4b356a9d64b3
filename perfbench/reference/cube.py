"""A ``.cube`` 3D LUT reader (Adobe's Cube LUT format, 1.0).

Keywords ``TITLE``, ``LUT_3D_SIZE``, ``DOMAIN_MIN``, ``DOMAIN_MAX``; ``#``
starts a comment; a 1D LUT is refused.  Data lines list the lattice with
red varying fastest, so the table is indexed ``[blue, green, red]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Cube:
    table: np.ndarray        # (N, N, N, 3) float64, [blue, green, red]
    domain_min: np.ndarray   # (3,) float64
    domain_max: np.ndarray


def read_cube(path: str) -> Cube:
    size = None
    domain_min = np.zeros(3)
    domain_max = np.ones(3)
    values: list[list[float]] = []
    with open(path, encoding="utf-8", errors="ignore") as handle:
        for raw in handle:
            words = raw.split("#", 1)[0].split()
            if not words:
                continue
            key = words[0].upper()
            if key == "TITLE":
                continue
            if key == "LUT_1D_SIZE":
                raise ValueError(f"{path}: a 1D LUT")
            if key == "LUT_3D_SIZE":
                size = int(words[1])
            elif key == "DOMAIN_MIN":
                domain_min = np.array([float(w) for w in words[1:4]])
            elif key == "DOMAIN_MAX":
                domain_max = np.array([float(w) for w in words[1:4]])
            elif key[0].isalpha():
                continue
            else:
                values.append([float(w) for w in words[:3]])
    if size is None or len(values) != size ** 3:
        raise ValueError(f"{path}: {len(values)} entries for size {size}")
    table = np.array(values, np.float64).reshape(size, size, size, 3)
    return Cube(table=table, domain_min=domain_min, domain_max=domain_max)
