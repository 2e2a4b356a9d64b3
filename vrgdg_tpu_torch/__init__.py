"""vrgdg_tpu_torch — the PyTorch/CUDA port of :mod:`vrgdg_tpu`.

The same video post-processing (3D .cube LUTs, the adjust stack, LAB
colour match, sharpening, seeded film grain) over BHWC [0,1] float32
frame tensors, written in PyTorch for one NVIDIA H100.  Every Pallas
kernel of ``vrgdg_tpu`` is a hand-written CUDA kernel for sm_90a here
(:mod:`vrgdg_tpu_torch.kernels`).  Each module mirrors its counterpart
under the same path in ``vrgdg_tpu``, which stays as the reference; this
package imports neither ``jax`` nor ``vrgdg_tpu``.

Layers:
  kernels     -> :mod:`vrgdg_tpu_torch.ops` (torch) + :mod:`vrgdg_tpu_torch.kernels` (CUDA)
  media IO    -> :mod:`vrgdg_tpu_torch.runtime`
  library/CLI -> :mod:`vrgdg_tpu_torch.api` + :mod:`vrgdg_tpu_torch.cli`
"""

__version__ = "0.1.0"

from . import core, ops
from .core.params import (AdjustSettings, ColorMatchParams, EnhancerSettings,
                          GrainParams, LUTParams, SharpenParams)
from .ops.grade import GradeConfig, grade

__all__ = [
    "core", "ops", "AdjustSettings", "ColorMatchParams", "EnhancerSettings",
    "GrainParams", "LUTParams", "SharpenParams", "GradeConfig", "grade",
    "__version__",
]
