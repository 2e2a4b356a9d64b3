"""Torch image/video ops, counterparts of :mod:`vrgdg_tpu.ops`."""

from .adjust import apply_adjust
from .color_match import color_match, lab_statistics, transfer_lab_statistics
from .grade import GradeConfig, from_reference, grade, grade_prepared
from .grain import film_grain, grain_field
from .lut import apply_lut, apply_lut_bundle
from .resize import resample, resize_batch, restore_batch
from .sharpen import box_blur_3x3, laplacian_sharpen, sobel_sharpen, unsharp

__all__ = [
    "apply_adjust", "color_match", "lab_statistics",
    "transfer_lab_statistics", "GradeConfig", "from_reference", "grade",
    "grade_prepared", "film_grain", "grain_field", "apply_lut",
    "apply_lut_bundle", "resample", "resize_batch", "restore_batch",
    "box_blur_3x3", "laplacian_sharpen", "sobel_sharpen", "unsharp",
]
