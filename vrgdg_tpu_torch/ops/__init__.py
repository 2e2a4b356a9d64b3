"""Torch image/video ops, counterparts of :mod:`vrgdg_tpu.ops`."""

from .adjust import apply_adjust
from .color_match import color_match, lab_statistics, transfer_lab_statistics
from .compare import (blink, difference, overlay, render_compare,
                      side_by_side, slider)
from .face import (FaceCandidate, crop_face, dedup_candidates,
                   padded_square_box, select_candidate, tile_regions)
from .grade import GradeConfig, from_reference, grade, grade_prepared
from .grain import film_grain, grain_field
from .grid import (build_msr_reference, build_reference_sheet, layout_rects,
                   msr_frame_count)
from .lut import apply_lut, apply_lut_bundle
from .paste_back import (ellipse_composite, gaussian_blur,
                         mean_shift_color_match, paste_back,
                         radial_face_composite, soft_blend_mask,
                         soft_ellipse_mask)
from .resize import (FIT_CROP, FIT_LETTERBOX, FIT_STRETCH, resample,
                     resample_matrix, resize_batch, restore_batch)
from .schedules import (apply_curve, build_transition_values,
                        current_transition_index, first_last_blend,
                        guide_frame_count, interpolation_factor,
                        parse_strength_schedule, runtime_schedule_offset,
                        schedule_index, scheduled_strength)
from .sharpen import box_blur_3x3, laplacian_sharpen, sobel_sharpen, unsharp

__all__ = [
    "apply_adjust", "color_match", "lab_statistics",
    "transfer_lab_statistics", "GradeConfig", "from_reference", "grade",
    "grade_prepared", "film_grain", "grain_field", "apply_lut",
    "apply_lut_bundle", "blink", "difference", "overlay", "render_compare",
    "side_by_side", "slider", "build_reference_sheet", "layout_rects",
    "FIT_CROP", "FIT_LETTERBOX", "FIT_STRETCH", "resample",
    "resample_matrix", "resize_batch", "restore_batch", "box_blur_3x3",
    "laplacian_sharpen", "sobel_sharpen", "unsharp", "FaceCandidate",
    "crop_face", "dedup_candidates", "padded_square_box",
    "select_candidate", "tile_regions", "ellipse_composite",
    "gaussian_blur", "mean_shift_color_match", "paste_back",
    "radial_face_composite", "soft_blend_mask", "soft_ellipse_mask",
    "build_transition_values", "current_transition_index",
    "interpolation_factor", "runtime_schedule_offset", "schedule_index",
    "apply_curve", "first_last_blend", "guide_frame_count",
    "parse_strength_schedule", "scheduled_strength", "build_msr_reference",
    "msr_frame_count",
]
