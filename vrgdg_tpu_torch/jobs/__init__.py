"""Job engine: the segmented, resumable enhancer job, its manifests, the
guided-enhance prepare/restore math, and the two face-repair job systems
(the Face Fix engine and its in-memory pipeline)."""

from .enhancer import (JOBS, JobRegistry, apply_effects_batch, cancel_render,
                       enhance_batches, preview_frame, process_with_retry,
                       render_job, start_render, submit_effects_batch)
from .face_fix import (accept_enhanced_anchor, accept_enhanced_crop,
                       accept_ltx_frames, build_ltx_inputs, estimate_anchors,
                       finalize_face_fix, prepare_face_fix)
from .face_fix_pipeline import (FaceFixContext, collect_ltx_inputs,
                                composite_repaired, create_crop_video,
                                prepare_face_pipeline,
                                run_face_fix_pipeline)
from .manifest import (manifest_path, prune_completed, read_manifest,
                       segment_file_name, settings_fingerprint,
                       write_manifest)
from .prepare_restore import (EnhanceContext, anchor_indices, prepare,
                              restore, run_guided_enhance,
                              safe_conditioning_indices)

__all__ = [
    "JOBS", "JobRegistry", "apply_effects_batch", "cancel_render",
    "enhance_batches", "preview_frame", "process_with_retry", "render_job",
    "start_render", "submit_effects_batch", "manifest_path",
    "prune_completed", "read_manifest", "segment_file_name",
    "settings_fingerprint", "write_manifest", "EnhanceContext",
    "anchor_indices", "prepare", "restore", "run_guided_enhance",
    "safe_conditioning_indices", "accept_enhanced_anchor",
    "accept_enhanced_crop", "accept_ltx_frames", "build_ltx_inputs",
    "estimate_anchors", "finalize_face_fix", "prepare_face_fix",
    "FaceFixContext", "collect_ltx_inputs", "composite_repaired",
    "create_crop_video", "prepare_face_pipeline", "run_face_fix_pipeline",
]
