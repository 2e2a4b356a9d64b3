"""Job engine: the segmented, resumable enhancer job, its manifests, and
the guided-enhance prepare/restore math."""

from .enhancer import (JOBS, JobRegistry, apply_effects_batch, cancel_render,
                       enhance_batches, preview_frame, process_with_retry,
                       render_job, start_render, submit_effects_batch)
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
    "safe_conditioning_indices",
]
