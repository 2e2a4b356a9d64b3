"""Library API surface mirroring the reference's applier endpoints: the
ported part of :mod:`vrgdg_tpu.api` (the appliers and previews, compare,
the LUT catalog and adjust presets, and the host-only stores: the music
video builder project store, its instruction store, the text/audio
libraries, storyboard, video editor, LoRA dataset, prompt creator and
start storyboard)."""

from .appliers import (apply_adjust_to_image, apply_adjust_to_video,
                       apply_film_grain_to_image, apply_film_grain_to_video,
                       apply_lut_to_image, apply_lut_to_video, delete_preview,
                       device_name, ffmpeg_browser_encode, grade_video,
                       preview_adjust_on_media, preview_film_grain_on_media,
                       preview_lut_on_media)
from . import (builder, lora_dataset, prompt_creator, start_storyboard,
               storyboard, text_files, video_editor)
from .compare import compare_images, compare_videos
from .paths import (delete_adjust_preset, import_adjust_preset,
                    list_adjust_presets, list_luts, resolve_media_path,
                    safe_lut_path, save_adjust_preset)

__all__ = [
    "builder", "lora_dataset", "prompt_creator", "start_storyboard",
    "storyboard", "text_files", "video_editor",
    "apply_adjust_to_image", "apply_adjust_to_video",
    "apply_film_grain_to_image", "apply_film_grain_to_video",
    "apply_lut_to_image", "apply_lut_to_video", "delete_preview",
    "device_name", "ffmpeg_browser_encode", "grade_video",
    "preview_adjust_on_media", "preview_film_grain_on_media",
    "preview_lut_on_media", "compare_images", "compare_videos",
    "delete_adjust_preset", "import_adjust_preset",
    "list_adjust_presets", "list_luts", "resolve_media_path",
    "safe_lut_path", "save_adjust_preset",
]
