"""Host runtime: media IO, frame streaming, stage timing.

Re-exports the names of :mod:`vrgdg_tpu.runtime` whose modules the port
has: ``video_io``, ``media_loaders`` and ``text_tools``.  The names of
``llm_batches``, ``json_fixers``, ``lyric_align`` and
``prompt_splitters`` come with those modules.  cv2 is imported where it
is used, so importing this package does not load it.
"""

from .media_loaders import (image_batch_from_paths,
                            indexed_image_from_folder, list_images,
                            load_image, load_videos_from_folder,
                            numbered_image_from_folder)
from .text_tools import (backup_numbered_files, chunk_pipe_prompts,
                         chunk_quoted_prompts, log_run_state,
                         next_output_index, parse_override_blocks,
                         parse_redo_indexes, read_run_index, select_prompt,
                         step_run_index)
from .video_io import (CODEC_CANDIDATES, IMAGE_EXTENSIONS, VIDEO_EXTENSIONS,
                       PrefetchingReader, VideoReader, VideoWriter,
                       array_to_frames, concat_videos, find_ffmpeg,
                       frames_to_array, media_has_audio, normalize_video_path,
                       probe_video, safe_name, validate_video_readable,
                       write_video_with_fallback)

__all__ = [
    "CODEC_CANDIDATES", "IMAGE_EXTENSIONS", "VIDEO_EXTENSIONS",
    "PrefetchingReader", "VideoReader", "VideoWriter",
    "array_to_frames",
    "backup_numbered_files",
    "chunk_pipe_prompts", "chunk_quoted_prompts",
    "concat_videos",
    "find_ffmpeg", "frames_to_array",
    "image_batch_from_paths", "indexed_image_from_folder",
    "list_images", "load_image",
    "load_videos_from_folder", "log_run_state", "media_has_audio",
    "next_output_index", "normalize_video_path",
    "numbered_image_from_folder", "parse_override_blocks",
    "parse_redo_indexes", "probe_video",
    "read_run_index", "safe_name",
    "select_prompt",
    "step_run_index",
    "validate_video_readable",
    "write_video_with_fallback",
]
