"""Host runtime: media IO, frame streaming, device feeding.

Re-exports every name of :mod:`vrgdg_tpu.runtime`, each from the port's
copy of its module.  cv2 is imported where it is used, so importing this
package does not load it.
"""

from .llm_batches import (clean_prompt_json, combine_batches,
                          extract_json_block, plan_batch, save_batch,
                          split_prompt_json, story_chapter_state)
from .json_fixers import (clean_lyric_segments,
                          fix_lyric_segments_json,
                          fix_prompt_map_json,
                          fix_story_group_json,
                          merge_segment_durations,
                          prepend_prompt_subject)
from .lyric_align import (SceneAssembler, segments_from_words,
                          timestamped_lyrics)
from .prompt_splitters import (build_prompt_template,
                               merge_lyrics_emotions, split_prompts,
                               split_t2i_i2v, split_text_two)
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
    "PrefetchingReader", "SceneAssembler", "VideoReader", "VideoWriter",
    "array_to_frames",
    "backup_numbered_files", "build_prompt_template",
    "chunk_pipe_prompts", "chunk_quoted_prompts",
    "clean_lyric_segments", "clean_prompt_json",
    "combine_batches", "concat_videos",
    "fix_lyric_segments_json", "fix_prompt_map_json",
    "fix_story_group_json",
    "extract_json_block", "find_ffmpeg", "frames_to_array",
    "image_batch_from_paths", "indexed_image_from_folder",
    "list_images", "load_image",
    "load_videos_from_folder", "log_run_state", "media_has_audio",
    "merge_lyrics_emotions", "merge_segment_durations",
    "prepend_prompt_subject",
    "next_output_index", "normalize_video_path",
    "numbered_image_from_folder", "parse_override_blocks",
    "parse_redo_indexes", "plan_batch", "probe_video",
    "read_run_index", "safe_name", "save_batch",
    "segments_from_words", "select_prompt",
    "split_prompt_json", "split_prompts", "split_t2i_i2v",
    "split_text_two", "step_run_index", "story_chapter_state",
    "timestamped_lyrics", "validate_video_readable",
    "write_video_with_fallback",
]
