"""HTTP API of the port: every route group of
:mod:`vrgdg_tpu.server.routes` on aiohttp, like for like: the same paths,
methods, status codes and JSON bodies, the same mutation guard, 1 GiB body
limit and multipart upload in 1 MiB chunks.

Registered groups (one function each, so later groups can be added one
module at a time):

- enhancer ``/vrgdg/video_enhancer/{upload,load,preview,render/start,
  render/status,render/cancel,media}``;
- LUT/grain/adjust under ``/vrgdg/music_builder/``: catalog, examples,
  image and video appliers, previews, ``post_process/grade_video``,
  presets and the two ``delete_preview`` paths;
- ``/vrgdg/music_builder/create_silent_audio``, ``beats/analyze``,
  ``beats/scene_srt`` and ``audio/peaks``;
- compare ``/vrgdg/compare/{image,video,grid}``;
- face fix ``/vrgdg/face_fix/...`` (eight paths);
- the music video builder project store and its LLM-instruction store
  under ``/vrgdg/music_builder/`` (44 paths), the text/audio libraries
  (``/vrgdg/text_files/``, ``/vrgdg/audio/``, ``/vrgdg/part2/``,
  ``/vrgdg/test_popup/`` and the builder's ``load_text_file`` /
  ``save_text_file``), ``/vrgdg/storyboard/``, ``/vrgdg/video_editor/``
  and ``/vrgdg/lora_dataset/``: host-only, they reach no device;
- the workflow runner ``/vrgdg/workflow_runner/`` (30 paths: the prompt
  builders, the model root, the scene-audio trim and the scene-render
  routes, whose ffmpeg calls go through ``scene_render``'s runner seam),
  the prompt creator ``/vrgdg/music_prompt_creator/`` (13),
  ``/vrgdg/start_storyboard/`` (8) and the Krea2 LoRA Studio
  ``/vrgdg/krea2_studio/`` (15): host-only as well;
- timestamped lyrics and lyric sheets ``/vrgdg/lyrics/`` (2), the LLM
  batch loop and the combined-file browser ``/vrgdg/llm_batches/`` (8,
  under ``<output>/llm_batches``), the cycling text pickers
  ``/vrgdg/text_tools/`` (2) and the graph plans ``/vrgdg/graph/`` (2):
  host-only;
- ``/vrgdg/health``, ``/vrgdg/update/status``,
  ``/vrgdg/node_canvas/status``, the panel at ``/vrgdg/ui`` and the ``/``
  redirect to it.

Every handler that reaches the device takes the app's one device, which
:func:`create_app` resolves once: ``cuda`` without a visible card raises
there, and nothing on a request falls back to the CPU or to the eager
grade.  Blocking work runs in the event loop's default executor, so
requests reach the card from several threads at once, beside the
enhancer's render thread.  Errors become ``{"ok": false, "error": ...}``:
404 for ``FileNotFoundError``, 400 for anything else.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import subprocess
import time
import uuid
from dataclasses import dataclass
from typing import Callable

from aiohttp import web

from .. import __version__
from ..api import appliers, compare, paths
from ..api import builder as mvb
from ..api import instructions as instr
from ..api import krea2_studio as k2s
from ..api import lora_dataset as lds
from ..api import pc_instructions as pci
from ..api import prompt_creator as pcr
from ..api import scene_render
from ..api import start_storyboard as ssb
from ..api import storyboard as sbd
from ..api import text_files as tfl
from ..api import video_editor as ved
from ..api import workflow_runner
from ..jobs import enhancer as enh
from ..jobs import face_fix as ff
from ..release_notes import latest_release, load_release_notes
from ..runtime import combined_files as cbf
from ..runtime import graph_plans as gp
from ..runtime import llm_batches as lbx
from ..runtime import lyric_align as lal
from ..runtime import text_pickers as tp
from ..runtime import video_io

# The panel is a data file of the JAX package, read where it lies: reading
# it imports nothing.
PANEL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "vrgdg_tpu", "server", "static", "index.html")

# GET routes that write project state anyway (export ingests media and
# rewrites session.json) must pass the same cross-site checks as POSTs
_MUTATING_GET_PATHS = frozenset({
    "/vrgdg/music_builder/export_project",
})

# grade_video's fused_mode as the panel and the JAX package name it, and
# the port's name for the same path
_FUSED_MODES = {"xla": "eager", "pallas": "fused"}

_LOG = logging.getLogger(__name__)


def _ok(**payload):
    return web.json_response({"ok": True, **payload})


def _err(exc, status=400):
    return web.json_response({"ok": False, "error": str(exc)}, status=status)


def _handler(fn):
    """Wrap a handler body: a plain function runs in the executor; errors
    become JSON (404 for ``FileNotFoundError``, else 400)."""

    @functools.wraps(fn)
    async def wrapper(request):
        try:
            if asyncio.iscoroutinefunction(fn):
                return await fn(request)
            return await asyncio.get_running_loop().run_in_executor(
                None, fn, request)
        except FileNotFoundError as exc:
            return _err(exc, status=404)
        except Exception as exc:  # noqa: BLE001 — the request boundary
            _LOG.warning("%s %s failed", request.method, request.path,
                         exc_info=True)
            return _err(exc)

    return wrapper


async def _json(request):
    """The JSON body; ``{}`` when it is missing or malformed."""
    try:
        return await request.json()
    except Exception:  # noqa: BLE001 — as the JAX server's _json
        return {}


def _json_route(routes, path: str, fn: Callable[[dict], dict],
                flat: bool = False) -> None:
    """A JSON route: ``fn(payload)`` in the executor, answered as
    ``{"ok": true, "result": ...}``, or its keys beside ``ok`` with
    ``flat``."""

    @routes.post(path)
    @_handler
    async def handler(request):
        payload = await _json(request)
        result = await asyncio.get_running_loop().run_in_executor(
            None, fn, payload)
        return _ok(**result) if flat else _ok(result=result)


@web.middleware
async def _mutation_guard(request, handler):
    """Reject cross-site mutations, as the JAX server's middleware.

    Every non-GET route can write user-supplied filesystem paths, so a
    hostile web page must not be able to drive them via CSRF against
    127.0.0.1: browsers attach an ``Origin`` header to cross-origin
    POSTs, which same-host requests (the bundled panel) and header-less
    local tools (curl, the CLI) never trip.  Setting ``VRGDG_TPU_TOKEN``
    additionally requires ``X-VRGDG-Token`` on all mutating requests.
    """
    mutating = request.method not in ("GET", "HEAD", "OPTIONS") \
        or request.path in _MUTATING_GET_PATHS
    if mutating:
        origin = request.headers.get("Origin")
        if origin:
            from urllib.parse import urlparse

            if urlparse(origin).netloc != request.headers.get("Host", ""):
                return web.json_response(
                    {"ok": False,
                     "error": "Cross-origin mutation rejected."},
                    status=403)
        token = os.environ.get("VRGDG_TPU_TOKEN", "")
        if token and request.headers.get("X-VRGDG-Token") != token:
            return web.json_response(
                {"ok": False,
                 "error": "Missing or invalid X-VRGDG-Token header."},
                status=403)
    return await handler(request)


async def _drain_part(part, sink) -> None:
    """Stream a multipart body part into ``sink(bytes)`` in 1 MiB chunks."""
    chunk = await part.read_chunk(1 << 20)
    while chunk:
        sink(chunk)
        chunk = await part.read_chunk(1 << 20)


@dataclass(frozen=True)
class _Context:
    """What the route groups share: the folders, the device and its name."""

    base_folder: str | None
    luts_dir: str | None
    device: object
    backend: str

    @property
    def out_root(self) -> str:
        """The managed root of the host-only stores."""
        return os.path.abspath(self.base_folder or paths.DEFAULT_OUTPUT_ROOT)


# --------------------------------------------------------------------------
# Route groups
# --------------------------------------------------------------------------

def _enhancer_routes(routes, ctx: _Context) -> None:
    base, device, registry = ctx.base_folder, ctx.device, enh.JOBS

    @routes.post("/vrgdg/video_enhancer/upload")
    @_handler
    async def enhancer_upload(request):
        reader = await request.multipart()
        saved_path = ""
        async for part in reader:
            if part.name != "video" or not part.filename:
                continue
            safe = video_io.safe_name(part.filename, "uploaded_video")
            if os.path.splitext(safe)[1].lower() not in video_io.VIDEO_EXTENSIONS:
                raise ValueError("Unsupported video type.")
            saved_path = os.path.join(
                enh.upload_folder(base),
                f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}_{safe}")
            with open(saved_path, "wb") as handle:
                await _drain_part(part, handle.write)
            break
        if not saved_path:
            raise ValueError("No video was uploaded.")
        return _ok(video=video_io.probe_video(saved_path))

    @routes.post("/vrgdg/video_enhancer/load")
    @_handler
    async def enhancer_load(request):
        payload = await _json(request)
        return _ok(video=video_io.probe_video(payload.get("path")))

    _json_route(routes, "/vrgdg/video_enhancer/preview",
                lambda p: enh.preview_frame(
                    p.get("source_path"), float(p.get("timestamp") or 0),
                    p.get("settings"), base_folder=base, device=device),
                flat=True)

    @routes.post("/vrgdg/video_enhancer/render/start")
    @_handler
    async def enhancer_start(request):
        payload = await _json(request)
        return _ok(job=enh.start_render(
            payload, payload.get("resume_job_id") or "", registry=registry,
            base_folder=base, device=device))

    @routes.get("/vrgdg/video_enhancer/render/status")
    @_handler
    def enhancer_status(request):
        job = registry.snapshot(str(request.query.get("job_id") or "").strip())
        if not job:
            raise FileNotFoundError("Enhancement job was not found.")
        return _ok(job=job)

    @routes.post("/vrgdg/video_enhancer/render/cancel")
    @_handler
    async def enhancer_cancel(request):
        payload = await _json(request)
        return _ok(job=enh.cancel_render(
            str(payload.get("job_id") or "").strip(), registry=registry))

    @routes.get("/vrgdg/video_enhancer/media")
    @_handler
    def enhancer_media(request):
        path = os.path.normpath(os.path.abspath(
            str(request.query.get("path") or "").strip()))
        # only the roots this server itself writes media into
        roots = (enh.root_folder(base), paths.preview_root(base),
                 os.path.abspath(base or paths.DEFAULT_OUTPUT_ROOT))
        if not any(paths._inside(root, path) for root in roots):
            raise FileNotFoundError("Media file was not found.")
        if not os.path.isfile(path):
            raise FileNotFoundError("Media file was not found.")
        allowed = video_io.VIDEO_EXTENSIONS | {".png", ".jpg", ".jpeg", ".webp"}
        if os.path.splitext(path)[1].lower() not in allowed:
            raise ValueError("Unsupported media type.")
        return web.FileResponse(path)


def _grade_video(payload: dict, luts_dir, device) -> dict:
    """``post_process/grade_video`` with the JAX package's ``fused_mode``
    names: ``xla`` runs the eager chain, ``pallas`` the two CUDA kernels
    (which never fall back to eager); the result names the mode as asked."""
    requested = str(payload.get("fused_mode", "xla"))
    if requested not in _FUSED_MODES:
        raise ValueError(f"Unknown fused_mode {requested!r}; expected 'xla' "
                         "or 'pallas'.")
    result = appliers.grade_video(
        payload.get("input"), payload.get("output", ""),
        lut_name=payload.get("lut"),
        lut_strength=float(payload.get("strength", 10.0)),
        adjust=payload.get("adjust"),
        reference_image=payload.get("reference_image"),
        match_strength=float(payload.get("match_strength", 1.0)),
        sharpen_strength=float(payload.get("sharpen_strength", 0.0)),
        grain_intensity=float(payload.get("grain_intensity", 0.0)),
        saturation_mix=float(payload.get("saturation_mix", 0.5)),
        seed=int(payload.get("seed", 0)),
        batch_size=int(payload.get("batch_size", 8)),
        preserve_audio=bool(payload.get("preserve_audio", True)),
        luts_dir=luts_dir, fused_mode=_FUSED_MODES[requested], device=device)
    return {**result, "fused_mode": requested}


def _lut_grain_adjust_routes(routes, ctx: _Context) -> None:
    base, luts_dir, device = ctx.base_folder, ctx.luts_dir, ctx.device

    @routes.get("/vrgdg/music_builder/luts")
    @_handler
    def luts_list(request):
        return _ok(**paths.list_luts(luts_dir))

    @routes.get("/vrgdg/music_builder/luts/example")
    @_handler
    def luts_example(request):
        name = str(request.query.get("name") or "")
        catalog = paths.list_luts(luts_dir)
        path = os.path.join(catalog["examples_dir"], os.path.basename(name))
        if not os.path.isfile(path):
            raise FileNotFoundError("Example image was not found.")
        return web.FileResponse(path)

    route = functools.partial(_json_route, routes)
    route("/vrgdg/music_builder/luts/apply_image",
          lambda p: appliers.apply_lut_to_image(
              p.get("input"), p.get("lut"), p.get("output", ""),
              float(p.get("strength", 10.0)),
              replace_source=bool(p.get("replace_source")),
              luts_dir=luts_dir, device=device))
    route("/vrgdg/music_builder/luts/apply_video",
          lambda p: appliers.apply_lut_to_video(
              p.get("input"), p.get("lut"), p.get("output", ""),
              float(p.get("strength", 10.0)),
              batch_size=int(p.get("batch_size", 8)),
              replace_source=bool(p.get("replace_source")),
              preserve_audio=bool(p.get("preserve_audio", True)),
              encode_crf=p.get("encode_crf", 23),
              encode_preset=p.get("encode_preset", "medium"),
              luts_dir=luts_dir, device=device))
    route("/vrgdg/music_builder/luts/preview",
          lambda p: appliers.preview_lut_on_media(
              p.get("input"), p.get("lut"), float(p.get("strength", 10.0)),
              luts_dir=luts_dir, base=base, device=device))
    route("/vrgdg/music_builder/post_process/apply_film_grain_image",
          lambda p: appliers.apply_film_grain_to_image(
              p.get("input"), p.get("output", ""),
              float(p.get("grain_intensity", 0.04)),
              float(p.get("saturation_mix", 0.5)), p.get("seed"),
              replace_source=bool(p.get("replace_source")), device=device))
    route("/vrgdg/music_builder/post_process/apply_film_grain_video",
          lambda p: appliers.apply_film_grain_to_video(
              p.get("input"), p.get("output", ""),
              float(p.get("grain_intensity", 0.04)),
              float(p.get("saturation_mix", 0.5)), p.get("seed"),
              batch_size=int(p.get("batch_size", 8)),
              replace_source=bool(p.get("replace_source")),
              preserve_audio=bool(p.get("preserve_audio", True)),
              encode_crf=p.get("encode_crf", 26),
              encode_preset=p.get("encode_preset", "medium"), device=device))
    route("/vrgdg/music_builder/post_process/preview_film_grain",
          lambda p: appliers.preview_film_grain_on_media(
              p.get("input"), float(p.get("grain_intensity", 0.04)),
              float(p.get("saturation_mix", 0.5)), p.get("seed"),
              base=base, device=device))
    route("/vrgdg/music_builder/post_process/apply_adjust_image",
          lambda p: appliers.apply_adjust_to_image(
              p.get("input"), p.get("output", ""), p.get("settings"),
              replace_source=bool(p.get("replace_source")), device=device))
    route("/vrgdg/music_builder/post_process/apply_adjust_video",
          lambda p: appliers.apply_adjust_to_video(
              p.get("input"), p.get("output", ""), p.get("settings"),
              batch_size=int(p.get("batch_size", 8)),
              replace_source=bool(p.get("replace_source")),
              preserve_audio=bool(p.get("preserve_audio", True)),
              encode_crf=p.get("encode_crf", 23),
              encode_preset=p.get("encode_preset", "medium"), device=device))
    route("/vrgdg/music_builder/post_process/preview_adjust",
          lambda p: appliers.preview_adjust_on_media(
              p.get("input"), p.get("settings"), base=base, device=device))
    route("/vrgdg/music_builder/post_process/grade_video",
          lambda p: _grade_video(p, luts_dir, device))
    # the reference answers the delete under both prefixes
    for prefix in ("post_process", "luts"):
        route(f"/vrgdg/music_builder/{prefix}/delete_preview",
              lambda p: {"deleted": appliers.delete_preview(p.get("path"),
                                                            base=base)})

    @routes.get("/vrgdg/music_builder/post_process/adjust_presets")
    @_handler
    def presets_list(request):
        return _ok(presets=paths.list_adjust_presets(base=base))

    route("/vrgdg/music_builder/post_process/save_adjust_preset",
          lambda p: paths.save_adjust_preset(p.get("name"), p.get("settings"),
                                             base=base))
    route("/vrgdg/music_builder/post_process/import_adjust_preset",
          lambda p: paths.import_adjust_preset(p.get("path"), base=base))
    route("/vrgdg/music_builder/post_process/delete_adjust_preset",
          lambda p: {"deleted": paths.delete_adjust_preset(p.get("name"),
                                                           base=base)})


def _beats_analyze(payload: dict) -> dict:
    from ..runtime import audio_toolkit as at
    from ..runtime import beats as beats_rt

    stems = {name: at.load_audio(payload[key])
             for name, key in (("drums", "drums_path"), ("bass", "bass_path"),
                               ("vocals", "vocals_path"),
                               ("other", "other_path"))
             if payload.get(key)}
    return beats_rt.analyze_beats(at.load_audio(payload["mix_path"]), **stems)


def _beats_scene_srt(payload: dict) -> dict:
    from ..runtime import beats as beats_rt

    return beats_rt.generate_scene_srt(
        payload.get("beat_data"), float(payload.get("min_duration", 2.0)),
        float(payload.get("max_duration", 10.0)),
        float(payload.get("bias", 0.7)),
        str(payload.get("duration_preset", "impact_weighted")),
        int(payload.get("seed", 0)),
        output_path=payload.get("output_path") or None)


def _audio_peaks(payload: dict) -> dict:
    from ..runtime import audio as audio_rt

    return audio_rt.read_audio_peaks(payload["path"],
                                     int(payload.get("target_peaks", 600)))


def _audio_routes(routes, ctx: _Context) -> None:
    """Silent audio, beat analysis and scene durations, peak envelopes:
    host numpy, no device."""
    from ..runtime import audio

    _json_route(routes, "/vrgdg/music_builder/create_silent_audio",
                  audio.create_silent_audio, flat=True)
    _json_route(routes, "/vrgdg/music_builder/beats/analyze", _beats_analyze)
    _json_route(routes, "/vrgdg/music_builder/beats/scene_srt", _beats_scene_srt)
    _json_route(routes, "/vrgdg/music_builder/audio/peaks", _audio_peaks)


def _compare_routes(routes, ctx: _Context) -> None:
    base, device = ctx.base_folder, ctx.device

    def output(payload, ext):
        given = str(payload.get("output") or "").strip()
        if given:
            return given
        # under the served enhancer root, so the panel plays it back
        return os.path.join(enh.root_folder(base),
                            f"compare_{payload.get('mode', 'slider')}_"
                            f"{int(time.time() * 1000)}{ext}")

    _json_route(routes, "/vrgdg/compare/image", lambda p: compare.compare_images(
        p.get("input_a"), p.get("input_b"), p.get("mode", "slider"),
        output(p, ".png"),
        slider_position=float(p.get("slider_position", 0.5)),
        overlay_opacity=float(p.get("overlay_opacity", 0.5)),
        difference_gain=float(p.get("difference_gain", 1.0)), device=device))
    _json_route(routes, "/vrgdg/compare/video", lambda p: compare.compare_videos(
        p.get("input_a"), p.get("input_b"), p.get("mode", "slider"),
        output(p, ".mp4"),
        slider_position=float(p.get("slider_position", 0.5)),
        overlay_opacity=float(p.get("overlay_opacity", 0.5)),
        difference_gain=float(p.get("difference_gain", 1.0)),
        blink_speed=float(p.get("blink_speed", 1.0)),
        batch_size=int(p.get("batch_size", 8)), device=device))

    def grid(payload):
        # a labeled comparison grid over explicit paths or a folder; host
        # cv2, as in the JAX package
        folder = str(payload.get("folder") or "").strip()
        sources = video_io.find_grid_videos(folder) if folder \
            else [str(path) for path in payload.get("paths", [])]
        frames = video_io.render_video_grid(
            sources, labels=payload.get("labels"),
            cell_width=int(payload.get("cell_width", 0)),
            cell_height=int(payload.get("cell_height", 0)),
            label_tiles=bool(payload.get("label_tiles", True)))
        out = str(payload.get("output") or "").strip() or os.path.join(
            enh.root_folder(base),
            f"compare_grid_{int(time.time() * 1000)}.mp4")
        fps = float(payload.get("fps", 24.0))
        with video_io.VideoWriter(out, fps, frames.shape[2],
                                  frames.shape[1]) as writer:
            for frame in video_io.array_to_frames(frames):
                writer.write_bgr(frame)
        return {"output": os.path.abspath(out), "frames": int(frames.shape[0]),
                "tiles": len(sources), "fps": fps}

    _json_route(routes, "/vrgdg/compare/grid", grid)


def _face_fix_routes(routes, ctx: _Context) -> None:
    route = functools.partial(_json_route, routes)
    route("/vrgdg/face_fix/prepare", ff.prepare_face_fix, flat=True)
    route("/vrgdg/face_fix/estimate_anchors", ff.estimate_anchors, flat=True)
    route("/vrgdg/face_fix/accept_enhanced", ff.accept_enhanced_crop,
          flat=True)
    route("/vrgdg/face_fix/accept_enhanced_anchor", ff.accept_enhanced_anchor,
          flat=True)
    # the reference names this build_ltx_prompt; both names serve it
    route("/vrgdg/face_fix/build_ltx_prompt", ff.build_ltx_inputs, flat=True)
    route("/vrgdg/face_fix/build_ltx_inputs", ff.build_ltx_inputs, flat=True)
    route("/vrgdg/face_fix/accept_ltx_frames", ff.accept_ltx_frames,
          flat=True)
    route("/vrgdg/face_fix/finalize",
          lambda p: ff.finalize_face_fix(p, device=ctx.device), flat=True)


def _truthy(text) -> bool:
    return str(text or "").strip().lower() in ("1", "true", "yes", "on")


def _builder_routes(routes, ctx: _Context) -> None:
    """The music video builder project store and its LLM-instruction
    store: flat ``{"ok": true, **result}`` answers, as the reference's."""
    out_root = ctx.out_root

    def route(name, fn):
        _json_route(routes, "/vrgdg/music_builder/" + name, fn, flat=True)

    route("analyze_audio", lambda p: mvb.analyze_audio(p, out_root))
    route("import_capcut_beats",
          lambda p: mvb.find_latest_capcut_beats(p.get("audio_duration", 0)))
    route("save_session", lambda p: mvb.save_session(p, out_root))
    route("save_render_log", mvb.save_render_log)
    route("save_wizard_draft", mvb.save_wizard_draft)
    route("load_wizard_draft", mvb.load_wizard_draft)
    route("new_project", lambda p: mvb.new_project(p, out_root))
    route("save_project_as", lambda p: mvb.save_project_as(p, out_root))
    route("save_scene_image", mvb.save_scene_image)
    route("delete_project_media", mvb.delete_media)
    route("archive_scene_image", mvb.archive_scene_image)
    route("extract_video_final_frame", mvb.extract_final_frame)
    route("save_flux_reference_image", mvb.save_reference_image)
    route("import_reference_subjects",
          lambda p: mvb.import_reference_cards(p, "subject"))
    route("import_reference_locations",
          lambda p: mvb.import_reference_cards(p, "location"))
    route("save_scene_audio", mvb.save_scene_audio)
    route("save_project_audio", mvb.save_project_audio)
    route("save_project_srt", mvb.save_project_srt)
    route("save_single_scene_srt", mvb.save_scene_srt)
    route("trim_scene_audio", mvb.trim_scene_audio)
    route("prepare_scene_audio_mix", mvb.mix_scene_audio)
    route("load_session", lambda p: mvb.load_session(p.get("project_folder")))
    route("delete_project", lambda p: mvb.delete_project(p, out_root))
    route("scan_scene_videos",
          lambda p: mvb.scan_scene_videos(p.get("project_folder")))
    route("restore_scene_video", mvb.restore_scene_video)
    route("load_srt",
          lambda p: mvb.load_srt(p.get("path") or p.get("srt_path")))
    route("load_prompt_json", lambda p: mvb.load_prompt_json(p.get("path")))
    route("project_prompt_creator_paths",
          lambda p: mvb.prompt_creator_paths(p.get("project_folder")))
    route("import_latest_prompt_creator_outputs",
          lambda p: mvb.copy_prompt_creator_outputs(
              p.get("project_folder"), "", out_root))
    route("copy_prompt_creator_outputs",
          lambda p: mvb.copy_prompt_creator_outputs(
              p.get("project_folder"), p.get("source_project_folder", ""),
              out_root))

    route("get_instruction", instr.get_instruction)
    route("save_instruction", instr.save_instruction)
    route("reset_instruction", instr.reset_instruction)
    route("list_instruction_presets", lambda p: instr.list_presets(p, out_root))
    route("save_instruction_preset", lambda p: instr.save_preset(p, out_root))
    route("load_instruction_preset", lambda p: instr.load_preset(p, out_root))

    @routes.get("/vrgdg/music_builder/instruction_keys")
    @_handler
    def builder_instruction_keys(request):
        return _ok(keys=[{"key": key, "label": entry["label"],
                          "preset_group": instr.preset_group(key),
                          "preset_group_label": instr.preset_group_label(key)}
                         for key, entry in instr.REGISTRY.items()])

    @routes.get("/vrgdg/music_builder/list_projects")
    @_handler
    def builder_list_projects(request):
        return _ok(**mvb.list_projects(
            out_root, str(request.query.get("project_root") or "")))

    @routes.get("/vrgdg/music_builder/model_defaults")
    @_handler
    def builder_model_defaults(request):
        return _ok(**mvb.load_model_defaults(out_root))

    @routes.get("/vrgdg/music_builder/default_context_paths")
    @_handler
    def builder_default_context_paths(request):
        return _ok(**mvb.default_context_paths(out_root))

    @routes.get("/vrgdg/music_builder/default_audio_srt_paths")
    @_handler
    def builder_default_audio_srt_paths(request):
        return _ok(**mvb.default_audio_srt_paths(out_root))

    @routes.get("/vrgdg/music_builder/audio")
    @_handler
    def builder_audio(request):
        path = os.path.normpath(os.path.abspath(
            str(request.query.get("path") or "").strip()))
        # only audio under the managed root is served
        if not paths._inside(out_root, path) or not os.path.isfile(path):
            raise FileNotFoundError("Audio file was not found.")
        if os.path.splitext(path)[1].lower() not in mvb.AUDIO_EXTENSIONS:
            raise ValueError("Unsupported audio type.")
        return web.FileResponse(path)

    @routes.get("/vrgdg/music_builder/export_project")
    @_handler
    async def builder_export_project(request):
        loop = asyncio.get_running_loop()
        zip_path, download_name = await loop.run_in_executor(
            None, mvb.export_project, request.query.get("project_folder", ""))
        response = web.StreamResponse(status=200, headers={
            "Content-Type": "application/zip",
            "Content-Disposition": f'attachment; filename="{download_name}"',
            "Content-Length": str(os.path.getsize(zip_path)),
            "Cache-Control": "no-store"})
        try:
            await response.prepare(request)
            with open(zip_path, "rb") as handle:
                while True:
                    chunk = await loop.run_in_executor(None, handle.read,
                                                       1 << 20)
                    if not chunk:
                        break
                    await response.write(chunk)
            await response.write_eof()
            return response
        finally:
            try:
                os.remove(zip_path)
            except OSError:
                pass

    @routes.post("/vrgdg/music_builder/import_project")
    @_handler
    async def builder_import_project(request):
        import tempfile

        reader = await request.multipart()
        requested_name, temp_path = "", ""
        try:
            async for part in reader:
                if part.name == "project_name":
                    requested_name = (await part.text()).strip()
                elif part.name == "project_zip":
                    handle = tempfile.NamedTemporaryFile(
                        prefix="vrgdg_builder_import_", suffix=".zip",
                        delete=False)
                    temp_path = handle.name
                    try:
                        await _drain_part(part, handle.write)
                    finally:
                        handle.close()
            if not temp_path or not os.path.isfile(temp_path):
                raise ValueError(
                    "Choose a .vrgdg.zip project package to import.")
            result = await asyncio.get_running_loop().run_in_executor(
                None, mvb.import_project, temp_path, requested_name, out_root)
            return _ok(**result)
        finally:
            if temp_path:
                try:
                    os.remove(temp_path)
                except OSError:
                    pass


async def _audio_part(request, field: str, flag: str | None = None):
    """The multipart upload of one audio file: ``(filename, bytes, flag)``,
    ``flag`` being the truthiness of the text field named so."""
    reader = await request.multipart()
    filename, chunks, flagged = "", [], False
    async for part in reader:
        if flag is not None and part.name == flag:
            flagged = _truthy(await part.text())
        elif part.name == field:
            filename = part.filename or ""
            await _drain_part(part, chunks.append)
    if not filename:
        raise ValueError("Missing audio file.")
    return filename, b"".join(chunks), flagged


def _text_file_routes(routes, ctx: _Context) -> None:
    """The text-file browser and savers, the audio library, the
    ConceptPrompts handoff and the quick-input popup."""
    out_root = ctx.out_root
    for name in ("load_text_file", "save_text_file"):
        _json_route(routes, "/vrgdg/music_builder/" + name,
                    getattr(tfl, name), flat=True)

    @routes.get("/vrgdg/text_files/list")
    @_handler
    def text_files_list(request):
        return _ok(**tfl.list_category(request.query.get("category"),
                                       out_root))

    @routes.get("/vrgdg/text_files/folders")
    @_handler
    def text_files_folders(request):
        return _ok(**tfl.list_folders(out_root))

    @routes.get("/vrgdg/text_files/files")
    @_handler
    def text_files_for_folder(request):
        query = request.query
        return _ok(**tfl.list_folder_files(
            query.get("folder", ""),
            use_most_recent=_truthy(query.get("use_most_recent")),
            custom_base_path=(query.get("custom_base_path", "")
                              if _truthy(query.get("use_custom_base_path"))
                              else ""),
            output_root=out_root))

    # the advanced savers answer under "result", as the reference's
    _json_route(routes, "/vrgdg/text_files/save_advanced",
                lambda p: tfl.save_text_advanced(p, out_root))
    _json_route(routes, "/vrgdg/text_files/save_concat",
                lambda p: tfl.save_text_concat(p, out_root))

    @routes.get("/vrgdg/audio/list")
    @_handler
    def audio_list(request):
        return _ok(**tfl.list_audio(out_root))

    @routes.post("/vrgdg/audio/upload")
    @_handler
    async def audio_upload(request):
        filename, data, overwrite = await _audio_part(request, "audio",
                                                      "overwrite")
        return _ok(**await asyncio.get_running_loop().run_in_executor(
            None, tfl.save_audio_upload, filename, data, overwrite,
            out_root))

    @routes.get("/vrgdg/part2/load_concept_prompts")
    @_handler
    def part2_concept_prompts(request):
        return _ok(**tfl.load_shared_concept_prompts(out_root))

    @routes.get("/vrgdg/test_popup/config")
    @_handler
    def popup_config(request):
        return _ok(**tfl.popup_config(out_root))

    _json_route(routes, "/vrgdg/test_popup/save_text",
                lambda p: tfl.popup_save_text(p, out_root), flat=True)

    @routes.post("/vrgdg/test_popup/upload_audio")
    @_handler
    async def popup_upload_audio(request):
        filename, data, _ = await _audio_part(request, "audio")
        return _ok(**await asyncio.get_running_loop().run_in_executor(
            None, tfl.popup_upload_audio, filename, data, out_root))


def _storyboard_routes(routes, ctx: _Context) -> None:
    route = functools.partial(_json_route, routes, flat=True)
    route("/vrgdg/storyboard/load",
          lambda p: {"storyboard": sbd.load_storyboard(p)})
    route("/vrgdg/storyboard/save",
          lambda p: {"storyboard": sbd.save_storyboard(p)})
    route("/vrgdg/storyboard/import_reference_image",
          sbd.import_reference_image)
    route("/vrgdg/storyboard/export_prompts", sbd.export_prompts)


def _remake_next(payload: dict) -> dict:
    """``video_editor/remake/next``: the next staged clip, with its audio
    slice written to ``audio_output`` when asked."""
    p = payload
    result = ved.next_remake(
        p.get("session_path"), p.get("srt_file"),
        p.get("audio_path") or p.get("audio"),
        queue_index=int(p.get("queue_index", 0) or 0),
        fps=int(p.get("fps", 24) or 24),
        tail_loss_frames=(5 if p.get("tail_loss_frames", 5) is None
                          else int(p.get("tail_loss_frames", 5))),
        pre_frames=int(p.get("pre_frames", 0) or 0))
    audio = result.pop("audio", None)
    if audio is not None and p.get("audio_output"):
        from ..runtime import audio_toolkit as at

        result["audio_path"] = at.save_wav(str(p["audio_output"]), audio)
    return result


def _video_editor_routes(routes, ctx: _Context) -> None:
    out_root = ctx.out_root
    roots = (out_root,)
    route = functools.partial(_json_route, routes, flat=True)
    route("/vrgdg/video_editor/list_clips",
          lambda p: ved.list_clips(p.get("folder_path"),
                                   p.get("extensions", ""), roots))
    route("/vrgdg/video_editor/load_session",
          lambda p: {"session": ved.load_session(p.get("folder_path"),
                                                 roots)})
    route("/vrgdg/video_editor/save_session",
          lambda p: ved.save_session(p.get("folder_path"), p.get("session"),
                                     roots))
    route("/vrgdg/video_editor/save_frame",
          lambda p: ved.save_frame(p, roots))
    route("/vrgdg/video_editor/load_clip",
          lambda p: ved.load_clip(p.get("session_path"),
                                  int(p.get("clip_number", 1) or 1),
                                  p.get("clip_path", "")))
    route("/vrgdg/video_editor/remake/next", _remake_next)

    def editor_media(request, allowed):
        path = os.path.normpath(os.path.abspath(
            str(request.query.get("path") or "").strip()))
        # the managed root, or a folder the editor manages (list_clips
        # takes any absolute folder, so the URLs it emits must be served)
        if not paths._inside(out_root, path) \
                and not ved.is_editor_media(path):
            raise FileNotFoundError("Media file was not found.")
        if not os.path.isfile(path):
            raise FileNotFoundError("Media file was not found.")
        if os.path.splitext(path)[1].lower() not in allowed:
            raise ValueError("Unsupported media type.")
        return web.FileResponse(path)

    @routes.get("/vrgdg/video_editor/video")
    @_handler
    def editor_video(request):
        return editor_media(request, set(ved.VIDEO_EXTENSIONS))

    @routes.get("/vrgdg/video_editor/image")
    @_handler
    def editor_image(request):
        return editor_media(request, {".png", ".jpg", ".jpeg", ".webp"})


def _lora_dataset_routes(routes, ctx: _Context) -> None:
    route = functools.partial(_json_route, routes, flat=True)
    route("/vrgdg/lora_dataset/save_pair", lds.save_pair)
    route("/vrgdg/lora_dataset/save_ic_pair", lds.save_ic_pair)
    route("/vrgdg/lora_dataset/list", lds.list_dataset)


def _workflow_runner_routes(routes, ctx: _Context) -> None:
    """The prompt builders for an external ComfyUI-style executor, the
    model root, and the scene-render routes (ffmpeg through
    ``scene_render``'s runner seam)."""
    base = ctx.base_folder

    @routes.get("/vrgdg/workflow_runner/lora_list")
    @_handler
    def wr_lora_list(request):
        return _ok(**workflow_runner.lora_list())

    @routes.get("/vrgdg/workflow_runner/i2v_choices")
    @_handler
    def wr_i2v_choices(request):
        return _ok(**workflow_runner.i2v_choices())

    @routes.get("/vrgdg/workflow_runner/builders")
    @_handler
    def wr_builders(request):
        # one row per build_<key>_prompt route; clear_memory is registered
        # on its own below but is a builder to callers
        return _ok(builders=sorted(
            list(workflow_runner.BUILDERS) + ["clear_memory"]))

    @routes.get("/vrgdg/workflow_runner/model_root")
    @_handler
    def wr_model_root(request):
        result = workflow_runner.load_model_root(base)
        # "registered": whether the root resolves to a folder
        result["registered"] = bool(
            result.get("models_root")
            and os.path.isdir(result["models_root"]))
        return _ok(**result)

    @routes.post("/vrgdg/workflow_runner/model_root")
    @_handler
    async def wr_save_model_root(request):
        payload = await _json(request)
        result = workflow_runner.save_model_root(
            payload.get("models_root", ""), base)
        workflow_runner.set_default_catalog(None)  # re-scan on next use
        return _ok(**result)

    route = functools.partial(_json_route, routes, flat=True)
    for key, build in workflow_runner.BUILDERS.items():
        route(f"/vrgdg/workflow_runner/build_{key}_prompt",
              functools.partial(lambda p, build: build(p, base=base),
                                build=build))

    @routes.post("/vrgdg/workflow_runner/build_clear_memory_prompt")
    @_handler
    def wr_build_clear_memory(request):
        return _ok(**workflow_runner.build_clear_memory_prompt())

    route("/vrgdg/workflow_runner/prepare_scene_audio_clip",
          lambda p: workflow_runner.prepare_scene_audio_clip(p, base=base))

    def scene_route(name, fn):
        @routes.post(f"/vrgdg/workflow_runner/{name}")
        @_handler
        async def handler(request):
            payload = await _json(request)
            try:
                result = await asyncio.get_running_loop().run_in_executor(
                    None, fn, payload)
            except subprocess.CalledProcessError as exc:
                error = exc.stderr or exc.output or str(exc)
                return _err(RuntimeError(f"FFmpeg failed:\n{error}"))
            return _ok(**result)

    for name, fn in (
            ("collect_scene_video", scene_render.collect_scene_video),
            ("match_scene_video_start_color",
             scene_render.match_scene_start_color),
            ("trim_scene_video", scene_render.trim_scene_video),
            ("find_scene_video_output",
             scene_render.find_scene_video_output),
            ("stitch_scene_videos", scene_render.stitch_scene_videos),
            ("render_image_slideshow",
             scene_render.render_image_slideshow)):
        scene_route(name, fn)

    route("/vrgdg/workflow_runner/save_image",
          lambda p: scene_render.save_generated_image(p, base=base))


def _prompt_creator_routes(routes, ctx: _Context) -> None:
    """Prompt-creator drafts and outputs (the builder imports them), its
    instruction store and the hidden Whisper workflow builder."""
    out_root = ctx.out_root

    def route(name, fn):
        _json_route(routes, "/vrgdg/music_prompt_creator/" + name, fn,
                    flat=True)

    route("save_outputs", lambda p: pcr.save_outputs(p, out_root))
    route("save_draft", lambda p: pcr.save_draft(p, out_root))
    route("load_draft", lambda p: pcr.load_draft(p, out_root))

    @routes.get("/vrgdg/music_prompt_creator/list_drafts")
    @_handler
    def pc_list_drafts(request):
        return _ok(**pcr.list_drafts(out_root))

    route("get_instruction", lambda p: pci.get_instruction(p, out_root))
    route("save_instruction", lambda p: pci.save_instruction(p, out_root))
    route("reset_instruction", lambda p: pci.reset_instruction(p, out_root))
    route("list_instruction_presets",
          lambda p: pci.list_presets(p, out_root))
    route("save_instruction_preset", lambda p: pci.save_preset(p, out_root))
    route("load_instruction_preset", lambda p: pci.load_preset(p, out_root))
    route("build_whisper_prompt",
          lambda p: pcr.build_whisper_prompt(p, out_root))

    @routes.get("/vrgdg/music_prompt_creator/config")
    @_handler
    def pc_config(request):
        return _ok(**pcr.config(out_root))

    @routes.post("/vrgdg/music_prompt_creator/import_audio")
    @_handler
    async def pc_import_audio(request):
        reader = await request.multipart()
        project_folder, audio_name, chunks = "", "", []
        async for part in reader:
            if part.name == "project_folder":
                project_folder = (await part.text()).strip()
            elif part.name == "audio":
                audio_name = part.filename or "prompt_creator_audio.wav"
                await _drain_part(part, chunks.append)
                break
        return _ok(**await asyncio.get_running_loop().run_in_executor(
            None, pcr.import_audio, project_folder, audio_name,
            b"".join(chunks), out_root))


def _ssb_save(folder, payload):
    ssb.save_board(folder, payload.get("storyboard") or {})
    return {"storyboard": ssb.load_board(folder)}


def _ssb_save_reference(folder, payload):
    result = ssb.save_reference(folder, payload.get("image_data"),
                                payload.get("scene_number"))
    result["storyboard"] = ssb.load_board(folder)
    return result


def _start_storyboard_routes(routes, ctx: _Context) -> None:
    """The per-scene start/end frame board inside a builder project."""

    def route(name, fn):
        # the folder's check stats the disk, so it runs in the executor
        _json_route(routes, "/vrgdg/start_storyboard/" + name,
                    lambda p: fn(ssb.project_folder(p.get("project_folder")),
                                 p), flat=True)

    route("load", lambda f, p: {"storyboard": ssb.load_board(f)})
    route("reimport", lambda f, p: {"storyboard": ssb.reimport_board(f)})
    route("save", _ssb_save)
    route("import_latest",
          lambda f, p: ssb.import_latest(
              f, p.get("scene_number"), p.get("frame", "start"),
              source_path=p.get("source_path", ""),
              downloads_folder=p.get("downloads_folder")))
    route("import_project_start_frames",
          lambda f, p: ssb.import_project_start_frames(
              f, bool(p.get("overwrite"))))
    route("save_reference", _ssb_save_reference)
    route("save_scene_upload",
          lambda f, p: ssb.save_scene_upload(
              f, p.get("image_data"), p.get("scene_number"),
              p.get("frame", "start")))

    @routes.get("/vrgdg/start_storyboard/image")
    @_handler
    def ssb_image(request):
        folder = ssb.project_folder(request.query.get("project_folder"))
        path = os.path.abspath(str(request.query.get("path") or "").strip())
        if not os.path.isfile(path) or not any(
                paths._inside(root, path) for root in ssb.image_roots(folder)):
            raise FileNotFoundError("Storyboard image was not found.")
        return web.FileResponse(path)


async def _k2s_import(request):
    """The multipart body of a Krea2 import: ``(project_dir, role,
    [(filename, bytes), ...])``."""
    reader = await request.multipart()
    project_dir, role, uploads = "", "", []
    async for part in reader:
        if part.name == "project_dir":
            project_dir = (await part.text()).strip()
        elif part.name == "role":
            role = (await part.text()).strip()
        elif part.filename:
            chunks = []
            await _drain_part(part, chunks.append)
            uploads.append((part.filename, b"".join(chunks)))
    return project_dir, role, uploads


def _krea2_studio_routes(routes, ctx: _Context) -> None:
    """The Krea2 LoRA Studio's project and dataset store, imports,
    samples, XYZ grid, progress parse and run plans."""
    out_root = ctx.out_root

    def route(name, fn):
        _json_route(routes, "/vrgdg/krea2_studio/" + name, fn, flat=True)

    @routes.get("/vrgdg/krea2_studio/defaults")
    @_handler
    def k2s_defaults(request):
        return _ok(**k2s.defaults(output_root=out_root))

    route("create_project", lambda p: k2s.create_project(p, out_root))
    route("load_project", k2s.load_project)
    route("list_projects", lambda p: k2s.list_projects(p, out_root))
    route("save_project", k2s.save_project)
    route("training_progress",
          lambda p: k2s.training_progress(p.get("project_dir", "")))
    route("build_sample_prompt", k2s.build_sample_prompt)
    route("save_sample", lambda p: k2s.save_sample(p, out_root))
    route("create_xyz", k2s.create_xyz)
    route("train_plan", k2s.train_plan)
    route("record_training_result", k2s.record_training_result)

    @routes.post("/vrgdg/krea2_studio/build_clear_memory_prompt")
    @_handler
    async def k2s_clear_memory_prompt(request):
        path, prompt = workflow_runner.load_api_template("clear_memory")
        return _ok(workflow_path=path, prompt=prompt)

    @routes.post("/vrgdg/krea2_studio/import_files")
    @_handler
    async def k2s_import_files(request):
        project_dir, _role, uploads = await _k2s_import(request)
        return _ok(**await asyncio.get_running_loop().run_in_executor(
            None, k2s.import_files, project_dir, uploads))

    @routes.post("/vrgdg/krea2_studio/import_edit_files")
    @_handler
    async def k2s_import_edit_files(request):
        project_dir, role, uploads = await _k2s_import(request)
        return _ok(**await asyncio.get_running_loop().run_in_executor(
            None, k2s.import_edit_files, project_dir, role, uploads))

    @routes.get("/vrgdg/krea2_studio/file")
    @_handler
    def k2s_file(request):
        path = os.path.normpath(os.path.abspath(
            str(request.query.get("path") or "").strip()))
        # only images under the managed root are served
        if not paths._inside(out_root, path) or not os.path.isfile(path) \
                or os.path.splitext(path)[1].lower() not in k2s.IMAGE_EXTS:
            raise FileNotFoundError("Not found")
        return web.FileResponse(path)


def _lyrics_timestamped(payload: dict) -> dict:
    """``lyrics/timestamped``: the timestamped scene payload of an ASR
    word timeline, aligned to reference lyrics when given."""
    segments = lal.segments_from_words(payload.get("segments") or [])
    duration = float(payload.get("duration") or 0.0)
    if duration <= 0:
        duration = max((seg["end"] for seg in segments), default=0.0)
    return lal.timestamped_lyrics(
        segments, duration,
        reference_lyrics=payload.get("reference_lyrics", ""),
        segment_mode=payload.get("segment_mode", "whisper_chunks"),
        include_instrumental_gaps=bool(
            payload.get("include_instrumental_gaps", True)),
        instrumental_text=payload.get("instrumental_text", "[instrumental]"),
        min_gap_seconds=float(payload.get("min_gap_seconds", 1.0)),
        min_scene_seconds=float(payload.get("min_scene_seconds", 1.0)),
        max_scene_seconds=float(payload.get("max_scene_seconds", 8.0)),
        vocal_tail_padding_seconds=float(
            payload.get("vocal_tail_padding_seconds", 0.6)))


def _lyrics_sheet(payload: dict) -> dict:
    """``lyrics/sheet``: the editable ``lyricSegmentN=`` sheet for SRT
    scene windows (or explicit ``windows``)."""
    segments = lal.segments_from_words(payload.get("segments") or [])
    if payload.get("srt_text"):
        windows = lal.srt_windows(payload["srt_text"])
    else:
        windows = [tuple(window) for window in payload.get("windows", [])]
    backup = lal.segments_from_words(payload["backup_segments"]) \
        if payload.get("backup_segments") else None
    out = lal.extract_window_lyrics(
        segments, windows,
        reference_lyrics=payload.get("reference_lyrics", ""),
        backup_segments=backup,
        native_align=bool(payload.get("native_align")),
        strict_reference_text=bool(
            payload.get("strict_reference_text", True)),
        fill_aggressiveness=int(payload.get("fill_aggressiveness", 1)),
        preserve_nonvocal_segments=bool(
            payload.get("preserve_nonvocal_segments", True)),
        alignment_min_words=int(payload.get("alignment_min_words", 2)))
    return {"sheet": out["sheet"], "texts": out["texts"],
            "windows": [list(window) for window in out["windows"]]}


def _lyrics_routes(routes, ctx: _Context) -> None:
    """Timestamped lyric scenes and lyric sheets from external ASR word
    JSON (the ASR run itself stays external): host-only."""
    route = functools.partial(_json_route, routes, flat=True)
    route("/vrgdg/lyrics/timestamped", _lyrics_timestamped)
    route("/vrgdg/lyrics/sheet", _lyrics_sheet)


def _llm_batch_routes(routes, ctx: _Context) -> None:
    """The LLM batch plan/save/combine/split loop and the combined-file
    browser over the managed ``<output>/llm_batches`` root (the LLM run
    itself stays external): host-only.  Save and combine refuse folders
    outside that root."""
    llm_root = os.path.join(ctx.out_root, "llm_batches")

    def contained_batch_folder(folder):
        real = os.path.realpath(str(folder or ""))
        root = os.path.realpath(llm_root)
        if real != root and not real.startswith(root + os.sep):
            raise ValueError(
                "folder must live under the managed llm_batches root")
        return real

    def plan(payload):
        return lbx.plan_batch(
            llm_root, payload.get("story_groups"),
            payload.get("story_summary", ""),
            batch_size=int(payload.get("batch_size", 10)),
            file_prefix=payload.get("file_prefix", "Scene"),
            manual_index=int(payload.get("manual_index", -1)),
            lyric_segments=payload.get("lyric_segments"))

    def save(payload):
        folder = contained_batch_folder(payload.get("folder"))
        return {"path": lbx.save_batch(
            folder, payload.get("file_prefix", "Scene"),
            int(payload["batch_index"]), str(payload.get("text", "")))}

    def combine(payload):
        folder = contained_batch_folder(payload.get("folder"))
        result = lbx.combine_batches(folder,
                                     payload.get("file_prefix", "Scene"))
        return {key: result[key] for key in
                ("combined", "text", "path", "files", "count")}

    route = functools.partial(_json_route, routes, flat=True)
    route("/vrgdg/llm_batches/plan", plan)
    route("/vrgdg/llm_batches/save", save)
    route("/vrgdg/llm_batches/combine", combine)
    route("/vrgdg/llm_batches/split",
          lambda p: lbx.split_prompt_json(p.get("text", ""), folder=None,
                                          index=int(p.get("index", 0))))
    route("/vrgdg/llm_batches/combined_file_update_prompts",
          lambda p: cbf.update_combined_file_prompts(llm_root, p))
    route("/vrgdg/llm_batches/remake_prompt_indexes",
          lambda p: cbf.remake_prompt_state(p.get("folder_path", "")))

    @routes.get("/vrgdg/llm_batches/combined_files")
    @_handler
    def llm_combined_files(request):
        return _ok(**cbf.combined_files_state(
            llm_root, request.query.get("batch_type", ""),
            request.query.get("combined_json_file", "")))

    @routes.get("/vrgdg/llm_batches/combined_file_prompt_values")
    @_handler
    def llm_combined_prompt_values(request):
        return _ok(**cbf.combined_file_prompt_values(
            llm_root, request.query.get("batch_type", ""),
            request.query.get("combined_json_file", "")))


def _text_picker_routes(routes, ctx: _Context) -> None:
    """The cycling text pickers (``runtime/text_pickers``, not
    ``runtime/text_tools``) under ``/vrgdg/text_tools/``: host-only."""
    _json_route(routes, "/vrgdg/text_tools/pick",
                lambda p: tp.pick_text(
                    p.get("index", 0), p.get("items", ""),
                    label=p.get("label", ""),
                    max_items=int(p.get("max_items", 0) or 0),
                    split_mode=p.get("split_mode", "auto"),
                    selection_mode=p.get("selection_mode", "index"),
                    seed=p.get("seed", 0),
                    multi_format=p.get("multi_format", "auto"),
                    two_item_template=p.get("two_item_template",
                                            tp.DEFAULT_TWO_ITEM_TEMPLATE),
                    keep_empty=bool(p.get("keep_empty", False)),
                    pick_count=int(p.get("pick_count", 1) or 1)))
    _json_route(routes, "/vrgdg/text_tools/multi_pick",
                lambda p: tp.run_multi_picker(p.get("pickers") or [],
                                              p.get("joiner", "newline")))


def _graph_routes(routes, ctx: _Context) -> None:
    """The graph-glue plans: a LoRA application plan (applied on the
    device by :func:`vrgdg_tpu_torch.ops.lora.apply_lora_plan`, which
    the caller runs) and a mute/group event plan; host-only."""
    _json_route(routes, "/vrgdg/graph/lora_plan", gp.lora_plan_from_payload)
    _json_route(routes, "/vrgdg/graph/state_plan",
                gp.state_plan_from_payload)


def _status_routes(routes, ctx: _Context) -> None:
    @routes.get("/vrgdg/health")
    @_handler
    def health(request):
        # liveness must not depend on the release-notes file parsing, nor
        # wait on the card: the backend's name was read in create_app
        try:
            notes, _source = load_release_notes()
            latest = latest_release(notes) or {}
        except Exception:  # noqa: BLE001 — degrade, as the JAX server
            notes, latest = {}, {}
        return _ok(version=__version__, backend=ctx.backend,
                   product=notes.get("product"),
                   latest_release={key: latest.get(key)
                                   for key in ("version", "date", "title")}
                   if latest else None)

    @routes.get("/vrgdg/update/status")
    @_handler
    def update_status(request):
        notes, source = load_release_notes()
        return _ok(version=__version__, release_notes=notes,
                   release_notes_source=source)

    @routes.get("/vrgdg/node_canvas/status")
    @_handler
    def node_canvas_status(request):
        return _ok(name="VRGDG Node Canvas Prototype", version=1,
                   builder_connected=False)


def _ui_routes(routes, ctx: _Context) -> None:
    @routes.get("/vrgdg/ui")
    @_handler
    def ui_index(request):
        return web.FileResponse(PANEL_PATH)

    @routes.get("/")
    async def root_redirect(request):
        raise web.HTTPFound("/vrgdg/ui")


_ROUTE_GROUPS = (_enhancer_routes, _lut_grain_adjust_routes, _audio_routes,
                 _compare_routes, _face_fix_routes, _builder_routes,
                 _text_file_routes, _storyboard_routes, _video_editor_routes,
                 _lora_dataset_routes, _status_routes, _ui_routes,
                 _workflow_runner_routes, _prompt_creator_routes,
                 _start_storyboard_routes, _krea2_studio_routes,
                 _lyrics_routes, _llm_batch_routes, _text_picker_routes,
                 _graph_routes)


def create_app(base_folder: str | None = None, luts_dir: str | None = None,
               device="cuda") -> web.Application:
    """The aiohttp app on ``device`` (resolved here: ``cuda`` without a
    card raises ``RuntimeError``); the device's name is read once, so
    ``/vrgdg/health`` never waits on the card."""
    device = appliers.resolve_device(device)
    ctx = _Context(base_folder, luts_dir, device, appliers.device_name(device))
    app = web.Application(client_max_size=1024 ** 3,
                          middlewares=[_mutation_guard])
    routes = web.RouteTableDef()
    for register in _ROUTE_GROUPS:
        register(routes, ctx)
    app.add_routes(routes)
    return app


def main(host: str = "127.0.0.1", port: int = 8431,
         base_folder: str | None = None, luts_dir: str | None = None,
         device="cuda") -> None:
    web.run_app(create_app(base_folder, luts_dir, device), host=host,
                port=port)


if __name__ == "__main__":
    main()
