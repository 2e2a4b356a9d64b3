"""Command-line interface of the PyTorch/CUDA port.

Subcommands (the same flags as ``vrgdg_tpu.cli``, plus ``--device``):
  probe    — video metadata
  grade    — the fused full stack (LUT + adjust + color match + sharpen +
             grain); ``--fused-mode fused`` runs the two CUDA kernels
  lut      — 3D .cube LUT on a video or image
  grain    — seeded film grain on a video
  adjust   — 13-slider adjust stack on a video or image
  enhance  — the Standalone Video Enhancer job (segmented, resumable);
             ``--shard-index``/``--shard-count`` render a share of its
             segments into a job folder shared by several processes
  face-fix — the distant-face repair job engine (estimate, prepare,
             accept-crop, accept-anchor, inputs, accept-ltx, finalize;
             finalize composites on the device)
  face-repair — targeted far-face repair (prepare, composite,
             contact-sheet, rebuild-video; the lanczos4 resizes run on the
             device)
  compare  — A/B comparison renders (side_by_side/slider/overlay/
             difference/blink) of two images or two videos
  luts     — list bundled LUTs
  make-lut — synthesize a palette .cube file
  beats    — beat & impact analysis -> beat_data JSON (host numpy)
  scene-srt — beat-aligned scene durations -> SRT (host)
  audio    — waveform toolkit: split, srt-split, delay, peaks (host)
  builder  — music video builder project store: new, list, load, save,
             delete, export, import, scan, analyze, mix (host)
  lyrics   — timestamped lyric scenes or a lyric sheet from external ASR
             word JSON (host)
  llm-batch — LLM batch-run loop: plan, save, combine, split (host)
  humo     — HuMo set pipeline: plan, split-set, chunk, final, grid (host)
  workflow — workflow-runner prompt builders: build, list, lora-list,
             choices (host; executor-ready JSON)
  graph    — graph-glue plans: lora-plan, state-plan (host; a LoRA plan
             is applied by ``ops.lora.apply_lora_plan``)
  serve    — the HTTP API server (``vrgdg_tpu_torch.server``) on the device

``--device`` defaults to ``cuda``; on a machine without a card the command
stops with an error unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time


def _print(result):
    try:
        print(json.dumps(result, indent=2, default=str))
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        raise SystemExit(0)


def _is_image(path: str) -> bool:
    from .api.paths import SUPPORTED_IMAGE_EXTENSIONS

    return os.path.splitext(path)[1].lower() in SUPPORTED_IMAGE_EXTENSIONS


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")


def _add_video_common(p):
    p.add_argument("input")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--crf", type=int, default=23)
    p.add_argument("--preset", default="medium")
    _add_device(p)


def _enhance(args, device) -> None:
    """Start (or resume) an enhancer job, poll it to its end, print its
    final status; exit 1 unless it completed.  With ``--shard-index``,
    render this rank's segments of the shared job and print its summary
    (rank 0: the finished job's status)."""
    if args.distributed:
        from .parallel import initialize_distributed
        initialize_distributed()
    from .jobs import enhancer as enh

    payload = {"source_path": args.input,
               "settings": json.loads(args.settings)}
    if args.shard_index is not None:
        _print(enh.render_job_shards(
            args.job_id, payload, args.shard_index, args.shard_count,
            base_folder=args.output_root,
            wait_timeout=args.shard_stall_timeout, device=device))
        return
    snap = enh.start_render(payload, args.resume,
                            base_folder=args.output_root, device=device)
    job_id = snap["job_id"]
    while True:
        snap = enh.JOBS.snapshot(job_id)
        status = snap.get("status")
        sys.stderr.write(
            f"\r[{status}] {snap.get('progress', 0) * 100:5.1f}% "
            f"{snap.get('message', '')[:60]:<60}")
        sys.stderr.flush()
        if status in {"complete", "failed", "canceled"}:
            sys.stderr.write("\n")
            break
        time.sleep(0.5)
    _print(snap)
    if status != "complete":
        sys.exit(1)


def _face_fix(args, device) -> None:
    from .jobs import face_fix as ff

    payload = json.loads(args.payload)
    if args.video:
        payload.setdefault("video_path", args.video)
    if args.manifest:
        payload.setdefault("manifest_path", args.manifest)
    if args.whole_scene:
        payload.setdefault("whole_scene", True)
    actions = {
        "estimate": ff.estimate_anchors,
        "prepare": ff.prepare_face_fix,
        "accept-crop": ff.accept_enhanced_crop,
        "accept-anchor": ff.accept_enhanced_anchor,
        "inputs": ff.build_ltx_inputs,
        "accept-ltx": ff.accept_ltx_frames,
        "finalize": lambda p: ff.finalize_face_fix(p, device=device),
    }
    _print(actions[args.action](payload))


def _face_repair(args, device) -> None:
    from .jobs import face_repair as fr

    if args.action == "prepare":
        _print(fr.prepare(
            args.video, args.ranges, args.out,
            detector=args.detector, face_choice=args.face_choice,
            manual_box=args.manual_box,
            min_confidence=args.min_confidence,
            padding=args.padding, feather=args.feather,
            overwrite=args.overwrite))
    elif args.action == "composite":
        _print(fr.composite(
            args.manifest, repaired_dir=args.repaired_dir,
            out_dir=args.out, feather=args.feather,
            color_match=args.color_match, device=device))
    elif args.action == "contact-sheet":
        _print(fr.contact_sheet(
            args.manifest, repaired_dir=args.repaired_dir,
            out_path=args.out, limit=args.limit,
            columns=args.columns, thumb_width=args.thumb_width,
            device=device))
    else:
        _print(fr.rebuild_video(
            args.manifest, args.out, fixed_dir=args.fixed_dir,
            only_ranges=args.only_ranges, device=device))


def _beats(args) -> None:
    from .runtime import audio_toolkit as at
    from .runtime import beats as beats_rt

    stems = {name: at.load_audio(path) if path else None
             for name, path in (("drums", args.drums), ("bass", args.bass),
                                ("vocals", args.vocals),
                                ("other", args.other))}
    data = beats_rt.analyze_beats(at.load_audio(args.mix), **stems)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w", encoding="utf-8") as handle:
            json.dump(data, handle)
        data = {**data, "beats": f"({len(data['beats'])} beats)",
                "output": args.output}
    _print(data)


def _scene_srt(args) -> None:
    from .runtime import beats as beats_rt

    with open(args.beat_data, "r", encoding="utf-8") as handle:
        beat_data = json.load(handle)
    result = beats_rt.generate_scene_srt(
        beat_data, args.min_duration, args.max_duration, args.bias,
        args.duration_preset, args.seed, output_path=args.output or None)
    if args.output:
        result = {k: v for k, v in result.items() if k != "srt_text"}
    _print(result)


def _audio(args) -> None:
    from .runtime import audio_toolkit as at

    if args.action == "peaks":
        # peaks decodes internally: no second full decode here
        from .runtime import audio as audio_rt
        _print(audio_rt.read_audio_peaks(args.input, args.target_peaks))
        return
    audio = at.load_audio(args.input)
    if args.action == "split":
        durations = [float(v) for v in args.durations.split(",") if v]
        result = at.split_audio_by_durations(
            audio, durations, args.offset, pad_to_chunk=args.pad_to_chunk)
        out_dir = args.output or os.path.dirname(os.path.abspath(args.input))
        paths = [at.save_wav(os.path.join(out_dir, f"segment_{i:04d}.wav"),
                             seg)
                 for i, seg in enumerate(result["segments"])]
        _print({**result["meta"], "outputs": paths,
                "total_duration": result["total_duration"]})
    elif args.action == "srt-split":
        result = at.split_audio_srt(
            audio, args.chunk_index, srt_source=args.srt or None,
            fixed_duration=args.fixed_duration, fps=args.fps,
            tail_loss_frames=args.tail_loss_frames,
            pre_frames=args.pre_frames)
        segment = result.pop("audio")
        if args.output:
            result["output"] = at.save_wav(args.output, segment)
        _print(result)
    else:
        delayed = at.delay_audio_by_index(audio, args.chunk_index,
                                          args.delay_ms)
        out = args.output or os.path.splitext(args.input)[0] + "_delayed.wav"
        _print({"output": at.save_wav(out, delayed),
                "chunk_index": args.chunk_index, "delay_ms": args.delay_ms,
                "samples": int(delayed["waveform"].shape[-1])})


def _builder(args) -> None:
    from .api import builder as mvb
    root = args.output_root or None

    def _read_json_arg(path, label):
        if not path:
            raise SystemExit(f"--session with a {label} JSON file "
                             "is required for this action")
        with open(path, "r", encoding="utf-8-sig") as handle:
            return json.load(handle)

    if args.action == "new":
        payload = {"project_name": args.name or args.target}
        if os.path.isabs(args.target):
            payload["project_folder"] = args.target
        _print(mvb.new_project(payload, root))
    elif args.action == "list":
        _print(mvb.list_projects(root))
    elif args.action == "load":
        _print(mvb.load_session(args.target))
    elif args.action == "save":
        if args.session:
            session = _read_json_arg(args.session, "session")
        else:
            # no --session: keep the existing timeline instead of
            # overwriting it with an empty one (e.g. when only attaching
            # audio)
            try:
                session = mvb.load_session(args.target)["session"]
            except (FileNotFoundError, ValueError):
                session = {"segments": []}
        _print(mvb.save_session(
            {"project_folder": args.target, "project_name": args.name,
             "audio_path": args.audio, "session": session}, root))
    elif args.action == "delete":
        _print(mvb.delete_project({"project_folder": args.target}, root))
    elif args.action == "export":
        zip_path, download_name = mvb.export_project(args.target)
        destination = args.output or download_name
        shutil.move(zip_path, destination)
        _print({"zip_path": os.path.abspath(destination),
                "download_name": download_name})
    elif args.action == "import":
        _print(mvb.import_project(args.target, args.name, root))
    elif args.action == "scan":
        _print(mvb.scan_scene_videos(args.target))
    elif args.action == "analyze":
        _print(mvb.analyze_audio({"audio_path": args.target}, root))
    elif args.action == "mix":
        segments = _read_json_arg(args.session, "segments")
        _print(mvb.mix_scene_audio(
            {"project_folder": args.target, "segments": segments,
             "allow_missing_scene_audio": True}))


def _lyrics(args) -> None:
    from .runtime import lyric_align as lal

    with open(args.input, "r", encoding="utf-8-sig") as handle:
        raw = json.load(handle)
    raw_segments = raw["segments"] if isinstance(raw, dict) else raw
    segments = lal.segments_from_words(raw_segments)
    duration = args.duration
    if duration <= 0 and isinstance(raw, dict):
        duration = float(raw.get("duration", 0.0) or 0.0)
    if duration <= 0:
        duration = max((seg["end"] for seg in segments), default=0.0)
    reference_text = ""
    if args.reference:
        with open(args.reference, "r", encoding="utf-8-sig") as handle:
            reference_text = handle.read()
    if args.sheet_srt:
        with open(args.sheet_srt, "r", encoding="utf-8-sig") as handle:
            windows = lal.srt_windows(handle.read())
        backup = None
        if args.backup:
            with open(args.backup, "r", encoding="utf-8-sig") as handle:
                backup_raw = json.load(handle)
            backup = lal.segments_from_words(
                backup_raw["segments"] if isinstance(backup_raw, dict)
                else backup_raw)
        sheet = lal.extract_window_lyrics(
            segments, windows, reference_lyrics=reference_text,
            backup_segments=backup, native_align=args.native_align)["sheet"]
        if args.output:
            with open(args.output, "w", encoding="utf-8") as handle:
                handle.write(sheet)
            _print({"output": os.path.abspath(args.output)})
        else:
            print(sheet)
        return
    payload = lal.timestamped_lyrics(
        segments, duration, reference_lyrics=reference_text,
        segment_mode=args.segment_mode,
        include_instrumental_gaps=not args.no_instrumental_gaps,
        instrumental_text=args.instrumental_text,
        min_gap_seconds=args.min_gap, min_scene_seconds=args.min_scene,
        max_scene_seconds=args.max_scene,
        vocal_tail_padding_seconds=args.vocal_tail)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as handle:
            json.dump(payload, handle, ensure_ascii=False, indent=2)
        _print({"output": os.path.abspath(args.output),
                "segment_count": payload["segment_count"],
                "duration": payload["duration"]})
    else:
        _print(payload)


def _llm_batch(args) -> None:
    from .runtime import llm_batches as lbx

    def read_text(path):
        if path == "-":
            return sys.stdin.read()
        with open(path, "r", encoding="utf-8-sig") as handle:
            return handle.read()

    def read_json(path):
        return json.loads(read_text(path)) if path else None

    if args.action == "plan":
        if not args.groups:
            raise SystemExit("--groups JSON file is required")
        _print(lbx.plan_batch(
            args.target, read_json(args.groups), args.summary,
            batch_size=args.batch_size, file_prefix=args.prefix,
            manual_index=args.index, lyric_segments=read_json(args.lyrics)))
    elif args.action == "save":
        if args.index < 0 or not args.text:
            raise SystemExit("save needs --index and --text")
        _print({"path": lbx.save_batch(args.target, args.prefix, args.index,
                                       read_text(args.text))})
    elif args.action == "combine":
        result = lbx.combine_batches(args.target, args.prefix)
        _print({key: result[key] for key in ("path", "files", "count")})
    elif args.action == "split":
        _print(lbx.split_prompt_json(read_text(args.target),
                                     folder=args.folder or None,
                                     index=max(args.index, 0)))


def _humo(args) -> None:
    from .runtime import audio_toolkit as atk
    from .runtime import video_io as vio

    if args.action == "plan":
        audio = atk.load_audio(args.target)
        _print(atk.calculate_wan22_sets(
            audio, index=args.index,
            scene_duration_seconds=args.scene_duration))
    elif args.action == "split-set":
        audio = atk.load_audio(args.target)
        result = atk.split_audio_humo_set(audio, set_index=args.index)
        out_dir = args.output or os.path.join(
            os.path.dirname(os.path.abspath(args.target)),
            f"humo_set_{args.index:03d}")
        os.makedirs(out_dir, exist_ok=True)
        paths = [atk.save_wav(os.path.join(out_dir, f"audio_{pos + 1}.wav"),
                              seg)
                 for pos, seg in enumerate(result["segments"])]
        with open(os.path.join(out_dir, "meta.json"), "w",
                  encoding="utf-8") as handle:
            json.dump(result["meta"], handle, indent=2)
        _print({"folder": out_dir, "segments": paths,
                "total_duration": result["total_duration"]})
    elif args.action == "chunk":
        audio = atk.load_audio(args.target)
        durations = atk.parse_duration_list(args.durations) \
            if args.durations else None
        result = atk.split_general_chunk(
            audio, chunk_index=args.index,
            scene_duration_seconds=args.scene_duration, fps=args.fps,
            use_humo_alignment=args.humo_align, durations=durations)
        out_dir = args.output or os.path.dirname(os.path.abspath(args.target))
        os.makedirs(out_dir, exist_ok=True)
        wav = atk.save_wav(os.path.join(out_dir,
                                        f"chunk_{args.index:04d}.wav"),
                           result.pop("audio"))
        _print({"wav": wav, **{key: result[key] for key in
                               ("chunk_index", "total_sets",
                                "frames_per_scene", "frames_for_ltx",
                                "preroll_frames", "start_time",
                                "end_time")}})
    elif args.action == "final":
        audio = atk.load_audio(args.audio) if args.audio else None
        _print(vio.assemble_final_video(args.target, audio=audio,
                                        threshold=args.threshold,
                                        redo=args.redo))
    elif args.action == "grid":
        if os.path.isdir(args.target):
            sources = vio.find_grid_videos(args.target)
        else:
            sources = [part for part in args.target.split(",")
                       if part.strip()]
        labels = [part.strip() for part in args.labels.split(",")] \
            if args.labels else None
        frames = vio.render_video_grid(sources, labels=labels)
        out_path = args.output or os.path.join(
            args.target if os.path.isdir(args.target) else ".",
            "video_grid.mp4")
        writer = vio.VideoWriter(out_path, args.grid_fps, frames.shape[2],
                                 frames.shape[1])
        try:
            for frame in vio.array_to_frames(frames):
                writer.write_bgr(frame)
        finally:
            writer.close()
        _print({"output": os.path.abspath(out_path),
                "frames": int(frames.shape[0]), "tiles": len(sources)})


def _workflow(args, parser) -> None:
    from .api import workflow_runner as wr

    catalog = (wr.ModelCatalog(root=args.models_root)
               if args.models_root else None)
    if args.action == "list":
        result = {"builders": sorted(wr.BUILDERS) + ["clear_memory"],
                  "templates": dict(wr.TEMPLATES)}
    elif args.action == "lora-list":
        result = wr.lora_list(catalog)
    elif args.action == "choices":
        result = wr.i2v_choices(catalog)
    elif args.builder == "clear_memory":
        result = wr.build_clear_memory_prompt()
    else:
        if args.builder not in wr.BUILDERS:
            parser.error(f"unknown builder {args.builder!r}; "
                         "see 'workflow list'")
        text = args.payload
        if text.startswith("@"):
            with open(text[1:], encoding="utf-8") as handle:
                text = handle.read()
        payload = json.loads(text) if text else {}
        result = wr.BUILDERS[args.builder](payload, catalog=catalog)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as handle:
            json.dump(result, handle, indent=2, default=str)
        _print({"output": os.path.abspath(args.output),
                "builder": args.builder or args.action})
    else:
        _print(result)


def _graph(args) -> None:
    from .runtime import graph_plans as gp

    text = args.payload
    if text.startswith("@"):
        with open(text[1:], encoding="utf-8") as handle:
            text = handle.read()
    payload = json.loads(text) if text else {}
    dispatch = (gp.lora_plan_from_payload if args.action == "lora-plan"
                else gp.state_plan_from_payload)
    result = dispatch(payload)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as handle:
            json.dump(result, handle, indent=2, default=str)
        _print({"output": os.path.abspath(args.output),
                "action": args.action})
    else:
        _print(result)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="vrgdg-tpu-torch",
        description="video post-processing on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("grain", help="apply seeded film grain")
    _add_video_common(p)
    p.add_argument("--intensity", type=float, default=0.04)
    p.add_argument("--saturation-mix", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser("lut", help="apply a .cube LUT")
    _add_video_common(p)
    p.add_argument("lut_name")
    p.add_argument("--strength", type=float, default=10.0)
    p.add_argument("--luts-dir", default=None)

    p = sub.add_parser("adjust", help="apply the 13-slider adjust stack")
    _add_video_common(p)
    p.add_argument("--settings", default="{}",
                   help='JSON, e.g. \'{"contrast": 20, "saturation": 10}\'')

    p = sub.add_parser("grade", help="fused full-stack grade")
    _add_video_common(p)
    p.add_argument("--lut", default=None)
    p.add_argument("--lut-strength", type=float, default=10.0)
    p.add_argument("--adjust", default=None, help="JSON settings")
    p.add_argument("--reference", default=None,
                   help="reference image for color match")
    p.add_argument("--match-strength", type=float, default=1.0)
    p.add_argument("--sharpen", type=float, default=0.0)
    p.add_argument("--grain", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--luts-dir", default=None)
    p.add_argument("--fused-mode", default="eager",
                   choices=["eager", "fused"],
                   help="fused = the two CUDA kernels (needs LUT + color "
                        "match + unsharp enabled)")

    p = sub.add_parser("enhance", help="segmented resumable enhancer job")
    p.add_argument("input")
    p.add_argument("--settings", default="{}", help="JSON enhancer settings")
    p.add_argument("--resume", default="", help="job id to resume")
    p.add_argument("--output-root", default=None)
    p.add_argument("--distributed", action="store_true",
                   help="initialize torch.distributed first (see "
                        "vrgdg_tpu_torch.parallel.distributed for the env "
                        "contract)")
    p.add_argument("--shard-index", type=int, default=None,
                   help="segment-scheduler rank: render segments "
                        "shard_index::shard_count into the shared job "
                        "folder; rank 0 finalizes (run one process per "
                        "rank with identical settings)")
    p.add_argument("--shard-count", type=int, default=1)
    p.add_argument("--job-id", default="shards",
                   help="shared job id for --shard-index runs")
    p.add_argument("--shard-stall-timeout", type=float, default=900.0,
                   help="rank 0 aborts if no new segment commits for "
                        "this many seconds (progress restarts the "
                        "clock; re-run to resume)")
    _add_device(p)

    p = sub.add_parser("face-fix", help="distant-face repair job engine")
    p.add_argument("action",
                   choices=["estimate", "prepare", "accept-crop",
                            "accept-anchor", "inputs", "accept-ltx",
                            "finalize"])
    p.add_argument("--payload", default="{}",
                   help="JSON payload (fields per "
                        "vrgdg_tpu_torch.jobs.face_fix)")
    p.add_argument("--video", default=None, help="shortcut: video_path")
    p.add_argument("--manifest", default=None, help="shortcut: manifest_path")
    p.add_argument("--whole-scene", action="store_true")
    _add_device(p)

    p = sub.add_parser(
        "face-repair",
        help="targeted far-face repair: prepare/composite/sheet/rebuild")
    p.add_argument("action", choices=["prepare", "composite",
                                      "contact-sheet", "rebuild-video"])
    p.add_argument("--video", default="", help="prepare: source video")
    p.add_argument("--ranges", default="",
                   help="prepare: frame ranges, e.g. 120-160,300-318")
    p.add_argument("--out", default="", help="output folder / file")
    p.add_argument("--manifest", default="",
                   help="composite/sheet/rebuild: manifest.json path")
    p.add_argument("--detector", default="auto",
                   choices=["auto", "opencv"])
    p.add_argument("--face-choice", default="largest",
                   choices=["largest", "center"])
    p.add_argument("--manual-box", default="",
                   help="forced face box: x,y,w,h or x1,y1,x2,y2")
    p.add_argument("--min-confidence", type=float, default=0.35)
    p.add_argument("--padding", type=float, default=2.35)
    p.add_argument("--feather", type=int, default=18,
                   help="composite: -1 keeps the saved masks")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--repaired-dir", default="")
    p.add_argument("--color-match", action="store_true")
    p.add_argument("--limit", type=int, default=24)
    p.add_argument("--columns", type=int, default=3)
    p.add_argument("--thumb-width", type=int, default=900)
    p.add_argument("--fixed-dir", default="")
    p.add_argument("--only-ranges", action="store_true")
    _add_device(p)

    p = sub.add_parser("compare", help="render an A/B comparison")
    p.add_argument("input_a")
    p.add_argument("input_b")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--mode", default="slider",
                   choices=["side_by_side", "slider", "overlay",
                            "difference", "blink"])
    p.add_argument("--slider-position", type=float, default=0.5)
    p.add_argument("--overlay-opacity", type=float, default=0.5)
    p.add_argument("--difference-gain", type=float, default=1.0)
    p.add_argument("--blink-speed", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=8)
    _add_device(p)

    sub.add_parser("luts", help="list bundled LUTs")

    p = sub.add_parser("make-lut", help="synthesize a palette LUT")
    p.add_argument("colors", help='comma list, e.g. "#0b1d51, #f3d27a"')
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--size", type=int, default=33)

    p = sub.add_parser("probe", help="video metadata")
    p.add_argument("input")

    p = sub.add_parser("beats",
                       help="beat & impact analysis -> beat_data JSON")
    p.add_argument("mix", help="final mix audio file")
    p.add_argument("--drums", default=None)
    p.add_argument("--bass", default=None)
    p.add_argument("--vocals", default=None)
    p.add_argument("--other", default=None)
    p.add_argument("-o", "--output", default="",
                   help="write beat_data JSON here")

    p = sub.add_parser("scene-srt",
                       help="beat-aligned scene durations -> SRT")
    p.add_argument("beat_data", help="beat_data JSON file (from `beats`)")
    p.add_argument("-o", "--output", default="", help="SRT output path")
    p.add_argument("--min-duration", type=float, default=2.0)
    p.add_argument("--max-duration", type=float, default=10.0)
    p.add_argument("--bias", type=float, default=0.7)
    p.add_argument("--duration-preset", default="impact_weighted",
                   choices=["impact_weighted", "varied_no_repeat",
                            "clustered_no_repeat"])
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("audio", help="waveform toolkit")
    p.add_argument("action", choices=["split", "srt-split", "delay",
                                      "peaks"])
    p.add_argument("input", help="audio file")
    p.add_argument("-o", "--output", default="",
                   help="output WAV (delay) / directory (splits)")
    p.add_argument("--durations", default="",
                   help='comma list of scene seconds, e.g. "2,3.5,4"')
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--pad-to-chunk", action="store_true",
                   help="InfiniteTalk mode: pad every segment to 8 s")
    p.add_argument("--srt", default="", help="SRT file for srt-split")
    p.add_argument("--fixed-duration", type=float, default=0.0)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--chunk-index", type=int, default=0)
    p.add_argument("--tail-loss-frames", type=int, default=5)
    p.add_argument("--pre-frames", type=int, default=0)
    p.add_argument("--delay-ms", type=float, default=40.0)
    p.add_argument("--target-peaks", type=int, default=600)

    p = sub.add_parser("builder", help="music video builder project store")
    p.add_argument("action", choices=["new", "list", "load", "save",
                                      "delete", "export", "import", "scan",
                                      "analyze", "mix"])
    p.add_argument("target", nargs="?", default="",
                   help="project folder (most actions), ZIP path "
                        "(import), or audio path (analyze)")
    p.add_argument("--name", default="", help="project name (new / import)")
    p.add_argument("--session", default="",
                   help="JSON file with the session dict (save) or the "
                        "scene segments list (mix)")
    p.add_argument("--audio", default="", help="project audio path (save)")
    p.add_argument("-o", "--output", default="",
                   help="destination ZIP path (export)")
    p.add_argument("--output-root", default="",
                   help="managed projects root (defaults to "
                        "VRGDG_TPU_OUTPUT)")

    p = sub.add_parser(
        "lyrics", help="timestamped lyric scenes from external ASR word JSON")
    p.add_argument("input",
                   help="word-timestamped ASR segments JSON "
                        "(see docs/MIGRATION.md contract #3)")
    p.add_argument("--reference", default="",
                   help="reference lyrics text file")
    p.add_argument("--segment-mode", default="whisper_chunks",
                   choices=["whisper_chunks", "reference_lines",
                            "exact_reference_lines", "reference_stanzas",
                            "reference_scene_words"])
    p.add_argument("--no-instrumental-gaps", action="store_true")
    p.add_argument("--instrumental-text", default="[instrumental]")
    p.add_argument("--min-gap", type=float, default=1.0)
    p.add_argument("--min-scene", type=float, default=1.0)
    p.add_argument("--max-scene", type=float, default=8.0)
    p.add_argument("--vocal-tail", type=float, default=0.6)
    p.add_argument("--duration", type=float, default=0.0,
                   help="total audio seconds (default: from the JSON or the "
                        "last word end)")
    p.add_argument("-o", "--output", default="",
                   help="write the payload JSON here (default stdout)")
    p.add_argument("--sheet-srt", default="",
                   help="emit the editable lyricSegmentN= sheet for this "
                        "SRT's scene windows instead of the timestamped "
                        "payload")
    p.add_argument("--backup", default="",
                   help="plain-transcription ASR JSON for sheet backup fill "
                        "(optional)")
    p.add_argument("--native-align", action="store_true",
                   help="mark the input as forced-alignment output (enables "
                        "the sheet's cleanup/reassignment branch)")

    p = sub.add_parser("llm-batch",
                       help="LLM batch-run pipeline (plan/save/combine/split)")
    p.add_argument("action", choices=["plan", "save", "combine", "split"])
    p.add_argument("target",
                   help="batch root (plan) / run folder (save, combine) / "
                        "LLM output text file or '-' for stdin (split)")
    p.add_argument("--groups", default="",
                   help="story groups JSON file (plan)")
    p.add_argument("--lyrics", default="",
                   help="lyric segments JSON file (plan)")
    p.add_argument("--summary", default="", help="story summary text (plan)")
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--prefix", default="Scene", help="batch file prefix")
    p.add_argument("--index", type=int, default=-1,
                   help="manual batch index (plan) / batch index (save, "
                        "required) / run index (split)")
    p.add_argument("--text", default="",
                   help="LLM reply text file or '-' for stdin (save)")
    p.add_argument("--folder", default="",
                   help="persist folder for split outputs")

    p = sub.add_parser("humo", help="HuMo set pipeline (plan/split/final/grid)")
    p.add_argument("action", choices=["plan", "split-set", "chunk", "final",
                                      "grid"])
    p.add_argument("target",
                   help="audio file (plan, split-set, chunk) / set folder "
                        "(final) / video folder (grid)")
    p.add_argument("--index", type=int, default=0,
                   help="set or chunk index")
    p.add_argument("--scene-duration", type=float, default=4.0)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--humo-align", action="store_true",
                   help="4N+1 frame quantization (requires fps 25)")
    p.add_argument("--durations", default="",
                   help='custom scene durations, e.g. "2,3.5,4" (chunk)')
    p.add_argument("--threshold", type=int, default=3,
                   help="set finals required before assembly (final)")
    p.add_argument("--audio", default="",
                   help="original mix to lay under the final video")
    p.add_argument("--redo", action="store_true",
                   help="rerun mode: bypass the threshold, write "
                        "FINAL_VIDEO_REDO (final)")
    p.add_argument("--labels", default="",
                   help="comma-separated tile labels (grid)")
    p.add_argument("--grid-fps", type=float, default=24.0)
    p.add_argument("-o", "--output", default="",
                   help="output folder (split-set, chunk) / video path "
                        "(grid)")

    p = sub.add_parser(
        "workflow",
        help="workflow-runner prompt builders (executor-ready JSON)")
    p.add_argument("action", choices=["build", "list", "lora-list",
                                      "choices"])
    p.add_argument("builder", nargs="?", default="",
                   help="builder key for 'build' (see 'workflow list')")
    p.add_argument("--payload", default="",
                   help="JSON payload text or @file path")
    p.add_argument("--models-root", default=None,
                   help="model catalog root (else VRGDG_TPU_MODELS / "
                        "persisted model_root)")
    p.add_argument("-o", "--output", default="",
                   help="write the result JSON here instead of stdout")

    p = sub.add_parser(
        "graph", help="graph-glue plans (LoRA application / mute-group events)")
    p.add_argument("action", choices=["lora-plan", "state-plan"])
    p.add_argument("--payload", default="",
                   help="JSON payload text or @file path (same schema as "
                        "POST /vrgdg/graph/*)")
    p.add_argument("-o", "--output", default="",
                   help="write the plan JSON here instead of stdout")

    p = sub.add_parser("serve", help="run the HTTP API server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8431)
    p.add_argument("--distributed", action="store_true",
                   help="initialize torch.distributed first (see "
                        "vrgdg_tpu_torch.parallel.distributed for the env "
                        "contract)")
    _add_device(p)

    args = parser.parse_args(argv)

    if args.command == "probe":
        from .runtime import video_io
        _print(video_io.probe_video(args.input))
        return
    if args.command == "luts":
        from .api import paths
        _print(paths.list_luts())
        return
    if args.command == "make-lut":
        from .core.cube import build_palette_lut, write_cube
        lut = build_palette_lut(args.colors, args.size)
        path = write_cube(lut, args.output)
        _print({"output": path, "size": args.size, "colors": args.colors})
        return
    host_commands = {"beats": _beats, "scene-srt": _scene_srt,
                     "audio": _audio, "builder": _builder, "humo": _humo,
                     "lyrics": _lyrics, "llm-batch": _llm_batch,
                     "graph": _graph}
    if args.command in host_commands:
        host_commands[args.command](args)
        return
    if args.command == "workflow":
        _workflow(args, parser)
        return

    from .api import appliers
    try:
        device = appliers.resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))
    if args.command == "serve":
        if args.distributed:
            from .parallel import initialize_distributed
            initialize_distributed()
        from .server import main as serve_main
        serve_main(host=args.host, port=args.port, device=device)
        return
    if args.command == "enhance":
        _enhance(args, device)
        return
    if args.command == "face-fix":
        _face_fix(args, device)
        return
    if args.command == "face-repair":
        _face_repair(args, device)
        return
    if args.command == "compare":
        from .api import compare
        options = dict(slider_position=args.slider_position,
                       overlay_opacity=args.overlay_opacity,
                       difference_gain=args.difference_gain, device=device)
        if _is_image(args.input_a):
            _print(compare.compare_images(args.input_a, args.input_b,
                                          args.mode, args.output, **options))
        else:
            _print(compare.compare_videos(
                args.input_a, args.input_b, args.mode, args.output,
                blink_speed=args.blink_speed, batch_size=args.batch_size,
                **options))
        return
    common = dict(batch_size=args.batch_size,
                  preserve_audio=not args.no_audio, encode_crf=args.crf,
                  encode_preset=args.preset, device=device)
    if args.command == "grain":
        _print(appliers.apply_film_grain_to_video(
            args.input, args.output, args.intensity, args.saturation_mix,
            args.seed, **common))
    elif args.command == "lut" and _is_image(args.input):
        _print(appliers.apply_lut_to_image(
            args.input, args.lut_name, args.output, args.strength,
            luts_dir=args.luts_dir, device=device))
    elif args.command == "lut":
        _print(appliers.apply_lut_to_video(
            args.input, args.lut_name, args.output, args.strength,
            luts_dir=args.luts_dir, **common))
    elif args.command == "adjust" and _is_image(args.input):
        _print(appliers.apply_adjust_to_image(
            args.input, args.output, json.loads(args.settings),
            device=device))
    elif args.command == "adjust":
        _print(appliers.apply_adjust_to_video(
            args.input, args.output, json.loads(args.settings), **common))
    elif args.command == "grade":
        _print(appliers.grade_video(
            args.input, args.output, lut_name=args.lut,
            lut_strength=args.lut_strength,
            adjust=json.loads(args.adjust) if args.adjust else None,
            reference_image=args.reference,
            match_strength=args.match_strength,
            sharpen_strength=args.sharpen, grain_intensity=args.grain,
            seed=args.seed, luts_dir=args.luts_dir,
            fused_mode=args.fused_mode, **common))


if __name__ == "__main__":
    main()
