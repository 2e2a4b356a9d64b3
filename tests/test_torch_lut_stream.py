"""The port's Apply LUT stream on the CPU, as ``apply_lut_to_video`` runs it
and the benchmark's ``lut_apply`` cell drives it.

- ``api.appliers._lut_effect`` through ``stream_graded_batches`` at batch
  8, on seeded textured clips of 1, 8, 9 and 17 frames (so full and short
  tail batches both run), against the benchmark's float64 reference
  (``perfbench/reference/lut.py``) within the configuration's limits, for
  ``teal_orange.cube`` and a seeded random 17^3 ``.cube`` with a non-unit
  domain, at strengths 0, 3.7 and 10.
- The same limits refuse the control (the reference in bfloat16) and each
  fault the cell can have: the table read ``[r, g, b]`` instead of
  ``[b, g, r]``, the strength ignored, no LUT at all.
- The eager stage spans of ``ops.grade.grade_prepared``: one ``grade.lut``
  under each ``batch.enqueue`` of the LUT stream, counting the batch's
  ``frames`` and the lattice's ``lut_size``; the five stages of an eager
  stack once a batch, in order; no CUDA events on the CPU; nothing at all
  with the profiler off.

The limits are the configuration's own (``worst_frame_off``, the largest
share of a frame's values that differ; ``max_level_diff``, the largest
difference in levels), so these tests hold the port to what the benchmark
holds it to on the card, where the eager LUT gives the CPU's bits.  They
leave room for the port's float32 coordinates and lerps against the
reference's float64: a value near a level's edge can truncate one level
apart.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.reference.lut import Reference
from perfbench.run import frame_numbers
from perfbench.traffic import textured_clips
from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.core.cube import LutData
from vrgdg_tpu_torch.runtime import profiling
from vrgdg_tpu_torch.runtime.profiling import SPANS, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "perfbench", "configs", "lut_apply.json")
TEAL = os.path.join(REPO, "perfbench", "data", "teal_orange.cube")
MIX = {"generator": "textured_clips", "width": 64, "height": 36,
       "pool_frames": 12, "grid": [8, 6], "levels": [16, 235],
       "noise_sd": 6.0, "references": 0}
LENGTHS = (1, 8, 9, 17)
BATCH = 8
# the package's ``grade`` function hides the module of that name
grade_ops = importlib.import_module("vrgdg_tpu_torch.ops.grade")
lut_ops = importlib.import_module("vrgdg_tpu_torch.ops.lut")


def _config() -> dict:
    with open(CONFIG_PATH, encoding="utf-8") as handle:
        return json.load(handle)


def _random_cube(folder) -> str:
    """A seeded random 17^3 ``.cube`` whose domain is not [0, 1]: every
    input is mapped onto the lattice before the gather, and inputs beyond
    the domain are clipped to its faces."""
    rng = np.random.default_rng(17)
    size = 17
    values = rng.random((size ** 3, 3))
    path = os.path.join(str(folder), "random17.cube")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("TITLE \"random\"\nLUT_3D_SIZE 17\n"
                     "DOMAIN_MIN 0.05 0.02 0.1\nDOMAIN_MAX 0.9 0.95 1.2\n")
        for row in values:
            handle.write(f"{row[0]:.6f} {row[1]:.6f} {row[2]:.6f}\n")
    return path


def _inputs():
    return textured_clips.make_inputs(MIX, 2 ** 31 + 19, "cpu")


def _clips():
    return [textured_clips.Clip(index=i, length=length, offset=3 * i,
                                reference=-1)
            for i, length in enumerate(LENGTHS)]


def _stream(inputs, lut_path, strength):
    """Every clip through the applier's effect and the batch stream: a list
    of ``(clip, index, input frame, output frame)``."""
    effect, _ = appliers._lut_effect(os.path.basename(lut_path), strength,
                                     os.path.dirname(lut_path), "cpu")
    out = []
    for clip in _clips():
        frames = np.concatenate(list(appliers.stream_graded_batches(
            textured_clips.batches(inputs, clip, BATCH), effect,
            batch_size=BATCH, device="cpu", dispatch_depth=2)))
        assert frames.shape[0] == clip.length
        for index in range(clip.length):
            out.append((clip, index,
                        textured_clips.frame_at(inputs, clip, index),
                        frames[index]))
    return out


def _reference(lut_path, strength, control=None):
    config = _config()
    config["stack"] = dict(config["stack"], lut=lut_path,
                           lut_strength=strength)
    return Reference(config, None, REPO, torch.device("cpu"), control)


def _numbers(streamed, reference):
    return frame_numbers([(got, reference.frame(clip, index, source))
                          for clip, index, source, got in streamed])


def _within(numbers) -> bool:
    return all(numbers[name] <= limit
               for name, limit in _config()["limits"].items())


@pytest.mark.parametrize("strength", [0.0, 3.7, 10.0])
@pytest.mark.parametrize("which", ["teal_orange", "random17"])
def test_lut_stream_matches_the_reference(tmp_path, which, strength):
    lut_path = TEAL if which == "teal_orange" else _random_cube(tmp_path)
    streamed = _stream(_inputs(), lut_path, strength)
    numbers = _numbers(streamed, _reference(lut_path, strength))
    assert _within(numbers), numbers
    if strength == 0.0:
        # nothing of the LUT is mixed in: the frames come back as they went
        assert all(np.array_equal(got, source)
                   for _, _, source, got in streamed)


def _transposed_table(monkeypatch):
    """The fault of a reader that indexes the lattice ``[r, g, b]``."""
    cache = appliers.GLOBAL_LUT_CACHE

    class Swapped:
        @staticmethod
        def load(path):
            lut = cache.load(path)
            return LutData(size=lut.size,
                           table=np.ascontiguousarray(
                               lut.table.transpose(2, 1, 0, 3)),
                           domain_min=lut.domain_min,
                           domain_max=lut.domain_max)

    monkeypatch.setattr(appliers, "GLOBAL_LUT_CACHE", Swapped)


def _strength_ignored(monkeypatch):
    finish = lut_ops._finish
    monkeypatch.setattr(lut_ops, "_finish",
                        lambda frames, source, graded, strength:
                        finish(frames, source, graded, 10.0))


def _no_lut(monkeypatch):
    monkeypatch.setattr(grade_ops, "apply_lut_bundle",
                        lambda frames, *args, **kwargs: frames)


FAULTS = {"rgb_order": _transposed_table,
          "strength_ignored": _strength_ignored,
          "identity": _no_lut}


@pytest.mark.parametrize("fault", ["control", *FAULTS])
def test_control_and_faults_fail_the_limits(monkeypatch, fault):
    strength = 3.7
    reference = _reference(TEAL, strength)
    if fault == "control":
        lower = _reference(TEAL, strength, _config()["control"])
        inputs = _inputs()
        numbers = frame_numbers(
            [(lower.frame(clip, i, textured_clips.frame_at(inputs, clip, i)),
              reference.frame(clip, i,
                              textured_clips.frame_at(inputs, clip, i)))
             for clip in _clips() for i in range(clip.length)])
    else:
        FAULTS[fault](monkeypatch)
        numbers = _numbers(_stream(_inputs(), TEAL, strength), reference)
    assert not _within(numbers), (fault, numbers)


def _spans_of(fn):
    before = {record.id for record in SPANS}
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return [record for record in SPANS if record.id not in before]


def test_each_enqueue_of_the_lut_stream_holds_one_lut_span():
    inputs = _inputs()
    records = _spans_of(lambda: _stream(inputs, TEAL, 10.0))
    enqueues = {r.id: r for r in records if r.name == "batch.enqueue"}
    stages = [r for r in records if r.name.startswith("grade.")]
    assert len(enqueues) == sum(-(-n // BATCH) for n in LENGTHS) == 7
    assert sorted(r.parent for r in stages) == sorted(enqueues)
    for record in stages:
        enqueue = enqueues[record.parent]
        assert record.name == "grade.lut"
        assert record.counts == {"frames": enqueue.counts["frames"],
                                 "lut_size": 33}
        assert (record.stream, record.batch) == (enqueue.stream,
                                                 enqueue.batch)
        assert record.events is None and profiling.device_ms(record) is None


def test_an_eager_stack_spans_its_five_stages_in_order():
    rng = np.random.default_rng(23)
    reference = torch.from_numpy(rng.random((1, 16, 16, 3), np.float32))
    ref_stats = grade_ops.lab_statistics(reference)
    lut = appliers.GLOBAL_LUT_CACHE.load(TEAL)
    config = appliers.grade_config(
        lut=lut, lut_strength=8.0, adjust={"contrast": 12.0},
        ref_stats=ref_stats, match_strength=0.7, sharpen_strength=1.5,
        grain_intensity=0.05, seed=42, fused_mode="eager")
    effect = appliers.grade_effect(config, "cpu", lut=lut,
                                   ref_stats=ref_stats)
    clip = rng.integers(0, 256, (5, 12, 20, 3), np.uint8)
    batches = [(0, clip[0:2]), (2, clip[2:4]), (4, clip[4:5])]
    records = _spans_of(lambda: list(appliers.stream_graded_batches(
        batches, effect, batch_size=2, device="cpu")))
    order = ["grade.lut", "grade.adjust", "grade.match", "grade.sharpen",
             "grade.grain"]
    for enqueue in [r for r in records if r.name == "batch.enqueue"]:
        children = sorted((r for r in records if r.parent == enqueue.id),
                          key=lambda r: r.start_ns)
        assert [r.name for r in children] == order
        for record in children:
            assert record.counts["frames"] == enqueue.counts["frames"]
            assert record.events is None


def test_stage_spans_are_the_shared_no_op_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    off = span("batch.wait")
    assert span("grade.lut", device=torch.device("cpu"), frames=8,
                lut_size=33) is off
    assert span("grade.grain", device=torch.device("cuda"), frames=1) is off
    before = (len(SPANS), SPANS.dropped)
    _stream(_inputs(), TEAL, 10.0)
    assert (len(SPANS), SPANS.dropped) == before
