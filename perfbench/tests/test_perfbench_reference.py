"""The plain reference against the program's CPU path at tiny sizes (this
test imports both; the reference imports nothing of the program)."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench.cells import ROOT
from perfbench.reference import common, enhance, grade
from perfbench.reference.cube import read_cube
from perfbench.run import frame_numbers
from perfbench.tests.conftest import TINY_MIX
from perfbench.traffic import textured_clips as tc

LUT = os.path.join(ROOT, "perfbench", "data", "teal_orange.cube")


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json"),
              encoding="utf-8") as handle:
        return json.load(handle)


def test_cube_matches_the_programs_parser():
    from vrgdg_tpu_torch.core.cube import parse_cube

    mine, theirs = read_cube(LUT), parse_cube(LUT)
    assert mine.table.shape == (33, 33, 33, 3)
    assert np.abs(mine.table - theirs.table).max() < 1e-7
    assert np.array_equal(mine.domain_min, theirs.domain_min)
    assert np.array_equal(mine.domain_max, theirs.domain_max)


@pytest.mark.parametrize("src,dst", [(36, 108), (720, 2160), (1280, 3840),
                                     (64, 2560)])
def test_lanczos4_weights_match_the_programs(src, dst):
    from vrgdg_tpu_torch.ops.resize import resample_matrix

    mine = enhance.lanczos4_matrix(src, dst)
    assert np.allclose(mine.sum(axis=1), 1.0)
    assert np.abs(mine - resample_matrix(src, dst, "lanczos4")).max() < 1e-6


def test_output_size_matches_the_programs():
    from vrgdg_tpu_torch.core.params import output_dimensions

    for size in ((1280, 720), (1920, 1080), (64, 36), (3840, 2160),
                 (721, 1283)):
        for target in ("2k", "4k", "original"):
            assert enhance.output_size(*size, target) == \
                output_dimensions(*size, target)


def test_grain_matches_the_programs_stream():
    from vrgdg_tpu_torch.ops.grain import grain_field

    for frame in (0, 7, 2 ** 31 - 3):
        mine = common.grain(18, 40, 42, frame, 0.5, "cpu", torch.float64)
        theirs = grain_field([frame], 18, 40, 0.5, 42, "cpu")[0]
        assert (mine - theirs.double()).abs().max() < 1e-5


def test_lab_round_trip_matches_the_programs():
    from vrgdg_tpu_torch.core.colorspace import lab_to_rgb, rgb_to_lab

    rgb = torch.rand(4096, 3, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    mine = common.rgb_to_lab(rgb)
    assert (mine - rgb_to_lab(rgb.float()).double()).abs().max() < 2e-4
    assert (common.lab_to_rgb(mine) - rgb).abs().max() < 1e-9
    theirs = lab_to_rgb(mine.float()).double()
    assert (common.lab_to_rgb(mine) - theirs).abs().max() < 1e-5


@pytest.mark.parametrize("fused_mode", ["eager", "fused"])
def test_grade_reference_against_the_programs_cpu_path(fused_mode):
    from vrgdg_tpu_torch.api.appliers import (grade_config, grade_effect,
                                              stream_graded_batches)
    from vrgdg_tpu_torch.core.cube import parse_cube
    from vrgdg_tpu_torch.ops.color_match import lab_statistics

    config = _config("grade_flagship")
    s = dict(config["stack"], fused_mode=fused_mode)
    inputs = tc.make_inputs(TINY_MIX, 5, "cpu")
    lut = parse_cube(LUT)
    ref_stats = lab_statistics(torch.from_numpy(inputs.references[1]))
    effect = grade_effect(grade_config(
        lut=lut, lut_strength=s["lut_strength"], adjust=s["adjust"],
        ref_stats=ref_stats, match_strength=s["match_strength"],
        sharpen_strength=s["sharpen_strength"],
        grain_intensity=s["grain_intensity"],
        saturation_mix=s["saturation_mix"], seed=s["seed"],
        fused_mode=fused_mode), "cpu", lut=lut, ref_stats=ref_stats)
    clip = tc.Clip(index=0, length=9, offset=3, reference=1)
    got = np.concatenate(list(stream_graded_batches(
        tc.batches(inputs, clip, 2), effect, batch_size=2, device="cpu")))
    reference = grade.Reference(config, inputs, ROOT, "cpu")
    want = [reference.frame(clip, i, tc.frame_at(inputs, clip, i))
            for i in range(9)]
    numbers = frame_numbers(list(zip(got, want)))
    assert numbers["max_level_diff"] <= 1
    assert numbers["worst_frame_off"] < 2e-3


def test_enhance_reference_against_the_programs_cpu_path():
    from vrgdg_tpu_torch.core.params import EnhancerSettings
    from vrgdg_tpu_torch.jobs.enhancer import apply_effects_batch

    config = _config("enhance_4k")
    config["settings"].update(upscale_resolution="2k")
    mix = dict(TINY_MIX, width=32, height=18, references=0)
    inputs = tc.make_inputs(mix, 9, "cpu")
    settings = EnhancerSettings.normalize(config["settings"])
    clip = tc.Clip(index=0, length=2, offset=5, reference=-1)
    frames = np.stack([tc.frame_at(inputs, clip, i) for i in range(2)])
    got = apply_effects_batch(frames, settings, 1440, 2560, 0,
                              as_uint8=True, device="cpu")
    reference = enhance.Reference(config, inputs, ROOT, "cpu")
    want = [reference.frame(clip, i, frames[i]) for i in range(2)]
    numbers = frame_numbers(list(zip(got, want)))
    assert got.shape == (2, 1440, 2560, 3)
    assert numbers["max_level_diff"] <= 1
    assert numbers["worst_frame_off"] < 1e-3
