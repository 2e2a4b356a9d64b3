"""``correct`` comes out false for the control and for each fault the cells
can have, with the rest of a run driven as it is (on the CPU, tiny cells;
the program's plain versions stand in for its kernels there).

The control is the reference in the precision below the program's: the
whole grade in bfloat16, the enhancer's two products in TF32.  The faults
are planted in the program under the harness: a step that returns its
input unchanged; colour-match statistics from half of each frame (the mean
taken over the rest); every frame one level brighter where it is
quantized.  The cells run on one card, so no exchange between cards can
be left out.
"""

import time

import pytest
import torch

from perfbench import cells, readings, run


def _run_cell(root, name, seconds=0.6):
    cell = cells.load_cell(name, root)
    result, lines = run.run_cell(cell, 2 ** 31 + 11, seconds, False, "cpu",
                                 time.perf_counter(), root)
    return cell, result, lines


@pytest.mark.parametrize("name", ["grade_tiny", "enhance_tiny"])
def test_sound_program_is_correct(tiny_root, name):
    cell, result, lines = _run_cell(tiny_root, name)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cell.config["limits"])
    assert "setup_s" in result["metrics"]
    assert {"fps", "enhance_fps"} & set(result["metrics"])


@pytest.mark.parametrize("name", ["grade_tiny", "enhance_tiny"])
def test_control_is_not_correct(tiny_root, name):
    cell = cells.load_cell(name, tiny_root)
    line = readings.read_seed(cell, 2 ** 31 + 12, 0.3, torch.device("cpu"),
                              True, tiny_root)
    limits = cell.config["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line


def _identity(frames, config, *operands, frame_start=0):
    return frames


def _half_frame_statistics(original):
    def phase1(src, bundle, domain, *, blend, adjust=None):
        lab, _ = original(src, bundle, domain, blend=blend, adjust=adjust)
        half = src[:, :src.shape[1] // 2]
        _, partials = original(half, bundle, domain, blend=blend,
                               adjust=adjust)
        return lab, partials * 2.0
    return phase1


def _one_level_up(original):
    def quantize(frames):
        return torch.clamp(original(frames).to(torch.int16) + 1,
                           max=255).to(torch.uint8)
    return quantize


def _plain_upscale(frames, settings, out_height, out_width, frame_start):
    from vrgdg_tpu_torch.ops.resize import resample

    return torch.clamp(resample(frames, out_height, out_width, "lanczos4"),
                       0.0, 1.0)


def _plant(monkeypatch, fault):
    from vrgdg_tpu_torch.api import appliers
    from vrgdg_tpu_torch.jobs import enhancer
    from vrgdg_tpu_torch.kernels import grade_cuda
    from vrgdg_tpu_torch.runtime import video_io

    if fault == "unchanged":
        monkeypatch.setattr(appliers, "grade_prepared", _identity)
    elif fault == "half_statistics":
        monkeypatch.setattr(grade_cuda, "phase1",
                            _half_frame_statistics(grade_cuda.phase1))
    elif fault == "altered":
        monkeypatch.setattr(video_io, "quantize_on_device",
                            _one_level_up(video_io.quantize_on_device))
    elif fault == "enhance_unchanged":
        monkeypatch.setattr(enhancer, "_enhance_step", _plain_upscale)


@pytest.mark.parametrize("name,fault", [
    ("grade_tiny", "unchanged"), ("grade_tiny", "half_statistics"),
    ("grade_tiny", "altered"), ("enhance_tiny", "enhance_unchanged"),
    ("enhance_tiny", "altered")])
def test_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    _, result, lines = _run_cell(tiny_root, name)
    assert not result["correct"], lines
