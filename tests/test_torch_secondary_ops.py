"""The port's secondary device ops against the JAX package on the CPU:
schedules (vrgdg_tpu_torch.ops.schedules), reference images
(ops.reference_images), the reference-sheet grid (ops.grid), the image
switch (ops.image_switch) and the LoRA merge (ops.lora).

Tolerances: the copied host math (schedules, parsing, layouts) and the
selection ops exactly equal; the blends <= 1e-5; resampled images within
the resampler's budget (bilinear <= 2e-5, lanczos4 <= 1e-5); the LoRA
merge <= 1e-5 relative, its fold in IEEE float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.ops import grid as jgrid
from vrgdg_tpu.ops import image_switch as jswitch
from vrgdg_tpu.ops import lora as jlora
from vrgdg_tpu.ops import reference_images as jref
from vrgdg_tpu.ops import schedules as jsched
from vrgdg_tpu_torch.ops import grid as tgrid
from vrgdg_tpu_torch.ops import image_switch as tswitch
from vrgdg_tpu_torch.ops import lora as tlora
from vrgdg_tpu_torch.ops import reference_images as tref
from vrgdg_tpu_torch.ops import schedules as tsched

BILINEAR = 2e-5
LANCZOS = 1e-5


def _rand(seed, shape, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(
        np.float32)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert float(np.max(np.abs(got - want))) <= tol


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

SIGMAS = [0.909375, 0.725, 0.421875, 0.25, 0.1, 0.0]


@pytest.mark.parametrize("interpolation", ["linear", "ease_in", "ease_out"])
@pytest.mark.parametrize("window", [(0.0, 1.0), (0.2, 0.6), (0.5, 0.5)])
@pytest.mark.parametrize("outside", [None, 1.0])
def test_transition_values_copy(interpolation, window, outside):
    got = tsched.build_transition_values(SIGMAS, 3.0, 1.0, interpolation,
                                         *window, outside_value=outside)
    want = jsched.build_transition_values(SIGMAS, 3.0, 1.0, interpolation,
                                          *window, outside_value=outside)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_schedule_lookups_and_strength_lists_copy():
    runtime = SIGMAS[2:]
    assert tsched.runtime_schedule_offset(SIGMAS, runtime) \
        == jsched.runtime_schedule_offset(SIGMAS, runtime) == 2
    for timestep in (0.421875, 0.3, 0.05, 2.0, -1.0):
        assert tsched.schedule_index(SIGMAS, runtime, timestep) \
            == jsched.schedule_index(SIGMAS, runtime, timestep)
    for text in ("", "0.2, 0.5,1", "1"):
        assert tsched.parse_strength_schedule(text, 0.4) \
            == jsched.parse_strength_schedule(text, 0.4)
    for bad in ("0.2,,0.3", "x", "1.5"):
        with pytest.raises(ValueError):
            tsched.parse_strength_schedule(bad, 0.4)
    assert [tsched.scheduled_strength([0.1, 0.2], i, 0.5) for i in range(4)] \
        == [jsched.scheduled_strength([0.1, 0.2], i, 0.5) for i in range(4)]
    assert tsched.guide_frame_count(17, 8) == jsched.guide_frame_count(17, 8)
    with pytest.raises(ValueError):
        tsched.runtime_schedule_offset(SIGMAS, [5.0, 4.0])


@pytest.mark.parametrize("curve", ["smoothstep", "linear", "ease_in",
                                   "ease_out"])
def test_apply_curve(curve):
    values = _rand(1, (257,))
    _close(tsched.apply_curve(torch.from_numpy(values), curve),
           jsched.apply_curve(jnp.asarray(values), curve), 1e-6)


def test_apply_curve_refuses_unknown():
    with pytest.raises(ValueError, match="Unknown curve"):
        tsched.apply_curve(torch.zeros(3), "cubic")


@pytest.mark.parametrize("last_size", [(36, 64), (20, 30)])
@pytest.mark.parametrize("frames,window,curve", [
    (17, (0.05, 0.9), "smoothstep"), (1, (0.0, 1.0), "linear"),
    (9, (0.97, 0.2), "ease_out")])
def test_first_last_blend(last_size, frames, window, curve):
    first, last = _rand(2, (36, 64, 3)), _rand(3, (1, *last_size, 3))
    got = tsched.first_last_blend(torch.from_numpy(first),
                                  torch.from_numpy(last), frames, *window,
                                  curve)
    want = jsched.first_last_blend(first, last, frames, *window, curve)
    _close(got, want, BILINEAR)


# --------------------------------------------------------------------------
# reference images
# --------------------------------------------------------------------------

def test_reference_parsing_and_sizes_copy():
    for raw in ('["a.png", {"path": "b.jpg"}, " \'c.png\' ", ""]',
                '{"images": ["x.png"]}', "one.png\n\ntwo.png", "",
                '{"k": "v.png"}'):
        assert tref.parse_image_paths(raw) == jref.parse_image_paths(raw)
    for args in ((1080, 1920, 1.0, 16), (512, 512, 0.25, 64),
                 (7, 3, 2.5, 1)):
        assert tref.scale_dims(*args) == jref.scale_dims(*args)
    for args in ((90, 160, 64, 64), (64, 64, 90, 160), (50, 50, 25, 25)):
        assert tref.center_crop_box(*args) == jref.center_crop_box(*args)


@pytest.mark.parametrize("method,tol", [("bilinear", BILINEAR),
                                        ("lanczos", LANCZOS),
                                        ("bicubic", BILINEAR)])
def test_scale_to_total_pixels(method, tol):
    images = _rand(4, (2, 60, 100, 3))
    _close(tref.scale_to_total_pixels(torch.from_numpy(images), method,
                                      0.01, 8),
           jref.scale_to_total_pixels(jnp.asarray(images), method, 0.01, 8),
           tol)


@pytest.mark.parametrize("target", [(48, 48), (30, 80), (60, 100)])
def test_upscale_center(target):
    images = _rand(5, (1, 60, 100, 3))
    _close(tref.upscale_center(torch.from_numpy(images), *target),
           jref.upscale_center(jnp.asarray(images), *target), BILINEAR)


def test_batch_reference_images():
    images = [_rand(6, (1, 40, 64, 3)), _rand(7, (2, 40, 64, 4)),
              _rand(8, (1, 80, 90, 3)), _rand(9, (1, 40, 64, 1))]
    got = tref.batch_reference_images([torch.from_numpy(i) for i in images])
    want = jref.batch_reference_images([jnp.asarray(i) for i in images])
    _close(got, want, BILINEAR)
    assert tuple(got.shape) == (5, 40, 64, 4)
    single = tref.batch_reference_images([torch.from_numpy(images[0])])
    np.testing.assert_array_equal(single.numpy(), images[0])
    with pytest.raises(ValueError, match="at least one"):
        tref.batch_reference_images([])


# --------------------------------------------------------------------------
# grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 5, 6, 7, 9])
def test_layouts_copy(count):
    for preset in jgrid.LAYOUTS:
        if preset == "aspect_rows":
            shapes = [(40 + 10 * i, 60 + 7 * i) for i in range(count)]
            assert tgrid.aspect_row_rects(shapes, 768, 448) \
                == jgrid.aspect_row_rects(shapes, 768, 448)
            continue
        for columns in (0, 2):
            assert tgrid.layout_rects(preset, count, columns) \
                == jgrid.layout_rects(preset, count, columns)
    assert tgrid.msr_frame_count("auto", count) \
        == jgrid.msr_frame_count("auto", count)
    assert tgrid.expand_reference_frames(count, 25) \
        == jgrid.expand_reference_frames(count, 25)


@pytest.mark.parametrize("layout", ["auto_ltx", "aspect_rows",
                                    "uniform_grid"])
@pytest.mark.parametrize("fit_mode", ["contain_pad", "cover_crop"])
def test_build_reference_sheet(layout, fit_mode):
    images = [_rand(10 + i, shape) for i, shape in enumerate(
        [(60, 90, 3), (1, 80, 40, 3), (50, 50, 1), (30, 120, 3),
         (64, 64, 4)])]
    kw = dict(layout=layout, output_width=256, output_height=160,
              fit_mode=fit_mode, corner_radius=6, gutter=6)
    _close(tgrid.build_reference_sheet(images, device="cpu", **kw),
           jgrid.build_reference_sheet(images, **kw), LANCZOS)


@pytest.mark.parametrize("with_background", [False, True])
@pytest.mark.parametrize("strength", ["auto", "33 (strong)"])
def test_build_msr_reference(with_background, strength):
    subjects = [_rand(20, (48, 30, 3)), _rand(21, (1, 90, 60, 4))]
    background = _rand(22, (70, 70, 3)) if with_background else None
    got = tgrid.build_msr_reference(subjects, background, 40, 64, strength,
                                    device="cpu")
    want = jgrid.build_msr_reference(subjects, background, 40, 64, strength)
    assert got.dtype == want.dtype == np.float32
    _close(got, want, LANCZOS)


# --------------------------------------------------------------------------
# image switch
# --------------------------------------------------------------------------

def _slots():
    return [_rand(30 + i, (1 + i % 2, 12, 16, 3)) for i in range(4)]


@pytest.mark.parametrize("spec", ["1", "3,1", "2-4", "4-2;1", "all", "none",
                                  "", "x,2", "7", "1,1,2"])
def test_switch_select(spec):
    slots = _slots()
    assert tswitch.parse_index_spec(spec) == jswitch.parse_index_spec(spec)
    got = tswitch.switch_select(spec, [torch.from_numpy(s) for s in slots])
    want = jswitch.switch_select(spec, [jnp.asarray(s) for s in slots])
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec,blank_zero", [
    ("all", False), ("0", False), ("0", True), ("2,0", True), ("5-1", False),
    ("9", False)])
def test_switch_dynamic(spec, blank_zero):
    slots = {1: _rand(40, (1, 10, 14, 3)), 3: _rand(41, (2, 10, 14, 3))}
    got = tswitch.switch_dynamic(spec, 5, {k: torch.from_numpy(v)
                                           for k, v in slots.items()},
                                 blank_zero, device="cpu")
    want = jswitch.switch_dynamic(spec, 5, {k: jnp.asarray(v)
                                            for k, v in slots.items()},
                                  blank_zero)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_switch_index_map_blank_and_refusals():
    slots = _slots()
    table = "1=2,3\n2=all;3=none"
    for index, fallback in ((1, "same"), (2, "1"), (3, "4"), (4, "same"),
                            (7, "2-3")):
        assert tswitch.parse_index_map(table) == jswitch.parse_index_map(table)
        got = tswitch.switch_index_map(index, table, fallback,
                                       [torch.from_numpy(s) for s in slots])
        want = jswitch.switch_index_map(index, table, fallback,
                                        [jnp.asarray(s) for s in slots])
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tswitch.blank_frame(8, 4, 0x336699, device="cpu").numpy(),
        np.asarray(jswitch.blank_frame(8, 4, 0x336699)))
    empty = tswitch.switch_dynamic("0", 3, [None] * 3, True, device="cpu")
    assert tuple(empty.shape) == (1, 576, 1024, 3)
    with pytest.raises(ValueError, match="same shape"):
        tswitch.combine_batches([torch.zeros((1, 4, 4, 3)),
                                 torch.zeros((1, 4, 5, 3))])


# --------------------------------------------------------------------------
# LoRA merge
# --------------------------------------------------------------------------

def _lora(seed, rank, fan_out, fan_in, alpha):
    rng = np.random.default_rng(seed)
    return {"down": rng.standard_normal((rank, *fan_in)).astype(np.float32),
            "up": rng.standard_normal((*fan_out, rank)).astype(np.float32)
            * 0.1, "alpha": alpha}


@pytest.mark.parametrize("rank,alpha,strength", [(4, None, 0.8),
                                                 (16, 8.0, 1.0),
                                                 (1, 2.0, -0.5)])
def test_merge_lora(rank, alpha, strength):
    rng = np.random.default_rng(50)
    params = {"linear": rng.standard_normal((64, 48)).astype(np.float32),
              "conv": rng.standard_normal((8, 3, 3, 3)).astype(np.float32),
              "untouched": rng.standard_normal((5,)).astype(np.float32)}
    lora = {"linear": _lora(51, rank, (64,), (48,), alpha),
            "conv": _lora(52, rank, (8,), (3, 3, 3), alpha)}
    got = tlora.merge_lora({k: torch.from_numpy(v) for k, v in params.items()},
                           lora, strength)
    want = jlora.merge_lora({k: jnp.asarray(v) for k, v in params.items()},
                            lora, strength)
    assert set(got) == set(want)
    for name in params:
        ours, theirs = got[name].numpy(), np.asarray(want[name])
        assert ours.shape == theirs.shape
        scale = max(1.0, float(np.max(np.abs(theirs))))
        assert float(np.max(np.abs(ours - theirs))) <= 1e-5 * scale, name
    np.testing.assert_array_equal(got["untouched"].numpy(),
                                  params["untouched"])


def test_merge_lora_skips_and_refusals():
    params = {"w": torch.ones((4, 4))}
    assert tlora.merge_lora(params, {"w": _lora(1, 2, (4,), (4,), None)},
                            0.0)["w"] is params["w"]
    with pytest.raises(KeyError, match="absent"):
        tlora.merge_lora(params, {"x": _lora(1, 2, (4,), (4,), None)}, 1.0)
    bad = _lora(1, 2, (4,), (4,), None)
    bad["up"] = bad["up"][:, :1]
    with pytest.raises(ValueError, match="rank mismatch"):
        tlora.merge_lora(params, {"w": bad}, 1.0)
    with pytest.raises(ValueError, match="produces"):
        tlora.merge_lora(params, {"w": _lora(1, 2, (5,), (4,), None)}, 1.0)


def test_apply_lora_plan():
    rng = np.random.default_rng(60)
    params = {"w": rng.standard_normal((16, 12)).astype(np.float32)}
    loras = {"a": {"w": _lora(61, 4, (16,), (12,), 2.0)},
             "b": {"w": _lora(62, 2, (16,), (12,), None)}}
    plan = {"first_pass": [("a", 1.0), ("b", 0.5)],
            "second_pass": [("b", 0.25)]}
    got = tlora.apply_lora_plan({"w": torch.from_numpy(params["w"])}, plan,
                                loras.__getitem__)
    want = jlora.apply_lora_plan({"w": jnp.asarray(params["w"])}, plan,
                                 loras.__getitem__)
    for key in ("first_pass", "second_pass"):
        np.testing.assert_allclose(got[key]["w"].numpy(),
                                   np.asarray(want[key]["w"]), rtol=1e-5,
                                   atol=1e-5)
    same = tlora.apply_lora_plan(params, {"passthrough": True}, None)
    assert same["first_pass"] == params and same["second_pass"] == params
