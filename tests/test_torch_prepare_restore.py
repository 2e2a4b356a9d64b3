"""The port's guided-enhance prepare/restore math
(vrgdg_tpu_torch.jobs.prepare_restore) against vrgdg_tpu's on seeded
clips.

Bound: working frames, anchors and restored clips <= 2e-5 against JAX,
the torch-parity budget of the resampling they run on; index plans and
context fields exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.jobs import prepare_restore as jpr
from vrgdg_tpu_torch.jobs import prepare_restore as tpr

BOUND = 2e-5


def _clip(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= BOUND


@pytest.mark.parametrize("count,interval", [(40, 16), (33, 16), (1, 16),
                                            (17, 8), (64, 5), (9, 2)])
def test_index_plans_match_jax(count, interval):
    indices = tpr.anchor_indices(count, interval)
    assert indices == jpr.anchor_indices(count, interval)
    assert (tpr.safe_conditioning_indices(indices, count)
            == jpr.safe_conditioning_indices(indices, count))
    for crowded in ([16, 17], [0, 1], [17], [1, 9, 17, 25]):
        assert (tpr.safe_conditioning_indices(crowded, 40)
                == jpr.safe_conditioning_indices(crowded, 40))
    with pytest.raises(ValueError, match="safe LTX"):
        tpr.safe_conditioning_indices([1, 1, 1], 2)


@pytest.mark.parametrize("fit", ["letterbox", "stretch", "crop"])
def test_prepare_matches_jax(fit):
    clip = _clip(0, (20, 36, 64, 3))
    kwargs = dict(anchor_interval=8, anchor_width=100, anchor_height=50,
                  working_width=130, working_height=70,
                  dimension_multiple=32, fit_mode=fit, fps=12.0)
    j_work, j_anchors, j_ctx = jpr.prepare(jnp.asarray(clip), **kwargs)
    t_work, t_anchors, t_ctx = tpr.prepare(torch.from_numpy(clip), **kwargs)
    _close(t_work, j_work)
    _close(t_anchors, j_anchors)
    assert t_work.shape == (20, 64, 128, 3)
    for name in ("source_width", "source_height", "frame_count", "fps",
                 "anchor_indices", "anchor_width", "anchor_height",
                 "working_width", "working_height", "fit_mode",
                 "resize_method"):
        assert getattr(t_ctx, name) == getattr(j_ctx, name), name


@pytest.mark.parametrize("fit", ["letterbox", "stretch", "crop"])
@pytest.mark.parametrize("drift,strength", [(0, 1.0), (-3, 1.0), (4, 0.5),
                                            (-7, 0.0)])
def test_restore_matches_jax(fit, drift, strength):
    clip = _clip(1, (20, 30, 40, 3))
    kwargs = dict(anchor_interval=8, working_width=64, working_height=64,
                  dimension_multiple=8, fit_mode=fit)
    j_work, _, j_ctx = jpr.prepare(jnp.asarray(clip), **kwargs)
    t_work, _, t_ctx = tpr.prepare(torch.from_numpy(clip), **kwargs)
    # a stand-in model: brighten, and drop or repeat frames within +-7
    model = _clip(2, (20 + drift, 64, 64, 3)) * 0.5 \
        if drift > 0 else None
    j_in = np.asarray(j_work)[:20 + drift] if drift <= 0 else model
    t_in = t_work.numpy()[:20 + drift] if drift <= 0 else model
    want = np.asarray(jpr.restore(jnp.asarray(j_in), j_ctx,
                                  enhancement_strength=strength))
    got = tpr.restore(torch.from_numpy(np.array(t_in)), t_ctx,
                      enhancement_strength=strength)
    assert got.shape == clip.shape
    _close(got, want)
    usable = min(20, 20 + drift)
    # source-tail frames are the untouched originals
    np.testing.assert_array_equal(got.numpy()[usable:], clip[usable:])
    if strength == 0.0:
        np.testing.assert_allclose(got.numpy(), clip, atol=1e-6)


def test_restore_refuses_drift_beyond_tolerance():
    clip = torch.from_numpy(_clip(3, (20, 16, 16, 3)))
    working, _, ctx = tpr.prepare(clip, working_width=32, working_height=32,
                                  dimension_multiple=8)
    with pytest.raises(ValueError, match="frames"):
        tpr.restore(working[:12], ctx)
    with pytest.raises(ValueError, match="non-empty"):
        tpr.prepare(clip[:0])


def test_restore_keeps_extra_channels_and_blends_linearly():
    clip = _clip(4, (4, 16, 16, 4))
    working, _, ctx = tpr.prepare(torch.from_numpy(clip), working_width=16,
                                  working_height=16, dimension_multiple=8,
                                  fit_mode="stretch")
    enhanced = torch.clamp(working + 0.2, 0, 1)
    zero, half, full = (tpr.restore(enhanced, ctx, enhancement_strength=s)
                        for s in (0.0, 0.5, 1.0))
    np.testing.assert_array_equal(full.numpy()[..., 3], clip[..., 3])
    np.testing.assert_allclose(half.numpy(), (zero.numpy() + full.numpy()) / 2,
                               atol=1e-5)


def test_run_guided_enhance_matches_jax():
    clip = _clip(5, (12, 24, 32, 3))
    seen = {}

    def model(working, anchors, safe):
        seen.setdefault("safe", []).append(safe)
        return working * 0.9

    kwargs = dict(anchor_interval=8, working_width=64, working_height=48,
                  dimension_multiple=16, fit_mode="letterbox",
                  resize_method="bilinear", enhancement_strength=0.8)
    want = jpr.run_guided_enhance(jnp.asarray(clip), model, **kwargs)
    got = tpr.run_guided_enhance(torch.from_numpy(clip), model, **kwargs)
    _close(got, want)
    assert seen["safe"][0] == seen["safe"][1]
    assert all(i % 8 != 1 for i in seen["safe"][1])
