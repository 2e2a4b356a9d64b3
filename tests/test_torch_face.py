"""The port's face-crop geometry (vrgdg_tpu_torch.ops.face) against
vrgdg_tpu.ops.face on the CPU.

The module is JAX-free, but the JAX package cannot be imported without
JAX, so the port keeps a copy: held here byte for byte to its original,
and run beside it on the same seeded candidates and frames (geometry
exactly equal).
"""

import os

import numpy as np
import pytest
import torch

from vrgdg_tpu.ops import face as jface
from vrgdg_tpu_torch.ops import face as tface

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_face_module_is_a_verbatim_copy():
    with open(os.path.join(REPO, "vrgdg_tpu", "ops", "face.py"), "rb") as a, \
            open(os.path.join(REPO, "vrgdg_tpu_torch", "ops", "face.py"),
                 "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("size", [(320, 240), (600, 600), (1920, 1080),
                                  (599, 800), (3840, 2160)])
def test_tile_regions_match(size):
    assert tface.tile_regions(*size) == jface.tile_regions(*size)


def _candidates(seed, count, width=640, height=480):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x, y = int(rng.integers(0, width - 20)), int(rng.integers(0, height - 20))
        w, h = int(rng.integers(4, 120)), int(rng.integers(4, 120))
        out.append((x, y, w, h, float(rng.random())))
    return out


def _pair(module, items, width=640, height=480):
    return [module.make_candidate(*c, width, height) for c in items]


@pytest.mark.parametrize("seed", range(6))
def test_dedup_select_and_box_match(seed):
    items = _candidates(seed, 12)
    ours, theirs = _pair(tface, items), _pair(jface, items)
    assert [tface.iou(a, b) for a in ours for b in ours] == \
        [jface.iou(a, b) for a in theirs for b in theirs]
    kept_t = tface.dedup_candidates(ours)
    kept_j = jface.dedup_candidates(theirs)
    assert [vars(c) for c in kept_t] == [vars(c) for c in kept_j]
    for selection in ("highest_confidence", "largest", "closest_to_center"):
        chosen_t = tface.select_candidate(kept_t, selection)
        chosen_j = jface.select_candidate(kept_j, selection)
        assert vars(chosen_t) == vars(chosen_j)
        for padding, minimum in ((0.4, 24), (0.0, 300), (2.0, 8)):
            assert tface.padded_square_box(chosen_t, 640, 480, padding,
                                           minimum) \
                == jface.padded_square_box(chosen_j, 640, 480, padding,
                                           minimum)


def test_select_refuses_empty_like_the_original():
    with pytest.raises(ValueError, match="No face passed"):
        tface.select_candidate([])


def _square_detector(frame, region):
    """The bright squares of a region, as a detector reports them."""
    left, top, right, bottom = region
    patch = np.asarray(frame)[top:bottom, left:right, 0] > 0.7
    if not patch.any():
        return []
    ys, xs = np.nonzero(patch)
    return [(left + int(xs.min()), top + int(ys.min()),
             int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1),
             0.9)]


@pytest.mark.parametrize("long_range", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_crop_face_matches(long_range, batched):
    rng = np.random.default_rng(4)
    image = rng.uniform(0, 0.5, (700, 900, 3)).astype(np.float32)
    image[300:360, 500:548] = 0.9
    if batched:
        image = image[None]
    crop_j, data_j, conf_j = jface.crop_face(image, _square_detector,
                                             long_range=long_range)
    crop_t, data_t, conf_t = tface.crop_face(torch.from_numpy(image),
                                             _square_detector,
                                             long_range=long_range)
    assert data_t == data_j and conf_t == conf_j
    np.testing.assert_array_equal(crop_t.numpy(), np.asarray(crop_j))
