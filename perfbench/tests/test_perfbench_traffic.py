"""The clip traffic: the same seed gives the same inputs and clips, every
cycle of clips does the same work, and batches are the clip's frames."""

import itertools

import numpy as np
import pytest

from perfbench.tests.conftest import TINY_MIX
from perfbench.traffic import textured_clips as tc

SEEDS = (7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    first = tc.make_inputs(TINY_MIX, seed, "cpu")
    again = tc.make_inputs(TINY_MIX, seed, "cpu")
    other = tc.make_inputs(TINY_MIX, seed + 1, "cpu")
    assert first.pool.shape == (8, 36, 64, 3) and first.pool.dtype == np.uint8
    assert np.array_equal(first.ring, again.ring)
    assert all(np.array_equal(a, b) for a, b in zip(first.references,
                                                    again.references))
    assert not np.array_equal(first.pool, other.pool)
    assert len(first.references) == 2
    assert first.references[0].shape == (1, 18, 32, 3)
    assert first.references[0].dtype == np.float32


def test_frames_are_textured():
    pool = tc.make_inputs(TINY_MIX, 3, "cpu").pool.astype(np.float64)
    # smooth regions plus sensor noise: neighbours differ by a few levels
    step = np.abs(np.diff(pool, axis=2)).mean()
    assert 2.0 < step < 20.0
    assert 16 - 30 < pool.min() and pool.max() < 235 + 30


@pytest.mark.parametrize("seed", SEEDS)
def test_clips_same_work_for_every_seed(seed):
    take = lambda s: list(itertools.islice(tc.clips(TINY_MIX, s), 12))
    clips = take(seed)
    assert clips == take(seed)
    for cycle in (clips[:2], clips[2:4], clips[4:6]):
        assert sorted(c.length for c in cycle) == [5, 9]
    assert all(0 <= c.offset < 8 and 0 <= c.reference < 2 for c in clips)
    assert [c.index for c in clips] == list(range(12))
    assert [c.offset for c in clips] != [c.offset for c in take(seed + 1)]


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 16, 17])
def test_batches_are_the_clips_frames(batch):
    inputs = tc.make_inputs(TINY_MIX, 11, "cpu")
    clip = tc.Clip(index=0, length=23, offset=6, reference=0)
    got = list(tc.batches(inputs, clip, batch))
    assert [first for first, _ in got] == list(range(0, 23, batch))
    frames = np.concatenate([b for _, b in got])
    want = np.stack([tc.frame_at(inputs, clip, i) for i in range(23)])
    assert np.array_equal(frames, want)
    if batch <= tc.RING_FRAMES + 1:
        assert all(np.shares_memory(b, inputs.ring) for _, b in got)
