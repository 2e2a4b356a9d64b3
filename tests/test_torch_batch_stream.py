"""Staging one batch ahead in the port's batch stream
(``vrgdg_tpu_torch.runtime.batch_stream``: ``look_ahead`` and ``Stager``,
over the native copy pool ``native/stage.cpp``).

On the CPU:

- the native pool copies exactly (sizes around its 1 MiB parts, views and
  float32 through ``Stager``), the thread that waits copies the parts no
  pool thread has taken, and closing the pool joins its threads;
- with a stand-in stager (a stream on a card at depth 2, which nothing
  here touches), the input is pulled at most one batch ahead of the
  caller, batch n+1 only once batch n's staging has finished, and batch
  n+1's copy starts before the caller gets batch n;
- unstaged, the input is pulled only once the caller comes back;
- the stager is closed, and no thread outlives the call, when the input,
  a copy's start or the caller raises and when the caller closes early;
- the CPU streams, depth 1, a caller that stages on its own (the mesh)
  and a host without a compiler stage inline and start no thread, and a
  stream made but never pulled makes no stager;
- a stream on a card that cannot stage ahead (no compiler, or the pool's
  threads refused) stages inline and logs it once a process.

On a card (marked ``cuda``, skipped without one), look-ahead staging
(depth 2) against inline staging (depth 1) for the fused grade, Apply LUT
and the enhancer: bit-identical outputs over clips of 1, 2, batch + 1 and
33 frames; yielded batches the caller keeps stay unchanged; an input that
overwrites one buffer on each pull still gives the right frames; closing
early, and an error in the effect or the input, leave no thread behind.
The file imports neither ``jax`` nor ``vrgdg_tpu``:

    python -m pytest -m cuda --noconftest tests/test_torch_batch_stream.py
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from vrgdg_tpu_torch.api import appliers
from vrgdg_tpu_torch.core.cube import parse_cube
from vrgdg_tpu_torch.core.params import EnhancerSettings
from vrgdg_tpu_torch.jobs import enhancer
from vrgdg_tpu_torch.native import NativeUnavailable
from vrgdg_tpu_torch.ops.color_match import lab_statistics
from vrgdg_tpu_torch.runtime import batch_stream
from vrgdg_tpu_torch.runtime.batch_stream import InFlight, Stager, look_ahead

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUTS = os.path.join(REPO, "LUTS")
BATCH = 4
LENGTHS = (1, 2, BATCH + 1, 33)
HEIGHT, WIDTH = 36, 64
ENHANCE = EnhancerSettings.normalize({
    "upscale_resolution": "original", "sharpen_strength": 1.0,
    "grain_enabled": True, "grain_intensity": 0.05, "seed": 42})


def _pool_threads() -> int:
    count = 0
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/stat", encoding="utf-8") as fh:
                stat = fh.read()
        except OSError:   # the thread ended meanwhile
            continue
        name, state = stat[stat.index("(") + 1:stat.rindex(")")], \
            stat[stat.rindex(")") + 2]
        count += name == "vrgdg-stage" and state not in "ZX"
    return count


def _os_threads(settle_s: float = 2.0) -> int:
    """The staging pools' native threads alive in this process (each
    names itself ``vrgdg-stage``); a joined thread can linger in /proc
    for a moment after it ended, so a falling count is read again until
    it holds still (at most ``settle_s``)."""
    deadline = time.monotonic() + settle_s
    count = _pool_threads()
    while time.monotonic() < deadline:
        time.sleep(0.01)
        again = _pool_threads()
        if again == count:
            return count
        count = again
    return count


@pytest.mark.parametrize("nbytes", [0, 1, 15, 16, 17, 63, 64, 65, 4097,
                                    (1 << 20) - 1, 1 << 20,
                                    3 * (1 << 20) + 7, 9 * (1 << 20) + 1])
@pytest.mark.parametrize("threads", [1, 3])
def test_stage_pool_copies_every_byte(nbytes, threads):
    lib = batch_stream._stage_lib()
    rng = np.random.default_rng(nbytes)
    source = rng.integers(0, 256, nbytes + 64, np.uint8)
    target = np.zeros_like(source)
    pool = lib.stage_open(threads)
    assert pool
    try:
        for offset in (0, 3, 16):   # unaligned too
            target[:] = 0
            assert lib.stage_copy(pool, target.ctypes.data + offset,
                                  source.ctypes.data + offset, nbytes) == 0
            assert lib.stage_wait(pool) > 0
            assert lib.stage_done(pool) == 1
            assert np.array_equal(target[offset:offset + nbytes],
                                  source[offset:offset + nbytes])
            assert not target[:offset].any()
            assert not target[offset + nbytes:].any()
    finally:
        lib.stage_close(pool)


@pytest.mark.parametrize("threads", [0, 1])
def test_the_waiting_caller_copies_the_parts_no_thread_took(threads):
    """``stage_wait`` copies every part no pool thread has claimed: with
    no threads nothing is copied until the wait, which copies it all;
    with one thread (a pool the scheduler holds back) the copy is exact
    whoever took each part."""
    lib = batch_stream._stage_lib()
    nbytes = 5 * (1 << 20) + 3
    source = np.random.default_rng(threads).integers(0, 256, nbytes,
                                                      np.uint8)
    target = np.zeros_like(source)
    pool = lib.stage_open(threads)
    try:
        assert lib.stage_copy(pool, target.ctypes.data, source.ctypes.data,
                              nbytes) == 0
        if threads == 0:
            assert lib.stage_done(pool) == 0 and not target.any()
        assert lib.stage_wait(pool) > 0
        assert lib.stage_done(pool) == 1
        assert np.array_equal(target, source)
    finally:
        lib.stage_close(pool)


def test_stager_stages_views_and_float_batches_exactly():
    before = _os_threads()
    rng = np.random.default_rng(3)
    clip = rng.integers(0, 256, (6, 90, 160, 3), np.uint8)
    batches = [clip[0:4], clip[1:5, ::2], np.ascontiguousarray(clip[5:6]),
               rng.random((2, 33, 17, 3), dtype=np.float32)]
    stager = Stager(4, "cpu")
    try:
        for frames in batches:
            stager.start(frames)
            staged, started, ended = stager.finish()
            assert started <= ended
            assert staged.dtype == torch.from_numpy(frames).dtype
            assert np.array_equal(staged.numpy(), frames)
    finally:
        stager.close()
    assert _os_threads() == before


class _StandIn:
    """A stager that copies at once and logs what it is asked to do."""

    def __init__(self, log: list, fail_at: int = -1):
        self.log, self.fail_at = log, fail_at
        self.pending = None

    def start(self, frames):
        k = int(frames.reshape(-1)[0])
        if k == self.fail_at:
            raise _Boom("stage")
        self.log.append(("start", k))
        self.pending = (k, frames.copy())

    def ready(self):
        return self.pending is not None

    def finish(self):
        k, copy = self.pending
        self.pending = None
        self.log.append(("finish", k))
        return copy, 10 * k, 10 * k + 5

    def close(self):
        self.log.append(("close", None))


class _Boom(Exception):
    pass


def _staging(monkeypatch, make) -> InFlight:
    """A stream on a card at depth 2 whose :func:`look_ahead` stages on
    ``make()`` (nothing here touches the card)."""
    monkeypatch.setattr(batch_stream, "Stager",
                        lambda threads, device: make())
    return InFlight(2, None, torch.device("cuda"))


def _numbered(count: int, log: list, fail_at: int = -1):
    """``count`` one-frame batches whose values are their numbers; each
    pull is logged."""
    for k in range(count):
        if k == fail_at:
            raise _Boom("input")
        log.append(("pull", k))
        yield k, np.full((1, 2, 2, 3), k, np.uint8)


def test_look_ahead_pulls_one_ahead_after_each_stage(monkeypatch):
    count = 6
    log: list = []
    in_flight = _staging(monkeypatch, lambda: _StandIn(log))
    for item in look_ahead(_numbered(count, log), in_flight):
        k = item.first
        log.append(("took", k))
        assert in_flight.next_ids() == (in_flight.stream, k)
        assert int(item.frames.reshape(-1)[0]) == k
        assert np.array_equal(item.pinned, item.frames)
    at = {event: index for index, event in enumerate(log)}
    for k in range(count):
        assert at[("pull", k)] < at[("start", k)] < at[("finish", k)]
        assert at[("finish", k)] < at[("took", k)]
        pulled = [j for what, j in log[:at[("took", k)]] if what == "pull"]
        assert max(pulled) == min(k + 1, count - 1)
        if k + 1 < count:   # the next copy runs while the caller holds k
            assert at[("finish", k)] < at[("pull", k + 1)]
            assert at[("start", k + 1)] < at[("took", k)]
    assert log[-1] == ("close", None)
    assert [what for what, _ in log].count("close") == 1


def test_unstaged_input_is_pulled_once_the_caller_comes_back():
    """Without staging (here a CPU stream) each batch comes as the input
    gave it, and the next is pulled only when the caller asks for it."""
    log: list = []
    in_flight = InFlight(2, None, "cpu")
    for item in look_ahead(_numbered(4, log), in_flight):
        log.append(("took", item.first))
        assert item.pinned is None
        assert int(item.frames.reshape(-1)[0]) == item.first
    assert log == [(what, k) for k in range(4)
                   for what in ("pull", "took")]


def test_look_ahead_on_the_native_stager_hands_over_exact_copies(
        monkeypatch):
    rng = np.random.default_rng(4)
    clip = rng.integers(0, 256, (9, 120, 200, 3), np.uint8)
    before = _os_threads()
    in_flight = _staging(monkeypatch, lambda: Stager(3, "cpu"))
    items = list(look_ahead([(i, clip[i:i + 2]) for i in range(0, 9, 2)],
                            in_flight))
    assert [item.first for item in items] == [0, 2, 4, 6, 8]
    for item in items:
        assert np.array_equal(item.pinned.numpy(), item.frames)
        assert item.pinned.data_ptr() != item.frames.ctypes.data
    assert _os_threads() == before


@pytest.mark.parametrize("where", ["stage", "input", "caller", "close"])
def test_look_ahead_closes_its_stager(monkeypatch, where):
    log: list = []
    stager = _StandIn(log, fail_at=2 if where == "stage" else -1)
    taken = []
    pulled = look_ahead(_numbered(5, log, 2 if where == "input" else -1),
                        _staging(monkeypatch, lambda: stager))
    with contextlib.closing(pulled):   # as the streams hold it
        if where == "close":
            taken.append(next(pulled).first)
            pulled.close()
            assert log[-1] == ("close", None)
        else:
            with pytest.raises(_Boom, match=where):
                for item in pulled:
                    taken.append(item.first)
                    if where == "caller" and item.first == 1:
                        raise _Boom("caller")
    assert taken == ([0] if where == "close" else [0, 1])
    assert [what for what, _ in log].count("close") == 1


def test_a_closed_stream_joins_the_native_threads(monkeypatch):
    before = _os_threads()
    clip = np.zeros((12, 64, 64, 3), np.uint8)
    pulled = look_ahead([(i, clip[i:i + 3]) for i in range(0, 12, 3)],
                        _staging(monkeypatch, lambda: Stager(4, "cpu")))
    assert next(pulled).first == 0
    assert _os_threads() > before
    pulled.close()
    assert _os_threads() == before


def _refuse_threads(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a staging thread was asked for")

    monkeypatch.setattr(threading.Thread, "start", refuse)
    monkeypatch.setattr(batch_stream, "Stager", refuse)


@pytest.mark.parametrize("case", ["grade_cpu", "enhance_cpu",
                                  "depth_one_on_cuda", "mesh_on_cuda",
                                  "no_compiler_on_cuda", "never_pulled"])
def test_inline_staging_starts_no_thread(monkeypatch, case):
    clip = np.random.default_rng(7).integers(0, 256, (5, 6, 8, 3), np.uint8)
    batches = [(0, clip[0:2]), (2, clip[2:4]), (4, clip[4:5])]
    _refuse_threads(monkeypatch)
    before = _os_threads()
    if case == "no_compiler_on_cuda":
        def unavailable(*args):
            raise NativeUnavailable("no g++")

        monkeypatch.setattr(batch_stream, "Stager", unavailable)
    if case == "never_pulled":   # made, closed, never started: no stager
        look_ahead(batches, InFlight(2, None, torch.device("cuda"))).close()
    elif case == "grade_cpu":
        out = [appliers.stream_graded_batches(
            batches, lambda x, i: 1.0 - x, batch_size=2, device="cpu",
            dispatch_depth=depth) for depth in (2, 1)]
        ahead, inline = (np.concatenate(list(o)) for o in out)
        assert ahead.shape == clip.shape
        assert np.array_equal(ahead, inline)
    elif case == "enhance_cpu":
        written: list = []
        done, _ = enhancer.enhance_batches(
            batches, ENHANCE, 6, 8, device="cpu", batch_size=2,
            write=written.append)
        assert done == 5 and [w.shape[0] for w in written] == [2, 2, 1]
    else:
        depth, ahead = {"depth_one_on_cuda": (1, True),
                        "mesh_on_cuda": (2, False),
                        "no_compiler_on_cuda": (2, True)}[case]
        in_flight = InFlight(depth, None, torch.device("cuda"))
        items = list(look_ahead(batches, in_flight, ahead))
        assert [item.pinned for item in items] == [None] * 3
        assert all(item.frames is frames
                   for item, (_, frames) in zip(items, batches))
        assert _os_threads() == before


@pytest.mark.parametrize("cause", ["no_compiler", "no_threads"])
def test_a_stream_that_cannot_stage_ahead_logs_it_once(monkeypatch, caplog,
                                                       cause):
    """A card's stream whose stager cannot be made (g++ missing, or the
    pool's threads refused: ``stage_open`` gives no pool) stages inline
    and says so once a process, not once a stream."""
    if cause == "no_compiler":
        def unavailable():
            raise NativeUnavailable("no g++")

        monkeypatch.setattr(batch_stream, "_stage_lib", unavailable)
    else:
        class NoThreads:
            def stage_open(self, threads):
                return None

        monkeypatch.setattr(batch_stream, "_stage_lib", NoThreads)
    monkeypatch.setattr(batch_stream, "_warned_inline", False)
    clip = np.zeros((3, 4, 4, 3), np.uint8)
    batches = [(0, clip[0:2]), (2, clip[2:3])]
    with pytest.raises(NativeUnavailable):
        batch_stream.Stager(2, "cpu")
    with caplog.at_level("WARNING", logger=batch_stream.__name__):
        for _ in range(2):
            items = list(look_ahead(batches,
                                    InFlight(2, None, torch.device("cuda"))))
            assert [item.pinned for item in items] == [None, None]
    logged = [r for r in caplog.records if r.name == batch_stream.__name__]
    assert len(logged) == 1 and "staged inline" in logged[0].getMessage()


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _clip(length: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (length, HEIGHT, WIDTH, 3), np.uint8)


def _batches(clip: np.ndarray) -> list:
    return [(first, clip[first:first + BATCH])
            for first in range(0, len(clip), BATCH)]


def _effect(kind: str, device):
    if kind == "lut":
        effect, _ = appliers._lut_effect("teal_orange.cube", 10.0, LUTS,
                                         device)
        return effect
    reference = torch.rand((1, 32, 32, 3),
                           generator=torch.Generator().manual_seed(1))
    ref_stats = lab_statistics(reference.to(device))
    lut = parse_cube(os.path.join(LUTS, "teal_orange.cube"))
    config = appliers.grade_config(
        lut=lut, lut_strength=8.0, adjust={"contrast": 12.0},
        ref_stats=ref_stats, match_strength=0.7, sharpen_strength=1.5,
        grain_intensity=0.05, saturation_mix=0.5, seed=42,
        fused_mode="fused")
    return appliers.grade_effect(config, device, lut=lut,
                                 ref_stats=ref_stats)


def _run(kind: str, batches, depth: int, monkeypatch, effect=None) -> list:
    """The batches the stream yields (grade, LUT) or writes (enhancer), as
    handed over, at dispatch ``depth``."""
    device = _card()
    monkeypatch.setenv("VRGDG_DISPATCH_DEPTH", str(depth))
    if kind == "enhance":
        written: list = []
        enhancer.enhance_batches(batches, ENHANCE, 2 * HEIGHT, 2 * WIDTH,
                                 device=device, batch_size=BATCH,
                                 write=written.append)
        return written
    return list(appliers.stream_graded_batches(
        batches, effect or _effect(kind, device), batch_size=BATCH,
        device=device, dispatch_depth=depth))


def _count_stages(monkeypatch) -> list:
    calls: list = []
    real = batch_stream.Stager.start

    def counted(self, frames):
        calls.append(len(frames))
        return real(self, frames)

    monkeypatch.setattr(batch_stream.Stager, "start", counted)
    return calls


KINDS = ("fused", "lut", "enhance")


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_look_ahead_is_bit_identical_to_inline_staging(monkeypatch, kind,
                                                       length):
    clip = _clip(length)
    inline = np.concatenate(_run(kind, _batches(clip), 1, monkeypatch))
    staged = _count_stages(monkeypatch)
    ahead = np.concatenate(_run(kind, _batches(clip), 2, monkeypatch))
    assert staged == [len(frames) for _, frames in _batches(clip)]
    assert ahead.shape == inline.shape and ahead.shape[0] == length
    assert np.array_equal(ahead, inline)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kept_batches_stay_unchanged(monkeypatch, kind):
    """Every batch handed over is kept, uncopied, to the end."""
    clip = _clip(33, seed=12)
    kept = _run(kind, _batches(clip), 2, monkeypatch)
    fresh = _run(kind, _batches(clip), 1, monkeypatch)
    assert len(kept) == len(fresh) == len(_batches(clip))
    for got, want in zip(kept, fresh):
        assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_input_that_reuses_one_buffer(monkeypatch, kind):
    """A decoder that overwrites one buffer on each pull."""
    clip = _clip(33, seed=13)

    def reusing():
        buffer = np.empty((BATCH, HEIGHT, WIDTH, 3), np.uint8)
        for first, frames in _batches(clip):
            buffer[:len(frames)] = frames
            yield first, buffer[:len(frames)]

    ahead = np.concatenate(_run(kind, reusing(), 2, monkeypatch))
    inline = np.concatenate(_run(kind, _batches(clip), 1, monkeypatch))
    assert np.array_equal(ahead, inline)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("fused", "lut"))
def test_closing_after_the_first_batch_joins_the_stager(kind):
    device = _card()
    effect = _effect(kind, device)

    def stream():
        return appliers.stream_graded_batches(
            _batches(_clip(33, seed=14)), effect, batch_size=BATCH,
            device=device, dispatch_depth=2)

    before = _os_threads()
    graded = stream()
    assert next(graded).shape == (BATCH, HEIGHT, WIDTH, 3)
    assert _os_threads() > before   # the stager's pool
    graded.close()
    assert _os_threads() == before


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["effect", "input"])
@pytest.mark.parametrize("kind", KINDS)
def test_errors_reach_the_caller_and_join_the_stager(monkeypatch, kind,
                                                     where):
    device = _card()
    calls = {"n": 0}
    before = _os_threads()

    def batches():
        for first, frames in _batches(_clip(33, seed=15)):
            if where == "input" and first == 2 * BATCH:
                raise _Boom("input")
            yield first, frames

    effect = None
    if where == "effect":
        if kind == "enhance":
            real = enhancer._enhance_step_uint8

            def failing(*args):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise _Boom("effect")
                return real(*args)

            monkeypatch.setattr(enhancer, "_enhance_step_uint8", failing)
        else:
            real_effect = _effect(kind, device)

            def effect(batch, frame_index):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise _Boom("effect")
                return real_effect(batch, frame_index)

    with pytest.raises(_Boom, match=where):
        _run(kind, batches(), 2, monkeypatch, effect)
    assert _os_threads() == before
