"""The enhancer's whole-frame step on the card: ``enhance_step``
(``kernels/csrc/enhance.cu``) and its wrapper ``kernels/enhance_cuda.py``.

On the CPU (tier 1): the tap tables the kernel reads rebuild
``resample_matrix`` exactly; every block's window of source rows holds
every row its taps name; a mirror of the kernel's blocks in torch (its
tables, windows, ring, stage order and quantize) reproduces the chain;
the wrapper refuses what the kernel does not take before anything is
built; and ``submit_effects_batch`` on the CPU still runs the torch chain
with the bits it had.

On a card (marked ``cuda``; this file imports no JAX, so it runs with
``--noconftest``): the kernel against the plain chain (``dequantize ->
_enhance_step -> quantize``) on the CPU, at most one level apart on at
most 0.1% of values (the resample sums its nonzero taps where the chain
multiplies by dense matrices, and the grain's logf/cosf differ from
torch's by an ulp), batch splits bit for bit, one launch a batch, and no
float32 frame at the output size.  The CPU's chain, not the card's, is
the yardstick: the card's torch ops dequantize and divide the box sum by
reciprocal products, and at equal size the unsharp of uint8 levels lands
about 1% of values exactly on a level, where that ulp decides the
truncation; the kernel divides as the CPU does.

    python -m pytest -m cuda --noconftest tests/test_torch_enhance_kernel.py
"""

import numpy as np
import pytest
import torch

from vrgdg_tpu_torch.core.params import EnhancerSettings
from vrgdg_tpu_torch.jobs import enhancer
from vrgdg_tpu_torch.kernels import build, enhance_cuda
from vrgdg_tpu_torch.ops.grain import film_grain, grain_field
from vrgdg_tpu_torch.ops.resize import resample, resample_matrix
from vrgdg_tpu_torch.ops.sharpen import unsharp
from vrgdg_tpu_torch.runtime import video_io
from vrgdg_tpu_torch.runtime.profiling import SPANS

AXES = [(720, 2160), (1280, 3840), (1080, 2160), (1920, 3840), (37, 101),
        (53, 149), (64, 40), (96, 60), (40, 40), (1, 5), (5, 1), (2160, 720)]
# (source h, w) -> (output h, w): 720p -> 4K, an odd upscale, a downscale,
# equal size
SIZES = {"720p_to_4k": ((720, 1280), (2160, 3840)),
         "odd_up": ((37, 53), (101, 149)),
         "down": ((64, 96), (40, 60)),
         "equal": ((48, 80), (48, 80))}
SMALL = {k: v for k, v in SIZES.items() if k != "720p_to_4k"}
# sharpen, border, grain
EFFECTS = [(s, b, g) for s in (0.0, 0.5) for b in ("zero", "edge")
           for g in (0.0, 0.04)]


def _settings(sharpen, border, grain) -> EnhancerSettings:
    return EnhancerSettings.normalize({
        "sharpen_enabled": sharpen > 0, "sharpen_strength": sharpen or 0.5,
        "grain_enabled": grain > 0, "grain_intensity": grain or 0.04,
        "saturation_mix": 0.5, "seed": 42,
        "use_accelerator": border == "zero"})


def _frames(size, batch=1, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (batch, *size, 3), np.uint8)


def _chain(frames: torch.Tensor, settings, out_hw, frame_start) -> torch.Tensor:
    """The plain chain on the frames' device: dequantize -> _enhance_step
    -> quantize."""
    out = enhancer._enhance_step(video_io.dequantize_on_device(frames),
                                 settings, *out_hw, frame_start)
    return video_io.quantize_on_device(out)


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
        int(diff.max()), float((diff > 0).mean()))


# -- the tables and windows the kernel reads -------------------------------

@pytest.mark.parametrize("src,dst", AXES)
def test_uploaded_tap_tables_rebuild_resample_matrix(src, dst):
    tables = enhance_cuda.device_tables(src, 1, dst, 1, torch.device("cpu"))
    idx = tables["row_idx"].numpy()
    weights = tables["row_w"].numpy()
    assert idx.dtype == np.int32 and weights.dtype == np.float32
    dense = np.zeros((dst, src), np.float32)
    for t in range(idx.shape[1]):
        np.add.at(dense, (np.arange(dst), idx[:, t]), weights[:, t])
    want = resample_matrix(src, dst, "lanczos4")
    assert np.array_equal(dense.view(np.uint32), want.view(np.uint32))
    assert idx.shape[1] == enhance_cuda.TAPS
    # ascending source order, padding on the row's last index
    assert (np.diff(idx, axis=1) >= 0).all()


@pytest.mark.parametrize("src,dst", AXES)
@pytest.mark.parametrize("tile", (*enhance_cuda.TILE_HEIGHTS,
                                  enhance_cuda.TILE_W))
def test_every_block_window_holds_its_taps(src, dst, tile):
    idx, _ = enhance_cuda.tap_table(src, dst)
    first, span = enhance_cuda.windows(src, dst, tile)
    assert span <= src and len(first) == -(-dst // tile)
    for block, lo in enumerate(first):
        held = min(span, src - lo)
        ring = np.clip(np.arange(block * tile - 1, (block + 1) * tile + 1),
                       0, dst - 1)
        taps = idx[ring] - lo
        assert taps.min() >= 0 and taps.max() < held


def test_plan_shrinks_the_block_for_steep_downscales():
    assert enhance_cuda.plan(720, 1280, 2160, 3840)[0] == 32
    tile_h, window, span = enhance_cuda.plan(2160, 3840, 120, 3840)
    assert tile_h < 32
    assert enhance_cuda.smem_bytes(window, span, tile_h) <= \
        enhance_cuda.SMEM_BUDGET
    with pytest.raises(ValueError, match="more source samples"):
        enhance_cuda.plan(10_000, 64, 100, 64)


# -- a mirror of the kernel's blocks ---------------------------------------

def _mirror(u8: np.ndarray, out_hw, sharpen, border, grain, seed,
            frame_start) -> np.ndarray:
    """``csrc/enhance.cu`` block row by block row in float32 torch: levels
    by true division, each block row's width pass over its window only,
    the height pass over its rows and ring (indices rebased on the
    window), the ring's border, the unsharp in box_blur_3x3's order, the
    grain and the quantize."""
    frames = torch.from_numpy(u8)
    batch, src_h, src_w, channels = frames.shape
    out_h, out_w = out_hw
    tile_h, window, _ = enhance_cuda.plan(src_h, src_w, out_h, out_w)
    row_lo, _ = enhance_cuda.windows(src_h, out_h, tile_h)
    col_idx, col_w = enhance_cuda.tap_table(src_w, out_w)
    row_idx, row_w = enhance_cuda.tap_table(src_h, out_h)
    level = torch.arange(256, dtype=torch.float32) / 255.0
    src = level[frames.long()]
    cols = torch.from_numpy(np.clip(np.arange(-1, out_w + 1), 0, out_w - 1))
    padded = torch.zeros(batch, out_h + 2, out_w + 2, channels)
    for block, lo in enumerate(row_lo):
        rows = min(window, src_h - int(lo))
        part = src[:, lo:lo + rows]
        wide = torch.zeros(batch, rows, out_w + 2, channels)
        for t in range(col_idx.shape[1]):
            weight = torch.from_numpy(col_w[:, t])[cols][None, None, :, None]
            taps = torch.from_numpy(col_idx[:, t]).long()[cols]
            wide = wide + weight * part[:, :, taps]
        for y in range(block * tile_h - 1, (block + 1) * tile_h + 1):
            if not -1 <= y <= out_h:
                continue
            yc = min(max(y, 0), out_h - 1)
            taps = row_idx[yc] - lo
            assert taps.min() >= 0 and taps.max() < rows
            acc = torch.zeros(batch, out_w + 2, channels)
            for k, weight in zip(taps, row_w[yc]):
                acc = acc + float(weight) * wide[:, k]
            padded[:, y + 1] = torch.clamp(acc, 0.0, 1.0)
    if border == "zero":
        padded[:, 0] = padded[:, -1] = 0.0
        padded[:, :, 0] = padded[:, :, -1] = 0.0
    out = padded[:, 1:-1, 1:-1]
    if sharpen:
        acc = sum(padded[:, 1 + dy:1 + dy + out_h, 1 + dx:1 + dx + out_w]
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        out = torch.clamp(out + sharpen * (out - acc / 9.0), 0.0, 1.0)
    if grain:
        field = grain_field(frame_start + torch.arange(batch), out_h, out_w,
                            0.5, seed, "cpu")
        out = torch.clamp(out + field * grain, 0.0, 1.0)
    return video_io.quantize_on_device(out).numpy()


@pytest.mark.parametrize("effects", EFFECTS, ids=lambda e: "-".join(map(str, e)))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_mirror_of_the_blocks_reproduces_the_chain(name, effects):
    (src_hw, out_hw), (sharpen, border, grain) = SMALL[name], effects
    u8 = _frames(src_hw, batch=2, seed=3)
    got = _mirror(u8, out_hw, sharpen, border, grain, 42, 5)
    want = _chain(torch.from_numpy(u8), _settings(sharpen, border, grain),
                  out_hw, 5).numpy()
    _close(got, want)
    if name == "equal" and not sharpen and not grain:
        assert np.array_equal(got, u8)      # one tap of weight 1.0


# -- the wrapper's refusals, before any build -------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "load_libraries", refuse)


def _kw():
    return dict(sharpen_strength=0.5, border="zero", grain_intensity=0.04,
                saturation_mix=0.5, seed=42)


@pytest.mark.parametrize("frames,match", [
    (torch.zeros((1, 4, 6, 3), dtype=torch.float32), "uint8"),
    (torch.zeros((1, 6, 4, 3), dtype=torch.uint8).transpose(1, 2),
     "contiguous"),
    (torch.zeros((1, 4, 6, 3), dtype=torch.uint8), "no kernel for device cpu"),
    (torch.zeros((4, 6, 3), dtype=torch.uint8), r"\(B, H, W, 3\)"),
    (torch.zeros((1, 4, 6, 4), dtype=torch.uint8), r"\(B, H, W, 3\)"),
], ids=["float32", "strided", "cpu", "3d", "four_channels"])
def test_wrapper_refuses_what_the_kernel_does_not_take(no_build, frames,
                                                       match):
    with pytest.raises(ValueError, match=match):
        enhance_cuda.enhance_step(frames, 8, 12, **_kw())


# -- the CPU keeps the chain -----------------------------------------------

def test_cpu_submit_keeps_the_chain_bit_for_bit(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the kernel")

    monkeypatch.setattr(enhance_cuda, "enhance_step", refuse)
    settings = _settings(0.5, "zero", 0.04)
    u8 = _frames((20, 30), batch=3, seed=9)
    got = enhancer.submit_effects_batch(u8, settings, 40, 64, 7,
                                        as_uint8=True, device="cpu").result()
    frames = torch.from_numpy(u8).to(torch.float32) / 255.0
    frames = torch.clamp(resample(frames, 40, 64, "lanczos4"), 0.0, 1.0)
    frames = film_grain(unsharp(frames, 0.5, "zero"), 0.04, 0.5, 42,
                        frame_start=7)
    want = torch.clamp(frames * 255.0, 0, 255).to(torch.uint8).numpy()
    assert np.array_equal(got, want)


# -- on the card -----------------------------------------------------------

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel(frames, settings, out_hw, frame_start):
    return enhancer._enhance_step_uint8(frames, settings, *out_hw,
                                        frame_start)


@pytest.mark.cuda
@pytest.mark.parametrize("effects", EFFECTS, ids=lambda e: "-".join(map(str, e)))
@pytest.mark.parametrize("name", sorted(SIZES))
def test_kernel_matches_the_chain_on_the_card(name, effects):
    device = _card()
    (src_hw, out_hw), settings = SIZES[name], _settings(*effects)
    u8 = _frames(src_hw, seed=4)
    got = _kernel(torch.from_numpy(u8).to(device), settings, out_hw, 0)
    want = _chain(torch.from_numpy(u8), settings, out_hw, 0)
    _close(got.cpu().numpy(), want.numpy())
    if name == "equal" and not effects[2]:
        assert torch.equal(got.cpu(), want)     # the CPU's own arithmetic


@pytest.mark.cuda
def test_kernel_batch_of_three_from_frame_five_on_the_card():
    device = _card()
    settings = _settings(0.5, "zero", 0.04)
    u8 = _frames((37, 53), batch=3, seed=5)
    frames = torch.from_numpy(u8).to(device)
    got = _kernel(frames, settings, (101, 149), 5)
    want = _chain(torch.from_numpy(u8), settings, (101, 149), 5)
    _close(got.cpu().numpy(), want.numpy())
    singles = torch.cat([_kernel(frames[i:i + 1], settings, (101, 149),
                                 5 + i) for i in range(3)])
    assert torch.equal(got, singles)


@pytest.mark.cuda
def test_enhance_batches_launch_the_kernel_once_a_batch():
    device = _card()
    settings = _settings(0.5, "zero", 0.04)
    u8 = _frames((40, 70), batch=5, seed=6)
    batches = [(0, u8[0:2]), (2, u8[2:4]), (4, u8[4:5])]
    written = []
    build.reset_launch_counts()
    enhancer.enhance_batches(batches, settings, 90, 160, device=device,
                             batch_size=2, write=written.append)
    assert build.LAUNCHES["enhance_step"] == 3
    assert build.LAUNCHES["film_grain"] == 0
    want = _chain(torch.from_numpy(u8), settings, (90, 160), 0)
    _close(np.concatenate(written), want.numpy())


@pytest.mark.cuda
def test_no_float32_frame_at_the_output_size_on_the_card():
    device = _card()
    settings = _settings(0.5, "zero", 0.04)
    frames = torch.from_numpy(_frames((720, 1280), seed=7)).to(device)
    _kernel(frames, settings, (2160, 3840), 0)     # tables uploaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = _kernel(frames, settings, (2160, 3840), 0)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(device) - before
    assert grown <= out.numel() + (1 << 20) < 4 * out.numel()


@pytest.mark.cuda
def test_fused_step_records_one_span_on_the_card():
    from torch.profiler import ProfilerActivity, profile

    device = _card()
    u8 = _frames((40, 70), batch=2, seed=8)
    before = {record.id for record in SPANS}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        enhancer.apply_effects_batch(u8, _settings(0.5, "zero", 0.04), 90,
                                     160, 0, device=device, as_uint8=True)
    names = [r.name for r in SPANS if r.id not in before]
    assert names.count("enhance.step") == 1
    assert not {"enhance.resample", "enhance.sharpen",
                "enhance.grain"} & set(names)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float32", "strided", "cpu"])
def test_wrapper_refuses_on_the_card(case):
    device = _card()
    frames = {"float32": torch.zeros((1, 4, 6, 3), device=device),
              "strided": torch.zeros((1, 6, 4, 3), dtype=torch.uint8,
                                     device=device).transpose(1, 2),
              "cpu": torch.zeros((1, 4, 6, 3), dtype=torch.uint8)}[case]
    with pytest.raises(ValueError):
        enhance_cuda.enhance_step(frames, 8, 12, **_kw())
