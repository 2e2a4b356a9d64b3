"""The generator of clip traffic: one client grading or enhancing the
shots a video generator emits, one after the other (a closed loop).

A mix file (``traffic/<mix>.json``) gives its parameters:

- ``width``, ``height``: the frames' size;
- ``lengths``: the clip lengths, in frames; every cycle of ``len(lengths)``
  clips holds each length once, in an order the seed shuffles, so every
  seed does the same work;
- ``pool_frames``: distinct frames made at set-up; frame ``i`` of a clip
  is ``pool[(offset + i) % pool_frames]``, with ``offset`` drawn per clip;
- ``grid`` (columns, rows), ``levels`` (low, high), ``noise_sd``: each
  frame is a coarse grid of seeded levels, bilinearly upsampled, plus
  seeded Gaussian noise, rounded and clipped to uint8: smooth regions,
  edges and sensor noise;
- ``references``, ``reference_size`` (width, height): colour-match
  reference images made the same way, one drawn per clip (0: none).

Frames are made on the device from the seed in a few large calls and
kept in host memory, where a decoder would leave them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

_CHUNK_PIXELS = 32 * 2 ** 20    # pixels upsampled per call
RING_FRAMES = 15                # the pool's first frames, again after it


@dataclass(frozen=True)
class Clip:
    index: int        # position in the run's sequence of clips
    length: int       # frames
    offset: int       # pool index of frame 0
    reference: int    # colour-match reference image, -1 for none


@dataclass
class Inputs:
    ring: np.ndarray          # the pool, then its first RING_FRAMES again
    references: list          # of (1, h, w, 3) float32 in [0, 1]

    @property
    def pool(self) -> np.ndarray:
        """``(pool_frames, H, W, 3)`` uint8."""
        return self.ring[:self.ring.shape[0] - RING_FRAMES]


def _seed64(seed: int) -> int:
    return int(seed) % 2 ** 64


def textured_frames(generator: torch.Generator, count: int, height: int,
                    width: int, mix: dict, device, spare: int = 0
                    ) -> np.ndarray:
    """``count`` frames ``(count, height, width, 3)`` uint8 of the mix's
    texture, drawn from ``generator`` on ``device``, in an array with room
    for ``spare`` frames more after them."""
    columns, rows = (int(v) for v in mix["grid"])
    low, high = (int(v) for v in mix["levels"])
    out = np.empty((count + spare, height, width, 3), np.uint8)
    chunk = max(1, _CHUNK_PIXELS // (height * width))
    for start in range(0, count, chunk):
        n = min(chunk, count - start)
        coarse = torch.randint(low, high + 1, (n, 3, rows, columns),
                               generator=generator, device=device,
                               dtype=torch.float32)
        frames = F.interpolate(coarse, size=(height, width), mode="bilinear",
                               align_corners=False)
        frames += float(mix["noise_sd"]) * torch.randn(
            frames.shape, generator=generator, device=device)
        frames = frames.round_().clamp_(0, 255).to(torch.uint8)
        out[start:start + n] = frames.permute(0, 2, 3, 1).cpu().numpy()
    return out


def make_inputs(mix: dict, seed: int, device) -> Inputs:
    """The frame pool and the reference images of ``seed``."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(_seed64(seed))
    count = int(mix["pool_frames"])
    ring = textured_frames(generator, count, int(mix["height"]),
                           int(mix["width"]), mix, device, RING_FRAMES)
    for k in range(RING_FRAMES):
        ring[count + k] = ring[k % count]
    references = []
    if int(mix.get("references", 0)):
        ref_w, ref_h = (int(v) for v in mix["reference_size"])
        images = textured_frames(generator, int(mix["references"]), ref_h,
                                 ref_w, mix, device)
        # float32 on the host, as an image file is read and divided there
        references = [image[None].astype(np.float32) / np.float32(255.0)
                      for image in images]
    return Inputs(ring=ring, references=references)


def clips(mix: dict, seed: int) -> Iterator[Clip]:
    """The seed's endless sequence of clips."""
    rng = np.random.default_rng([_seed64(seed), 1])
    lengths = [int(v) for v in mix["lengths"]]
    pool = int(mix["pool_frames"])
    references = int(mix.get("references", 0))
    index = 0
    while True:
        for length in rng.permutation(lengths):
            yield Clip(index=index, length=int(length),
                       offset=int(rng.integers(pool)),
                       reference=(int(rng.integers(references))
                                  if references else -1))
            index += 1


def frame_at(inputs: Inputs, clip: Clip, i: int) -> np.ndarray:
    """Frame ``i`` of ``clip``, ``(H, W, 3)`` uint8."""
    return inputs.pool[(clip.offset + i) % inputs.pool.shape[0]]


def batches(inputs: Inputs, clip: Clip, batch: int
            ) -> Iterator[tuple[int, np.ndarray]]:
    """``(first_frame_index, (B, H, W, 3) uint8)`` host batches of
    ``clip``, as a decoder yields them: ``batch`` frames each, the last
    one short where the length does not divide.  A batch of up to
    ``RING_FRAMES + 1`` frames is a view of the ring, wrapping around the
    pool or not, so the generator copies nothing."""
    size = inputs.pool.shape[0]
    for first in range(0, clip.length, batch):
        start = (clip.offset + first) % size
        count = min(batch, clip.length - first)
        if start + count <= inputs.ring.shape[0]:
            yield first, inputs.ring[start:start + count]
        else:
            yield first, inputs.pool[(start + np.arange(count)) % size]
