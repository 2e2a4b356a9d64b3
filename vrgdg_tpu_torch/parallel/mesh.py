"""Device-mesh sharding for the grade stack.

Counterpart of :mod:`vrgdg_tpu.parallel.mesh`, with explicit devices in
place of GSPMD:

- **frame-axis data parallelism** ("data"): a clip is padded to a
  multiple of the data axis (repeating its last frame) and each data row
  of the mesh grades one contiguous block of frames with ``frame_start``
  advanced to the block's first absolute frame.  Every op of the stack is
  frame-local and grain is keyed on the absolute frame, so the result is
  bit-identical to one device, grain included.  The rows' launches are
  queued without a host synchronisation between them, so separate cards
  overlap.
- **spatial parallelism** ("space"): each frame is additionally split by
  height over the devices of a data row, with explicit halo exchanges and
  a float64 reduction of the colour-match statistics
  (:mod:`vrgdg_tpu_torch.parallel.spatial`); the result matches one device
  within 1e-5.

A :class:`Mesh` holds this process's rows of the ``(data, space)`` grid.
Once a ``torch.distributed`` group exists
(:func:`~vrgdg_tpu_torch.parallel.distributed.initialize_distributed`),
:func:`make_mesh` builds meshes whose data axis spans the processes; space
groups stay inside one process.  :func:`grade_on_mesh` on such a mesh
grades the frames of this process's rows and all-gathers the result, so
every rank holds the whole clip.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .distributed import all_gather_rows, local_devices
from .spatial import HeightShards, grade_rows, place

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclass(frozen=True)
class Mesh:
    """A ``(data, space)`` grid of torch devices.

    ``devices`` holds this process's rows.  On a mesh that spans the
    processes of a group, rank ``r``'s rows are the data rows
    ``[r * len(devices), (r + 1) * len(devices))`` of the whole grid."""

    devices: tuple[tuple[torch.device, ...], ...]
    process_index: int = 0
    process_count: int = 1
    spans_processes: bool = False

    axis_names = (DATA_AXIS, SPACE_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices) * self.process_count,
                SPACE_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        """Devices in the whole grid, every process's included."""
        return self.shape[DATA_AXIS] * self.shape[SPACE_AXIS]

    @property
    def first_row(self) -> int:
        """The whole grid's data row of this process's first row."""
        return self.process_index * len(self.devices)

    @property
    def lead(self) -> torch.device:
        """This process's first device: where results are assembled."""
        return self.devices[0][0]


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int | None = None, spatial: int = 1,
              devices=None, *, span_processes: bool | None = None) -> Mesh:
    """Build a ``(data, space)`` mesh over the first ``n_devices`` devices.

    ``devices`` defaults to this process's cards
    (:func:`~vrgdg_tpu_torch.parallel.distributed.local_devices`); only an
    explicit list may name one device more than once (``[cuda:0] * 4``
    runs the shard arithmetic on one card).  Asking for more devices than
    there are is refused.  ``spatial`` devices cooperate on each frame
    (height-sharded); the rest of the mesh parallelizes over frames.

    ``span_processes`` (default: whether a ``torch.distributed`` group
    exists) makes the data axis span every process of the group, each
    contributing its ``devices``; ``n_devices`` then counts the devices of
    all of them."""
    spatial = max(1, int(spatial))
    if span_processes is None:
        span_processes = dist.is_available() and dist.is_initialized()
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if span_processes else (0, 1))
    local = [_normalize(d) for d in (devices if devices is not None
                                      else local_devices())]
    visible = len(local) * world
    if n_devices is not None:
        want = int(n_devices)
        if want > visible:
            raise ValueError(
                f"A mesh of {want} devices was asked for but only {visible} "
                f"{'are' if devices is not None else 'cards are'} visible.")
        if want % world:
            raise ValueError(f"{want} devices do not divide over {world} "
                             "processes.")
        local = local[:want // world]
    if not local:
        raise ValueError("A mesh needs at least one device; no card is "
                         "visible (pass devices=[...] for other devices).")
    if len(local) % spatial:
        raise ValueError(
            f"{len(local)} devices do not divide into spatial groups of "
            f"{spatial}.")
    grid = tuple(tuple(local[i:i + spatial])
                 for i in range(0, len(local), spatial))
    return Mesh(grid, rank, world, bool(span_processes))


def frame_sharding(mesh: Mesh, spatial: bool = False) -> "FrameSharding":
    """Placement of a BHWC clip on ``mesh``: frames over "data", and
    optionally height over "space"."""
    return FrameSharding(mesh, bool(spatial))


@dataclass(frozen=True)
class FrameSharding:
    mesh: Mesh
    spatial: bool

    def place(self, frames: torch.Tensor) -> list:
        """This process's shards of a clip whose frame count divides the
        data axis: per local data row, its block of frames on the row's
        first device, or (spatial) split by height over the row as
        :class:`~vrgdg_tpu_torch.parallel.spatial.HeightShards`."""
        per = frames.shape[0] // self.mesh.shape[DATA_AXIS]
        shards = []
        for row_index, row in enumerate(self.mesh.devices):
            first = (self.mesh.first_row + row_index) * per
            block = frames[first:first + per]
            shards.append(HeightShards.split(block, row) if self.spatial
                          else place(block, row[0]))
        return shards


def replicated(mesh: Mesh) -> list[torch.device]:
    """The distinct devices of this process's rows: where a replicated
    operand (a LUT table, reference statistics) needs a copy."""
    return list(dict.fromkeys(d for row in mesh.devices for d in row))


def pad_to_multiple(frames: torch.Tensor, multiple: int,
                    axis: int = 0) -> tuple[torch.Tensor, int]:
    """Pad ``axis`` up to a multiple (repeating the last slice) so a clip
    divides evenly over the mesh; returns (padded, original_length)."""
    length = frames.shape[axis]
    remainder = length % multiple
    if remainder == 0:
        return frames, length
    last = frames.narrow(axis, length - 1, 1)
    filler = torch.cat([last] * (multiple - remainder), dim=axis)
    return torch.cat([frames, filler], dim=axis), length


def shard_clip(frames: torch.Tensor, mesh: Mesh,
               spatial: bool = False) -> tuple[list, int]:
    """Place a BHWC clip on the mesh (padding the frame axis to divide
    evenly); returns (this process's shards, original_frame_count)."""
    frames = torch.as_tensor(frames)
    frames, count = pad_to_multiple(frames, mesh.shape[DATA_AXIS], axis=0)
    if spatial:
        space = mesh.shape[SPACE_AXIS]
        if frames.shape[1] % space:
            raise ValueError(
                f"Frame height {frames.shape[1]} must divide the spatial "
                f"axis size {space}.")
    return frame_sharding(mesh, spatial).place(frames), count


def _assemble(blocks: list[torch.Tensor], mesh: Mesh,
              count: int) -> torch.Tensor:
    """This process's graded blocks, in order, on the lead device; on a
    mesh that spans processes, every rank's blocks all-gathered."""
    out = torch.cat([block.to(mesh.lead) for block in blocks])
    if mesh.spans_processes:
        out = all_gather_rows(out)
    return out[:count]


def _operands(config, mesh: Mesh, **sources) -> dict:
    from ..ops.grade import prepare_operands

    return {device: prepare_operands(config, device=device, **sources)
            for device in replicated(mesh)}


def grade_on_mesh(frames: torch.Tensor, config, mesh: Mesh, *, lut=None,
                  reference=None, ref_stats=None, frame_start: int = 0,
                  spatial: bool = False) -> torch.Tensor:
    """Run the grade stack over a mesh-sharded clip.

    Output is bit-identical to the single-device
    :func:`vrgdg_tpu_torch.ops.grade.grade` for frame-axis sharding
    (per-frame seeded grain makes shard boundaries invisible); spatially
    sharded runs match to float tolerance (the colour-match statistics
    reduce in another order).  The result lies on this process's first
    mesh device.
    """
    from ..ops.grade import grade_prepared

    if config.fused_mode == "fused" and spatial:
        raise ValueError(
            "fused_mode='fused' supports frame-axis data parallelism only "
            "(its kernels work on whole frames); use spatial=False or the "
            "default 'eager' fused mode.")
    if (config.fused_mode != "fused" and config.grain_mode == "kernel"
            and config.grain is not None):
        # as the JAX package refuses grain_mode='pallas' on a mesh
        raise ValueError(
            "grain_mode='kernel' is not supported on mesh-sharded grades; "
            "use the default 'eager' mode (bit-identical across shard "
            "boundaries).")
    if not config.any_enabled:
        return frames
    shards, count = shard_clip(frames, mesh, spatial)
    operands = _operands(config, mesh, lut=lut, reference=reference,
                         ref_stats=ref_stats)
    per = shards[0].tiles[0].shape[0] if spatial else shards[0].shape[0]
    blocks = []
    for row_index, shard in enumerate(shards):
        start = int(frame_start) + (mesh.first_row + row_index) * per
        if spatial:
            blocks.append(grade_rows(shard, config, operands,
                                     start).gather(mesh.lead))
        else:
            # grade_prepared runs the fused mode through _run_fused
            blocks.append(grade_prepared(shard, config,
                                         *operands[shard.device],
                                         frame_start=start))
    return _assemble(blocks, mesh, count)
