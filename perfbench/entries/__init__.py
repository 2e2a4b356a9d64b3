"""Entries: the calls of ``vrgdg_tpu_torch`` that a cell's window drives.

An entry module defines ``Entry(config, mix, inputs, device, generator, root)``
with ``frame_out`` (the output frames' height and width), ``warm_lengths()``
(the clips set-up runs) and
``run_clip(clip, sink, sync_setup)``, which hands every uint8 output
batch to ``sink`` in frame order and returns ``setup_ms``, ``device_ms``,
``frames`` and ``batches``.
"""


def launch_counts() -> dict:
    """The program's count of each hand-written kernel's launches."""
    from vrgdg_tpu_torch.kernels.build import LAUNCHES

    return {name: count for name, count in LAUNCHES.items() if count}
