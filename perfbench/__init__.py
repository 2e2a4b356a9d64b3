"""The benchmark of ``vrgdg_tpu_torch`` on one NVIDIA card.

``python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own, found by name:

- ``configs/<config>.json``: the stack's settings, its source, the entry
  that drives it, the reference that judges it and the limits of the check;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  generator it names (``traffic/<generator>.py``);
- ``entries/<entry>.py``: which calls of the program the window drives;
- ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``;
- ``reference/<reference>.py``: the plain reference, which imports nothing
  of the program.

Nothing here imports ``jax`` or the JAX package ``vrgdg_tpu``.
"""
