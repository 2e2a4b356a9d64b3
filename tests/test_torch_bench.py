"""The port's bench, perf lab and LUT identity check, held against their
JAX originals on the CPU.

``vrgdg_tpu_torch.bench`` is the counterpart of ``bench.py`` and
``vrgdg_tpu_torch.tools.perf_lab`` of ``tools/perf_lab.py``; both
originals are loaded here by path and left as they are.  Checked:

- each of the ten ``build_stack`` configurations equals
  ``from_reference`` of the JAX bench's, and the operands (corner bundle,
  domain, reference LAB statistics) agree;
- each step, with grain at intensity 0, matches the JAX step at
  (2, 16, 24) within 2e-5 (``tests/test_torch_grade.py``'s bound; the
  JAX ``pallas`` configs run in interpret mode); the grain steps are held
  by determinism (the same frame start, the same bits);
- ``frames_for`` is the JAX bench's numpy draw, bit for bit;
- the timed functions raise without a card and ``main`` returns 1;
- ``bench_oracle_cpu`` keeps its original's source but for the import;
- every perf-lab variant matches the JAX lab's ``build_variant`` and the
  port's ``apply_lut`` within 1e-6 on the lab's parity batch;
- ``lut_identity_error`` matches ``vrgdg_tpu.ops.lut``'s within 1e-6.

The run on a card is ``tests/test_torch_cuda.py::
test_bench_runs_small_on_the_card``: this file imports JAX, which the
card's machine does not have.
"""

import dataclasses
import importlib.util
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrgdg_tpu.core import cube as jcube
from vrgdg_tpu.ops import lut as jlut
from vrgdg_tpu_torch import bench
from vrgdg_tpu_torch.core import cube as tcube
from vrgdg_tpu_torch.ops import lut as tlut
from vrgdg_tpu_torch.ops.grade import from_reference
from vrgdg_tpu_torch.tools import perf_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("grain_only", "lut_only", "cm_sharpen", "fused",
        "fused_pallas_grain", "fused_pallas2", "fused_pallas2_adjust",
        "adjust_only", "sharpen_only", "cm_only")
GRAIN_KEYS = ("grain_only", "fused", "fused_pallas_grain", "fused_pallas2",
              "fused_pallas2_adjust")
STEP_SHAPE = (2, 16, 24)


def _load(name: str, relative: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relative))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_BENCH = _load("jax_bench_original", "bench.py")
JAX_LAB = _load("jax_perf_lab_original", os.path.join("tools", "perf_lab.py"))


@pytest.fixture(scope="module")
def jax_stack():
    """Each JAX step's config, operands (as numpy) and ``_grade_impl``,
    read from the closures ``bench.build_stack`` returns."""
    steps, _ = JAX_BENCH.build_stack()
    parts = {}
    for key, fn in steps.items():
        free = inspect.getclosurevars(fn).nonlocals
        operands = tuple(np.asarray(free[name]) for name in
                         ("bundle", "dmin", "dmax", "ref_mean", "ref_std"))
        parts[key] = (free["config"], operands, free["_grade_impl"])
    return parts


@pytest.fixture(scope="module")
def port_operands():
    return bench.stack_operands("cpu")[1]


def _zero_grain(config):
    if config.grain is None:
        return config
    return dataclasses.replace(
        config, grain=dataclasses.replace(config.grain, intensity=0.0))


def test_stack_has_the_jax_keys(jax_stack):
    assert tuple(bench.stack_configs()) == KEYS
    assert set(jax_stack) == set(KEYS)
    assert [c[1] for c in bench.CONFIGS] == [
        "grain_only", "lut_only", "cm_sharpen", "fused",
        "fused_pallas_grain", "fused_pallas2", "fused_pallas2_adjust"]


@pytest.mark.parametrize("key", KEYS)
def test_config_equals_from_reference_of_jax(jax_stack, key):
    config, operands, _ = jax_stack[key]
    port, _ = from_reference(config, lut_table=operands[0],
                             domain_min=operands[1], domain_max=operands[2],
                             ref_mean=operands[3], ref_std=operands[4],
                             device="cpu")
    assert bench.stack_configs()[key] == port
    kernels = bench.expected_kernels(port)
    mode = bench.run_mode(port)
    if port.fused_mode == "fused":
        assert mode == bench.FUSED_MODE
        assert kernels == ("grade_phase1", "grade_phase2")
    elif key == "fused_pallas_grain":
        # an eager stack with a bundle LUT launches lut_apply on a card
        assert kernels == ("lut_apply", "film_grain")
        assert mode == "eager (torch ops, lut_apply and film_grain kernels)"
    elif key in ("lut_only", "fused"):
        assert kernels == ("lut_apply",)
        assert mode == "eager (torch ops, lut_apply kernel)"
    else:
        assert kernels == ()
        assert mode == "eager (torch ops)"


def test_operands_match_jax(jax_stack, port_operands):
    _, operands, _ = jax_stack["fused"]
    bundle, dmin, dmax, ref_mean, ref_std = (t.numpy() for t in port_operands)
    assert np.array_equal(bundle, operands[0])
    assert np.array_equal(dmin, operands[1])
    assert np.array_equal(dmax, operands[2])
    np.testing.assert_allclose(ref_mean.reshape(-1),
                               operands[3].reshape(-1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref_std.reshape(-1),
                               operands[4].reshape(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", KEYS)
def test_step_without_grain_matches_jax(jax_stack, port_operands, key):
    config, operands, grade_impl = jax_stack[key]
    frames = np.random.default_rng(5).uniform(
        0, 1, (*STEP_SHAPE, 3)).astype(np.float32)
    want = np.asarray(grade_impl(
        jnp.asarray(frames), _zero_grain(config),
        *(jnp.asarray(a) for a in operands), jnp.uint32(4 * 3)))
    step = bench.grade_step(_zero_grain(bench.stack_configs()[key]),
                            port_operands)
    got = step(torch.from_numpy(frames), 3).numpy()
    assert got.shape == want.shape == frames.shape
    assert float(np.max(np.abs(got - want))) <= 2e-5


@pytest.mark.parametrize("key", GRAIN_KEYS)
def test_grain_step_is_deterministic(port_operands, key):
    stack = bench.stack_configs()
    assert stack[key].grain.intensity > 0
    step = bench.grade_step(stack[key], port_operands)
    frames = bench.frames_for(*STEP_SHAPE, "cpu")
    first = step(frames, 2)
    assert torch.equal(first, step(frames.clone(), 2))
    assert not torch.equal(first, step(frames, 3))
    assert torch.isfinite(first).all()


def test_frames_for_is_the_jax_draw():
    got = bench.frames_for(*STEP_SHAPE, "cpu")
    want = np.asarray(JAX_BENCH.frames_for(*STEP_SHAPE))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_timed_functions_raise_without_a_card():
    frames = bench.frames_for(1, 4, 4, "cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.chained_time(lambda carry, _: carry, frames, 2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.measure(lambda carry, _: carry, 1, 4, 4, "cpu", 2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.hardware_probes("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.call_overhead("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run("cpu", 2, False)


def test_main_exits_1_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert bench.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert perf_lab.main(["baseline24"]) == 1
    assert perf_lab.main(["nope"]) == 2


def test_bench_oracle_cpu_keeps_its_source():
    want = inspect.getsource(JAX_BENCH.bench_oracle_cpu).replace(
        "from vrgdg_tpu.core.cube import", "from vrgdg_tpu_torch.core.cube import")
    assert inspect.getsource(bench.bench_oracle_cpu) == want


@pytest.mark.parametrize("name", perf_lab.VARIANTS)
def test_perf_lab_variant_matches_jax_and_apply_lut(name):
    small = perf_lab.parity_batch("cpu")
    jax_stage, _ = JAX_LAB.build_variant(name)
    want = np.asarray(jax_stage(jnp.asarray(small.numpy())))
    stage, _ = perf_lab.build_variant(name, "cpu")
    got = stage(small)
    assert got.shape == small.shape
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-6
    assert perf_lab.parity(name, "cpu") < 1e-6


def test_perf_lab_names_equal_the_jax_labs():
    # every name the JAX lab dispatches on, plus the variants it builds by
    # prefix
    source = inspect.getsource(JAX_LAB.main)
    for name in perf_lab.AB:
        assert f'name == "{name}"' in source
    assert set(perf_lab.VARIANTS) >= {"baseline24", "padded32",
                                      "transposed24", "transposed32",
                                      "baseline24_b4", "padded32_b4"}


@pytest.mark.parametrize("which", ["identity", "palette"])
def test_lut_identity_error_matches_jax(which):
    if which == "identity":
        jax_lut, port_lut = jcube.identity_lut(17), tcube.identity_lut(17)
    else:
        jax_lut = jcube.build_palette_lut(bench.PALETTE, 33)
        port_lut = tcube.build_palette_lut(bench.PALETTE, 33)
    want = jlut.lut_identity_error(jax_lut)
    got = tlut.lut_identity_error(port_lut, device="cpu")
    assert abs(got - want) <= 1e-6
    if which == "identity":
        assert got <= 1e-6
    else:
        assert got > 0.1


def test_bench_and_perf_lab_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import vrgdg_tpu_torch.bench, vrgdg_tpu_torch.tools.perf_lab\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'vrgdg_tpu' or "
            "m.startswith('vrgdg_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and "clean" in done.stdout, done.stderr
