"""Nothing the benchmark imports is JAX or the JAX package, compared by the
whole top-level name (``vrgdg_tpu_torch`` begins with ``vrgdg_tpu``); the
reference imports nothing of the program; a run without a card, or
without the program beside it, exits non-zero and prints no result."""

import ast
import os
import shutil
import subprocess
import sys

from perfbench.cells import PACKAGE_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vrgdg_tpu"}


def _imports(path):
    with open(path, encoding="utf-8") as handle:
        tree = ast.parse(handle.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(folder):
    for base, _, names in os.walk(folder):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(PACKAGE_DIR):
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "dataclasses", "os", "numpy",
               "torch"}
    for path in _sources(os.path.join(PACKAGE_DIR, "reference")):
        assert set(_imports(path)) <= allowed, path


def test_a_run_loads_no_jax():
    code = ("import perfbench.run, perfbench.readings, "
            "perfbench.entries.grade_stream, perfbench.entries.enhance_stream;"
            "import vrgdg_tpu_torch.api.appliers, vrgdg_tpu_torch.jobs.enhancer;"
            "from perfbench.run import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", "grade_fused_4k",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_no_program_no_result(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    shutil.copytree(PACKAGE_DIR, bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # a card is pretended, so the run gets as far as the program's import
    code = ("import sys, torch;"
            "torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1;"
            "from perfbench.run import main;"
            "sys.exit(main(['--workload', 'grade_fused_4k', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=bare,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == "", out.stderr
    assert "vrgdg_tpu_torch" in out.stderr
