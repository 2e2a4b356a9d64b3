"""The port's multi-process layer (vrgdg_tpu_torch.parallel.distributed and
the enhancer's segment scheduler) on the CPU, against vrgdg_tpu.

``distributed_config`` must resolve the same settings as the JAX
package's from the same arguments and environments.  The multi-process
checks run real subprocesses: two gloo ranks that grade a frame-sharded
clip over a global mesh and all-gather it (bit-identical to one device on
both ranks), and two ``enhance --shard-index`` command-line workers whose
joined output must equal a one-process ``render_job``'s byte for byte.
Every subprocess is waited on with a timeout; ports are picked free by
binding port 0.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vrgdg_tpu.parallel import distributed as jdist
from vrgdg_tpu_torch.entry import SCHEDULER_SETTINGS, run_scheduler_workers
from vrgdg_tpu_torch.jobs import enhancer
from vrgdg_tpu_torch.parallel import distributed as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """Jobs decode on a cv2 thread beside torch's OpenMP pool; one thread
    keeps a tiny segment fast, here and in the worker processes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> str:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return str(probe.getsockname()[1])


def _write_clip(path, frames, size=(48, 32), fps=12.0, seed=3, zeros=False):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, size)
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        frame = (np.zeros((size[1], size[0], 3), np.uint8) if zeros else
                 rng.integers(0, 255, (size[1], size[0], 3), np.uint8))
        writer.write(frame)
    writer.release()
    return str(path)


# --------------------------------------------------------------------------
# the configuration contract
# --------------------------------------------------------------------------

CONFIG_CASES = {
    "empty": dict(environ={}),
    "args": dict(args=("10.0.0.1:8476", 4, 2, [0, 1]), environ={}),
    "env": dict(environ={
        jdist.ENV_COORDINATOR: "coord:1234", jdist.ENV_NUM_PROCESSES: "8",
        jdist.ENV_PROCESS_ID: "3", jdist.ENV_LOCAL_DEVICE_IDS: "0, 2"}),
    "args_override_env": dict(args=("arg:9",), environ={
        jdist.ENV_COORDINATOR: "env:1", jdist.ENV_NUM_PROCESSES: "2",
        jdist.ENV_PROCESS_ID: "1"}),
    "blank_env": dict(environ={jdist.ENV_COORDINATOR: " ",
                               jdist.ENV_LOCAL_DEVICE_IDS: ""}),
    "ids_only": dict(environ={jdist.ENV_LOCAL_DEVICE_IDS: "3"}),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_distributed_config_matches_jax(case):
    args = CONFIG_CASES[case].get("args", ())
    environ = CONFIG_CASES[case]["environ"]
    assert tdist.distributed_config(*args, environ=environ) == \
        jdist.distributed_config(*args, environ=environ)


@pytest.mark.parametrize("kwargs", [
    dict(coordinator_address="x:1"),
    dict(num_processes=2, process_id=0),
])
def test_incomplete_config_rejected_as_in_jax(kwargs):
    with pytest.raises(ValueError, match="Incomplete multi-host") as ours:
        tdist.distributed_config(environ={}, **kwargs)
    with pytest.raises(ValueError) as theirs:
        jdist.distributed_config(environ={}, **kwargs)
    assert str(ours.value) == str(theirs.value)


def test_env_names_are_the_jax_contract():
    assert (tdist.ENV_COORDINATOR, tdist.ENV_NUM_PROCESSES,
            tdist.ENV_PROCESS_ID, tdist.ENV_LOCAL_DEVICE_IDS) == (
        jdist.ENV_COORDINATOR, jdist.ENV_NUM_PROCESSES,
        jdist.ENV_PROCESS_ID, jdist.ENV_LOCAL_DEVICE_IDS)


def test_initialize_passes_config_and_is_idempotent(monkeypatch):
    monkeypatch.setattr(tdist, "_INITIALIZED", False)
    monkeypatch.setattr(tdist, "_LOCAL_DEVICE_IDS", None)
    calls = []
    monkeypatch.setenv(tdist.ENV_COORDINATOR, "c:1")
    monkeypatch.setenv(tdist.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(tdist.ENV_PROCESS_ID, "0")
    monkeypatch.delenv(tdist.ENV_LOCAL_DEVICE_IDS, raising=False)
    result = tdist.initialize_distributed(
        _initialize=lambda **kwargs: calls.append(kwargs))
    assert result["initialized"] is True and result["backend"] == "gloo"
    assert calls == [{"init_method": "tcp://c:1", "world_size": 2,
                      "rank": 0, "backend": "gloo"}]
    assert result["config"] == {"coordinator_address": "c:1",
                                "num_processes": 2, "process_id": 0}
    assert (result["process_index"], result["process_count"]) == (0, 1)
    again = tdist.initialize_distributed(
        _initialize=lambda **kwargs: calls.append(kwargs))
    assert again["initialized"] is False and again["already"] is True
    assert len(calls) == 1


def test_initialize_without_config_uses_env_rendezvous(monkeypatch):
    monkeypatch.setattr(tdist, "_INITIALIZED", False)
    monkeypatch.setattr(tdist, "_LOCAL_DEVICE_IDS", None)
    for key in (tdist.ENV_COORDINATOR, tdist.ENV_NUM_PROCESSES,
                tdist.ENV_PROCESS_ID, tdist.ENV_LOCAL_DEVICE_IDS):
        monkeypatch.delenv(key, raising=False)
    calls = []
    tdist.initialize_distributed(
        _initialize=lambda **kwargs: calls.append(kwargs))
    assert calls == [{"init_method": "env://", "backend": "gloo"}]


# --------------------------------------------------------------------------
# two gloo ranks: a global frame-sharded grade, all-gathered
# --------------------------------------------------------------------------

def test_two_process_global_grade_is_all_gathered_bit_identical():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vrgdg_tpu_torch.parallel",
         f"127.0.0.1:{port}", "2", str(rank), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for rank in (0, 1)]
    outputs = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=180)
            outputs.append(out)
            assert proc.returncode == 0, f"rank{rank} failed:\n{out[-2000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank in (0, 1):
        assert (f"rank{rank} GRADE OK shape=(8, 12, 16, 3) backend=gloo "
                "data_axis=4") in outputs[rank]


# --------------------------------------------------------------------------
# the segment scheduler
# --------------------------------------------------------------------------

def test_two_process_segment_scheduler_byte_identical(tmp_path):
    """Two ``enhance --shard-index`` workers render segments i::2 of a
    20 s clip (4 segments) into one job folder; rank 0's joined output
    equals a one-process render_job's byte for byte."""
    source = _write_clip(tmp_path / "clip.mp4", 240, size=(64, 48))
    final = run_scheduler_workers(source, str(tmp_path / "dist"), "cpu",
                                  timeout=240)
    assert final["status"] == "complete"
    assert final["process_count"] == 2 and final["total_segments"] == 4
    registry = enhancer.JobRegistry()
    enhancer.render_job("single_job",
                        {"source_path": source,
                         "settings": dict(SCHEDULER_SETTINGS)},
                        registry=registry,
                        base_folder=str(tmp_path / "single"), device="cpu")
    snap = registry.snapshot("single_job")
    assert snap["status"] == "complete", snap.get("error")
    with open(final["output_path"], "rb") as a, \
            open(snap["output_path"], "rb") as b:
        assert a.read() == b.read()


def test_rank0_times_out_on_a_missing_worker(tmp_path):
    source = _write_clip(tmp_path / "clip.mp4", 120, zeros=True)
    with pytest.raises(TimeoutError, match=r"segments \[1\]"):
        enhancer.render_job_shards(
            "half_job", {"source_path": source,
                         "settings": dict(SCHEDULER_SETTINGS)},
            0, 2, registry=enhancer.JobRegistry(),
            base_folder=str(tmp_path / "base"), wait_timeout=1.5,
            device="cpu")


def test_scheduler_refuses_a_fingerprint_mismatch(tmp_path):
    source = _write_clip(tmp_path / "clip.mp4", 60, zeros=True)
    base = str(tmp_path / "base")
    done = enhancer.render_job_shards(
        "fpj", {"source_path": source, "settings": dict(SCHEDULER_SETTINGS)},
        0, 1, registry=enhancer.JobRegistry(), base_folder=base,
        device="cpu")
    assert done["status"] == "complete"
    manifest = json.load(open(os.path.join(
        enhancer.jobs_folder(base), "fpj", "manifest.json")))
    assert manifest["status"] == "complete"
    changed = dict(SCHEDULER_SETTINGS, sharpen_strength=9.0)
    with pytest.raises(ValueError, match="cannot resume"):
        enhancer.render_job_shards(
            "fpj", {"source_path": source, "settings": changed},
            0, 1, registry=enhancer.JobRegistry(), base_folder=base,
            device="cpu")


def test_scheduler_rejects_inconsistent_ranks(tmp_path):
    with pytest.raises(ValueError, match="inconsistent"):
        enhancer.render_job_shards("x", {}, 2, 2, base_folder=str(tmp_path),
                                   device="cpu")


def test_cli_has_the_shard_flags():
    help_text = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "enhance", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO}, check=True).stdout
    for flag in ("--distributed", "--shard-index", "--shard-count",
                 "--job-id", "--shard-stall-timeout", "--device"):
        assert flag in help_text
