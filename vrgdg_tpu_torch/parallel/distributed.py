"""Multi-process initialization: ``torch.distributed`` wiring + env contract.

Counterpart of :mod:`vrgdg_tpu.parallel.distributed`.  The explicit
settings come from arguments or this environment contract, the same as
the JAX package's:

=====================================  =====================================
Environment variable                   Meaning
=====================================  =====================================
``VRGDG_TPU_COORDINATOR``              ``host:port`` of process 0's
                                       rendezvous (its TCP store)
``VRGDG_TPU_NUM_PROCESSES``            total process count in the job
``VRGDG_TPU_PROCESS_ID``               this process's rank, 0-based
``VRGDG_TPU_LOCAL_DEVICE_IDS``         optional comma list restricting
                                       which cards this process owns
                                       (e.g. ``0,1``)
=====================================  =====================================

With none of the three set, :func:`initialize_distributed` reads
torchrun's ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) instead of the TPU metadata server.  The process
group uses NCCL when this process's device is a card and gloo on the CPU.
Afterwards :func:`vrgdg_tpu_torch.parallel.make_mesh` builds meshes whose
data axis spans the processes: rank ``r``'s devices carry the data rows
after those of ranks ``0 .. r-1``, as ``jax.devices()`` orders them.

``python -m vrgdg_tpu_torch.parallel`` checks it across processes
(:mod:`vrgdg_tpu_torch.parallel.__main__`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_INITIALIZED = False
_LOCAL_DEVICE_IDS: list[int] | None = None

ENV_COORDINATOR = "VRGDG_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "VRGDG_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "VRGDG_TPU_PROCESS_ID"
ENV_LOCAL_DEVICE_IDS = "VRGDG_TPU_LOCAL_DEVICE_IDS"


def distributed_config(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       local_device_ids=None,
                       environ=None) -> dict:
    """Resolve the initialize() kwargs from arguments, falling back to the
    env contract above.  Pure (injectable ``environ``) so it is unit
    testable without a cluster."""
    env = os.environ if environ is None else environ

    def pick(value, key, convert=str):
        if value is not None:
            return value
        raw = env.get(key)
        if raw is None or str(raw).strip() == "":
            return None
        return convert(str(raw).strip())

    config: dict = {}
    coordinator = pick(coordinator_address, ENV_COORDINATOR)
    if coordinator:
        config["coordinator_address"] = coordinator
    count = pick(num_processes, ENV_NUM_PROCESSES, int)
    if count is not None:
        config["num_processes"] = int(count)
    rank = pick(process_id, ENV_PROCESS_ID, int)
    if rank is not None:
        config["process_id"] = int(rank)
    ids = local_device_ids
    if ids is None:
        raw = env.get(ENV_LOCAL_DEVICE_IDS)
        if raw and str(raw).strip():
            ids = [int(part) for part in str(raw).split(",") if part.strip()]
    if ids is not None:
        config["local_device_ids"] = list(ids)

    explicit = {"coordinator_address", "num_processes", "process_id"}
    given = explicit.intersection(config)
    if given and given != explicit:
        missing = sorted(explicit - given)
        raise ValueError(
            "Incomplete multi-host configuration: "
            f"{', '.join(sorted(given))} set but {', '.join(missing)} "
            f"missing. Set all three (or none, for TPU-metadata "
            "autodiscovery).")
    return config


def local_devices() -> list[torch.device]:
    """This process's own cards: the ``local_device_ids`` given to
    :func:`initialize_distributed`, else ``VRGDG_TPU_LOCAL_DEVICE_IDS``,
    else every visible card (none on a machine without one).  A list that
    names a card twice or one that is not visible is refused."""
    count = torch.cuda.device_count()
    ids = _LOCAL_DEVICE_IDS
    if ids is None:
        ids = distributed_config().get("local_device_ids")
    if ids is None:
        return [torch.device("cuda", i) for i in range(count)]
    if len(set(ids)) != len(ids) or any(not 0 <= i < count for i in ids):
        raise ValueError(f"local device ids {list(ids)} must name distinct "
                         f"cards among the {count} visible")
    return [torch.device("cuda", int(i)) for i in ids]


def _group_summary() -> dict:
    if dist.is_available() and dist.is_initialized():
        return {"process_index": dist.get_rank(),
                "process_count": dist.get_world_size(),
                "backend": str(dist.get_backend())}
    return {"process_index": 0, "process_count": 1, "backend": None}


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, *,
                           _initialize=None) -> dict:
    """Create this process's ``torch.distributed`` group once and return
    a summary ``{"initialized", "config", "process_index",
    "process_count", "backend"}``.

    The group meets at ``tcp://<coordinator>`` with the configured world
    size and rank, or through ``env://`` when none is configured.  Its
    backend is NCCL when a card is visible (the process then works on the
    first of its ``local_device_ids``, or the card ``rank % cards``) and
    gloo otherwise.  Idempotent: repeat calls return the existing state.
    ``_initialize`` is an injection point for tests, called with
    ``init_process_group``'s keyword arguments."""
    global _INITIALIZED, _LOCAL_DEVICE_IDS

    config = distributed_config(coordinator_address, num_processes,
                                process_id, local_device_ids)
    if _INITIALIZED or (dist.is_available() and dist.is_initialized()):
        return {"initialized": False, "already": True, "config": config,
                **_group_summary()}
    kwargs: dict = {}
    if "coordinator_address" in config:
        kwargs = {"init_method": f"tcp://{config['coordinator_address']}",
                  "world_size": config["num_processes"],
                  "rank": config["process_id"]}
    else:
        kwargs = {"init_method": "env://"}
    _LOCAL_DEVICE_IDS = config.get("local_device_ids")
    cards = local_devices() if torch.cuda.is_available() else []
    if cards:
        rank = config.get("process_id", int(os.environ.get("RANK", 0)))
        card = cards[0] if _LOCAL_DEVICE_IDS else cards[rank % len(cards)]
        torch.cuda.set_device(card)
        kwargs["backend"] = "nccl"
    else:
        kwargs["backend"] = "gloo"
    init = _initialize if _initialize is not None \
        else dist.init_process_group
    init(**kwargs)
    _INITIALIZED = True
    return {"initialized": True, "config": config, **_group_summary(),
            "backend": kwargs["backend"]}


def shutdown_distributed() -> None:
    """Destroy the process group, if any, so a later
    :func:`initialize_distributed` starts a new one."""
    global _INITIALIZED, _LOCAL_DEVICE_IDS
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False
    _LOCAL_DEVICE_IDS = None


def all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` block concatenated along dim 0, in rank
    order, on ``local``'s device (a card for NCCL, the CPU for gloo)."""
    world = dist.get_world_size()
    out = local.new_empty((world * local.shape[0], *local.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, local.contiguous())
    return out
