"""Multi-GPU runs on torch.distributed.

The port of metamdbg_tpu/parallel/__init__.py. The reference has no
distributed runtime (OpenMP and disk partitions only); here scale-out is a
group of ranks, one process each, with three sharded stages:
- the correction mapper's pair join (pair_join.py, K6);
- the first pass's count table (count_table.py, K5);
- toBasespace's windowed-POA fan-out (polish_mesh.py).

Launch contract (multihost.py): every rank runs the same pipeline on the
same reads and writes the same files into its own --out-dir. The ranks
find each other through the JAX package's own variables:
- METAMDBG_TPU_DISTRIBUTED: set to start a group at all;
- METAMDBG_TPU_COORDINATOR (host:port), METAMDBG_TPU_NUM_PROCESSES and
  METAMDBG_TPU_PROCESS_ID: the rendezvous, world size and rank; without a
  coordinator the group starts from `env://` (MASTER_ADDR, MASTER_PORT,
  WORLD_SIZE and RANK, as torchrun sets them);
- METAMDBG_TPU_DIST_BACKEND: `gloo` or `nccl`, the transport. The default
  is nccl on cuda and gloo on cpu; gloo on cuda lets ranks share one card
  (NCCL puts no two ranks of one communicator on the same GPU). It
  chooses the transport only, never a result.

`production_group()` is the one gate the pipeline uses to decide whether a
stage runs sharded, as `production_mesh()` is in the JAX package.
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("metamdbg_tpu_torch")

# a collective that one rank never enters fails after this, not hangs
TIMEOUT = datetime.timedelta(minutes=5)

# what each sharded function did in this process: name -> counters,
# `calls` included (pipeline/asm.py writes the per-stage differences into
# tmp/device.json)
activity: dict = {}


def record(name: str, **counts):
    entry = activity.setdefault(name, {"calls": 0})
    entry["calls"] += 1
    for key, value in counts.items():
        entry[key] = entry.get(key, 0) + int(value)


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def ensure_distributed(device) -> torch.device:
    """Start the process group when METAMDBG_TPU_DISTRIBUTED is set, and
    return the device this rank runs on: cuda:(rank % device count) on
    cuda, made current before the group starts. Idempotent; without the
    variable it returns `device` and starts nothing. A group that fails to
    start raises."""
    device = torch.device(device)
    if not os.environ.get("METAMDBG_TPU_DISTRIBUTED"):
        return device
    if dist.is_initialized():
        return _rank_device(device)
    backend = os.environ.get("METAMDBG_TPU_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend not in ("gloo", "nccl") or (backend == "nccl"
                                           and device.type != "cuda"):
        raise ValueError(f"METAMDBG_TPU_DIST_BACKEND={backend} on "
                         f"{device.type}: use gloo, or nccl on cuda")
    coord = os.environ.get("METAMDBG_TPU_COORDINATOR")
    if coord:
        rank = int(os.environ["METAMDBG_TPU_PROCESS_ID"])
        init = dict(init_method=f"tcp://{coord}", rank=rank,
                    world_size=int(os.environ["METAMDBG_TPU_NUM_PROCESSES"]))
    else:
        rank = int(os.environ["RANK"])
        init = dict(init_method="env://")
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, timeout=TIMEOUT, **init)
    log.info("torch.distributed up: rank %d of %d over %s on %s",
             dist.get_rank(), dist.get_world_size(), backend, device)
    return device


def production_group():
    """The group production stages shard over, or None: the default group
    when two or more ranks are up."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() >= 2:
        return dist.group.WORLD
    return None


def describe() -> dict:
    """rank, world_size and transport of the default group (world 1 and no
    transport without one)."""
    if not (dist.is_available() and dist.is_initialized()):
        return {"rank": 0, "world_size": 1, "transport": None}
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "transport": dist.get_backend()}


def shutdown():
    """Tear the default group down, where one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
