"""Rank-local inputs and the exchanges of the sharded stages.

The port of metamdbg_tpu/parallel/multihost.py. Contract for a run of N
ranks (METAMDBG_TPU_DISTRIBUTED=1, parallel/__init__.py): every rank calls
the same pipeline on the same reads; a sharded stage takes this rank's
contiguous block of rows (`process_read_range`), sends each row to the
rank that owns it (`route`: exact split sizes, no negotiated capacity),
and brings every rank's shard back to every rank (`gather_to_hosts`).

NCCL takes CUDA tensors only, and gloo is not relied on to take them: the
tensors go to the transport's device (the host under gloo, the rank's card
under nccl) right before each collective and come back after it.
"""

import contextlib

import torch
import torch.distributed as dist

# the name of all_gather_into_tensor since torch 2.13
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def process_read_range(n_total: int, rank: int, world: int):
    """Contiguous [start, stop) slice of n_total rows owned by `rank` of
    `world` (the JAX package's per-process read range)."""
    per = (n_total + world - 1) // world
    start = min(rank * per, n_total)
    return start, min(start + per, n_total)


def rank_world(group):
    return dist.get_rank(group), dist.get_world_size(group)


def wire_device(group) -> torch.device:
    """Where the transport takes its tensors: the host for gloo, this
    rank's card for nccl."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def steps(timer):
    """`timer(name)` gives a context manager around one step of a sharded
    function (chip_smoke.py times the steps with CUDA events); none by
    default."""
    return timer or (lambda name: contextlib.nullcontext())


def route(x: torch.Tensor, owner, group, timer=None):
    """Send each row of x (n, c) to the rank `owner(x)` names; returns the
    rows this rank received (in source-rank order, each source's rows in
    their order in its x) on x's device, and the rows sent to each rank.

    The split sizes are exchanged first (a world-long all_to_all), then
    the rows, unpadded. Raises RuntimeError unless every received row is
    this rank's and the ranks received, together, what they sent."""
    step = steps(timer)
    rank, world = rank_world(group)
    wd = wire_device(group)
    with step("route"):
        dest = owner(x)
        order = torch.sort(dest, stable=True).indices
        x = x[order]
        send = torch.bincount(dest, minlength=world)
    with step("split exchange"):
        recv = torch.empty(world, dtype=torch.int64, device=wd)
        dist.all_to_all_single(recv, send.to(wd), group=group)
        send_sizes, recv_sizes = send.tolist(), recv.tolist()
    with step("row exchange"):
        out = torch.empty((sum(recv_sizes), *x.shape[1:]), dtype=x.dtype,
                          device=wd)
        dist.all_to_all_single(out, x.to(wd).contiguous(), recv_sizes,
                               send_sizes, group=group)
        out = out.to(x.device)
        totals = torch.tensor([x.shape[0], out.shape[0]], device=wd)
        dist.all_reduce(totals, group=group)
    if int(totals[0]) != int(totals[1]) or \
            bool((owner(out) != rank).any()):
        raise RuntimeError(
            f"rank {rank}: the exchange lost or misrouted rows ({int(totals[0])} "
            f"sent, {int(totals[1])} received over {world} ranks)")
    return out, send_sizes


def gather_to_hosts(x: torch.Tensor, group):
    """Every rank's x (n_r, ...) concatenated in rank order, on every rank,
    on x's device; and the list of n_r. An all_gather of variable length:
    the lengths first, then the rows padded to the longest."""
    _, world = rank_world(group)
    wd = wire_device(group)
    lens = torch.empty(world, dtype=torch.int64, device=wd)
    _all_gather(lens, torch.tensor([x.shape[0]], device=wd), group=group)
    lens = lens.tolist()
    longest = max(max(lens), 1)
    pad = torch.zeros((longest, *x.shape[1:]), dtype=x.dtype, device=wd)
    pad[:x.shape[0]] = x.to(wd)
    out = torch.empty((world * longest, *x.shape[1:]), dtype=x.dtype,
                      device=wd)
    _all_gather(out, pad, group=group)
    out = out.view(world, longest, *x.shape[1:])
    return torch.cat([out[r, :n] for r, n in enumerate(lens)]).to(
        x.device), lens
