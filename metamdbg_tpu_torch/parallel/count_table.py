"""Sharded k-min-mer count table over a group of ranks (K5).

The port of metamdbg_tpu/parallel/count_table.py, the replacement for the
reference's hash-sharded disk partitions (KminmerCounter,
src/graph/CreateMdbg.hpp:3591-3883): each rank takes its contiguous block
of reads, hashes every normalized k-window (kernel KW, through
count/kminmers.flat_window_hashes), sends each key to the rank that owns
it, (h1 >> 32) mod world as in the JAX package, and each rank sorts and
run-length counts the keys it owns. Every rank's shard is then gathered to
every rank.

Where the JAX package counts per-destination traffic, takes the maximum
over devices and fills padded buckets of that capacity (XLA needs static
shapes), the ranks here exchange their exact split sizes and then the
rows, unpadded (parallel/multihost.route); its `overflow == 0` invariant
is route's check that every rank received what the others sent.
"""

import torch

from . import multihost, record

_U32 = 0xFFFFFFFF


def owner(h1: torch.Tensor, world: int) -> torch.Tensor:
    """The rank owning each key: its high hash word mod world."""
    return ((h1 >> 32) & _U32) % world


def sort_count(h1: torch.Tensor, h2: torch.Tensor):
    """Unique (h1, h2) keys in unsigned order, and how often each occurs
    (the JAX package's _local_sort_count)."""
    from ..count.kminmers import pair_heads, sort_pairs
    order = sort_pairs(h1, h2)
    h1, h2 = h1[order], h2[order]
    head = pair_heads(h1, h2)
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([h1.shape[0]])])
    return h1[head], h2[head], ends - starts


def count_table(reads, k: int, device, group, timer=None):
    """Count every k-min-mer of `reads` (host u32 minimizer arrays, the
    same list on every rank) over `group`.

    Returns (h1, h2, counts), int64 tensors on `device` holding the u64
    keys' bits and the counts, in unsigned (h1, h2) order: on every rank,
    the table that hashing and grouping all the rows on one device gives.
    `timer` (multihost.steps) times the steps."""
    from ..count.kminmers import flat_window_hashes, sort_pairs
    step = multihost.steps(timer)
    rank, world = multihost.rank_world(group)
    lo, hi = multihost.process_read_range(len(reads), rank, world)
    with step("hash"):
        h1, h2, _ = flat_window_hashes(reads[lo:hi], k, device)
    keys, _ = multihost.route(torch.stack([h1, h2], 1),
                              lambda x: owner(x[:, 0], world), group, timer)
    with step("local sort-count"):
        s1, s2, counts = sort_count(keys[:, 0], keys[:, 1])
    with step("gather"):
        table, _ = multihost.gather_to_hosts(
            torch.stack([s1, s2, counts], 1), group)
    with step("merge"):
        table = table[sort_pairs(table[:, 0], table[:, 1])]
    record("count_table", windows=h1.shape[0], received=keys.shape[0],
           shard_keys=s1.shape[0], keys=table.shape[0])
    return tuple(table[:, j].contiguous() for j in range(3))
