"""Sharded minimizer-pair table join over a group of ranks (K6).

The port of metamdbg_tpu/parallel/pair_join.py, the sharded twin of
ReadMapper's chunked pair-table join (src/readSelection/ReadMapper.hpp:
632-845, correction/mapper._process_chunk): the table pairs and the query
pairs of a chunk are split into contiguous blocks over the ranks, every
pair goes to the rank owning it, (hi ^ lo) mod world over its two u32
halves as in the JAX package, and each rank joins the queries it owns
against the table pairs it owns. The sorted table slices and the
per-query (first, count) come back to every rank, which expands them into
match lists: the same as np.searchsorted on the stably sorted table.

Both sides travel in one exchange (multihost.route), table rows first in
each rank's block, so a rank receives its table rows in ascending original
index (contiguous blocks, a stable route): one stable sort by pair then
lists equal pairs in that order, as `_join_step`'s lexsort by (pair, tag,
gid) does.
"""

import torch

from . import multihost, record

_U32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def owner(pairs: torch.Tensor, world: int) -> torch.Tensor:
    """The rank owning each u64 pair (int64 bits): hi ^ lo mod world."""
    return (((pairs >> 32) & _U32) ^ (pairs & _U32)) % world


def _empty(nq, device):
    return (torch.zeros(nq, dtype=torch.int64, device=device),
            torch.zeros(0, dtype=torch.int64, device=device))


def pair_join(tbl_pairs: torch.Tensor, query_pairs: torch.Tensor, group,
              timer=None):
    """For each query pair, the ascending indices into `tbl_pairs` of the
    table entries with the same u64 value (both int64 tensors of u64 bits,
    the same on every rank). Returns (counts (nq,), matches (sum counts,)
    in query order), int64 on the inputs' device, on every rank. `timer`
    (multihost.steps) times the steps."""
    dev = tbl_pairs.device
    nt, nq = tbl_pairs.shape[0], query_pairs.shape[0]
    if nt == 0 or nq == 0:  # the same on every rank: no collective waits
        return _empty(nq, dev)
    step = multihost.steps(timer)
    rank, world = multihost.rank_world(group)
    t_lo, t_hi = multihost.process_read_range(nt, rank, world)
    q_lo, q_hi = multihost.process_read_range(nq, rank, world)

    def rows(pairs, lo, hi, tag):
        ar = torch.arange(lo, hi, device=dev)
        return torch.stack([pairs[lo:hi], ar, torch.full_like(ar, tag)], 1)

    got, _ = multihost.route(
        torch.cat([rows(tbl_pairs, t_lo, t_hi, 0),
                   rows(query_pairs, q_lo, q_hi, 1)]),
        lambda x: owner(x[:, 0], world), group, timer)
    with step("local join"):
        is_tbl = got[:, 2] == 0
        t_key, t_gid = got[is_tbl, 0] ^ _SIGN, got[is_tbl, 1]
        q_key, q_gid = got[~is_tbl, 0] ^ _SIGN, got[~is_tbl, 1]
        order = torch.sort(t_key, stable=True).indices
        t_key, t_gid = t_key[order], t_gid[order]
        first = torch.searchsorted(t_key, q_key, right=False)
        count = torch.searchsorted(t_key, q_key, right=True) - first
    with step("gather"):
        t_all, t_lens = multihost.gather_to_hosts(t_gid, group)
        q_all, q_lens = multihost.gather_to_hosts(
            torch.stack([q_gid, first, count], 1), group)
    if q_all.shape[0] != nq:
        raise RuntimeError(f"pair_join: {q_all.shape[0]} of {nq} queries "
                           f"came back")
    with step("expand"):
        t_off = torch.tensor([0] + t_lens[:-1], device=dev).cumsum(0)
        shard = torch.repeat_interleave(
            torch.arange(world, device=dev),
            torch.tensor(q_lens, device=dev), output_size=nq)
        counts = torch.zeros(nq, dtype=torch.int64, device=dev)
        firsts = torch.zeros(nq, dtype=torch.int64, device=dev)
        counts[q_all[:, 0]] = q_all[:, 2]
        firsts[q_all[:, 0]] = q_all[:, 1] + t_off[shard]
        total = int(counts.sum())
        starts = torch.cumsum(counts, 0) - counts
        idx = (torch.repeat_interleave(firsts - starts, counts,
                                       output_size=total)
               + torch.arange(total, device=dev))
        matches = t_all[idx]
    record("pair_join", table=t_hi - t_lo, queries=q_hi - q_lo,
           shard_table=t_key.shape[0], shard_queries=q_key.shape[0],
           matches=total)
    return counts, matches
