"""Fan-out of the windowed-POA polish stage over a group of ranks.

The port of metamdbg_tpu/parallel/polish_mesh.py. Polish windows are
independent (the reference threads the same per-window loop on one host,
src/toBasespace/ContigPolisher.hpp:2135-2250), so the batch is split
round-robin over the ranks, each rank polishes its share with the native
engine (basespace/poa_native.polish_windows), and the consensus and
coverage results travel as fixed-size planes in an all_gather. The list
comes back in the original batch order, so it is the one-rank result byte
for byte (each window's POA is deterministic).

Without a group of two or more ranks this is poa_native.polish_windows.
"""

import numpy as np
import torch

from . import multihost, record


def shard_indices(n: int, pi: int, pc: int):
    """Round-robin shard of range(n) owned by rank pi of pc."""
    return list(range(pi, n, pc))


def pack_planes(res, n_max: int, w_max: int):
    """[(consensus bytes, coverages u32)] -> fixed (n_max, w_max) planes
    (consensus u8, coverage u32, lengths i64) for a collective exchange."""
    cons_plane = np.zeros((n_max, w_max), np.uint8)
    cov_plane = np.zeros((n_max, w_max), np.uint32)
    lens = np.zeros(n_max, np.int64)
    for i, (cons, covs) in enumerate(res):
        k = len(cons)
        lens[i] = k
        cons_plane[i, :k] = np.frombuffer(cons, np.uint8)
        cov = np.asarray(covs, np.uint32)
        cov_plane[i, :cov.shape[0]] = cov
    return cons_plane, cov_plane, lens


def unpack_planes(n_total: int, pc: int, all_cons, all_cov, all_lens):
    """Gathered (pc, n_max, w_max) planes -> result list in the original
    batch order (inverse of the round-robin shard)."""
    out = []
    for gi in range(n_total):
        p, j = gi % pc, gi // pc
        k = int(all_lens[p, j])
        out.append((all_cons[p, j, :k].tobytes(),
                    np.ascontiguousarray(all_cov[p, j, :k])))
    return out


def polish_windows_distributed(batch, n_threads: int = 1, group=None):
    """poa_native.polish_windows over `group`: [(backbone, frags)] ->
    [(consensus bytes, coverages u32 array)] in batch order, on every
    rank. The batch must be the same on every rank."""
    from ..basespace import poa_native
    if group is None or not batch:
        return poa_native.polish_windows(batch, n_threads=n_threads)
    pi, pc = multihost.rank_world(group)
    if pc == 1:
        return poa_native.polish_windows(batch, n_threads=n_threads)
    mine = [batch[i] for i in shard_indices(len(batch), pi, pc)]
    # 1 window over 2 ranks leaves a rank with none: it still gathers
    res = poa_native.polish_windows(mine, n_threads=n_threads) \
        if mine else []

    # every rank must agree on the pad shape: gather the local dims first
    dims, _ = multihost.gather_to_hosts(torch.tensor(
        [[len(res), max((len(c) for c, _ in res), default=0)]]), group)
    n_max = int(dims[:, 0].max())
    w_max = max(int(dims[:, 1].max()), 1)

    cons, cov, lens = (torch.from_numpy(p) for p in
                       pack_planes(res, n_max, w_max))
    all_cons, _ = multihost.gather_to_hosts(cons, group)
    all_cov, _ = multihost.gather_to_hosts(cov.view(torch.int32), group)
    all_lens, _ = multihost.gather_to_hosts(lens, group)
    record("polish", windows=len(mine), batch=len(batch))
    return unpack_planes(
        len(batch), pc, all_cons.numpy().reshape(pc, n_max, w_max),
        all_cov.numpy().view(np.uint32).reshape(pc, n_max, w_max),
        all_lens.numpy().reshape(pc, n_max))
