"""All-vs-all minimizer-pair read mapping (correction stage 1).

The port of metamdbg_tpu/correction/mapper.py, after ReadMapper
(src/readSelection/ReadMapper.hpp:9-1428):

- reads are chunked by total minimizer count (ReadMapper.hpp:191-193,
  Commons.hpp:7682-7686); each chunk's minimizer *pairs* (2-min-mers packed
  to u64, centre position = (pos[i]+pos[i+1])/2) form a sorted table;
- every read of >= 10 minimizers is matched against the table
  (ReadMapper.hpp:668-845): anchors grouped per target read, chained with
  the banded DP (band = 2500*density_correction, w=20), chain score =
  nbMatches - nbDifferences;
- per matched position of the read, the best `usedCoverage` (20) target
  reads are kept (score desc, read index asc; ReadMapper.hpp:1233-1313),
  the union over positions is the read's aligned set;
- chunk results merge by recomputing scores from the match positions
  (ReadMapper.hpp:218-443) and re-selecting, then the final per-read sorted
  aligned-read lists are written to readAlignmentsLowDensity.bin
  ({u32 ref, u32 n, u32 query[n]}, ReadMapper.hpp:1391-1426).

The JAX package walks the query reads one by one on the host. Here a
chunk's work is one set of tensors on `device`: every query pair's table
range (searchsorted on the sign-flipped packed pairs, so that int64 order
is u64 order), the anchors in the JAX package's order (gather order, then
stable sorts by (query read, target read, ref, query)), one launch of
kernel K4 (kernels/chain_dp.py) over all of the chunk's groups, and the
per-position selection as stable sorts. Groups of fewer than 3 anchors are
not chained (ReadMapper.hpp:850). Over a group of ranks the join runs
sharded (parallel/pair_join.py, K6): the same ranges, in the same order.
"""

import struct

import numpy as np
import torch

from ..basespace.chaining import normalized_pairs
from ..kernels import chain_dp as k4

USED_COVERAGE_FOR_CORRECTION = 20   # ReadCorrection.hpp:1728
MIN_READ_MINIMIZERS = 10            # Commons.hpp:2190 isReadTooShort
_SIGN = -(1 << 63)


def read_pairs(read):
    """(packed u64 pairs, center positions i64, is_reversed bool) of a read
    (ReadMapper.hpp:475-499)."""
    packed, is_rev = normalized_pairs(read.minimizers)
    if packed.shape[0] == 0:
        return packed, np.zeros(0, np.int64), is_rev
    pos = read.positions.astype(np.int64)
    centers = (pos[:-1] + pos[1:]) // 2
    return packed, centers, is_rev


def _stable_order(keys, n):
    """Lexicographic stable order of n items by `keys`, most significant
    first (successive stable sorts from the least significant key)."""
    order = torch.arange(n, device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _run_starts(*keys):
    """Boolean mask of the items where any of the sorted keys changes."""
    n = keys[0].shape[0]
    head = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    if n > 1:
        change = torch.zeros(n - 1, dtype=torch.bool, device=keys[0].device)
        for key in keys:
            change |= key[1:] != key[:-1]
        head[1:] = change
    return head


def _select(read, tgt, score, counts, positions, used_coverage: int):
    """Per read, per position, the best `used_coverage` entries by (score
    desc, target asc), multiset semantics (ReadMapper.hpp:1259-1310), for
    many reads at once. Entries e are (read[e], tgt[e], score[e]) with
    counts[e] positions, concatenated in `positions`. Returns the mask of
    the entries whose target read a kept position selected."""
    n_e = read.shape[0]
    dev = read.device
    if n_e == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    entry = torch.repeat_interleave(torch.arange(n_e, device=dev), counts)
    pos = positions.to(torch.int64)
    order = _stable_order([read[entry], pos, -score[entry], tgt[entry]],
                          entry.shape[0])
    r_s, p_s = read[entry][order], pos[order]
    head = _run_starts(r_s, p_s)
    idx = torch.arange(order.shape[0], device=dev)
    group_start = torch.cummax(torch.where(head, idx, 0), 0).values
    keep = idx - group_start < used_coverage
    # each (read, target) pair is one entry, so a kept item selects it
    selected = torch.zeros(n_e, dtype=torch.bool, device=dev)
    selected[entry[order][keep]] = True
    return selected


def run_read_mapper(reads, nb_minimizers_per_chunk: int,
                    max_chaining_band: int, device,
                    used_coverage: int = USED_COVERAGE_FOR_CORRECTION,
                    alignment_path: str | None = None, group=None):
    """reads: list of io.records.MinimizerRead (read_data_init.txt order).

    Returns dict read_index -> np.ndarray of aligned read indexes (sorted,
    u32), and writes readAlignmentsLowDensity.bin to `alignment_path`.
    With `group` (two or more ranks, each holding the same reads), every
    chunk's join runs through the sharded pair join (K6).
    """
    device = torch.device(device)
    pair_data = [read_pairs(r) for r in reads]
    sizes = [r.minimizers.shape[0] for r in reads]

    n_pairs = np.fromiter((p[0].shape[0] for p in pair_data), np.int64,
                          len(reads))
    pair_offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(n_pairs, out=pair_offs[1:])

    def cat(i, dtype):
        parts = [p[i] for p in pair_data]
        return np.concatenate(parts).astype(dtype) if parts \
            else np.zeros(0, dtype)

    pairs = {
        # sign-flipped, so that int64 order is the packed pairs' u64 order
        "key": torch.from_numpy(cat(0, np.uint64).view(np.int64) ^ _SIGN),
        "center": torch.from_numpy(cat(1, np.int64)),
        "rev": torch.from_numpy(cat(2, bool)),
        "read": torch.from_numpy(np.repeat(np.arange(len(reads)), n_pairs)),
        "idx": torch.from_numpy(np.arange(int(pair_offs[-1]))
                                - np.repeat(pair_offs[:-1], n_pairs)),
    }
    pairs = {k: v.to(device) for k, v in pairs.items()}
    # query pairs: those of reads with >= 10 minimizers (ReadMapper's
    # isReadTooShort), in read order
    is_query = torch.from_numpy(np.repeat(
        np.asarray(sizes) >= MIN_READ_MINIMIZERS, n_pairs)).to(device)
    query = {k: v[is_query] for k, v in pairs.items()}

    # chunk boundaries (Commons.hpp:7682-7686): flush before adding a read
    # when the accumulated minimizer count has reached the cap
    chunks = []
    start, cur_size = 0, 0
    for i, n in enumerate(sizes):
        if i > start and cur_size >= nb_minimizers_per_chunk:
            chunks.append((start, i))
            start, cur_size = i, 0
        cur_size += n
    if start < len(sizes):
        chunks.append((start, len(sizes)))

    kept = [_process_chunk(pairs, query, int(pair_offs[lo]),
                           int(pair_offs[hi]), max_chaining_band,
                           used_coverage, group) for lo, hi in chunks]
    kept = [e for e in kept if e is not None]

    result: dict[int, np.ndarray] = {}
    if kept:
        # merge phase: recompute scores from the ascending match positions,
        # n - ((p[-1] - p[0]) - (n - 1)) (ReadMapper.hpp:376-382), and
        # re-select
        read, tgt, counts, positions = (torch.cat(x) for x in zip(*kept))
        ends = torch.cumsum(counts, 0)
        p64 = positions.to(torch.int64)
        score = 2 * counts - 1 - (p64[ends - 1] - p64[ends - counts])
        selected = _select(read, tgt, score, counts, positions,
                           used_coverage)
        n = len(reads)
        pairs_sel = torch.unique(read[selected] * n + tgt[selected]).cpu()
        sel_read = (pairs_sel // n).numpy()
        sel_tgt = (pairs_sel % n).numpy().astype(np.uint32)
        bounds = np.flatnonzero(np.diff(sel_read)) + 1
        for part_r, part_t in zip(np.split(sel_read, bounds),
                                  np.split(sel_tgt, bounds)):
            result[int(part_r[0])] = part_t
    if alignment_path is not None:
        with open(alignment_path, "wb") as f:
            for read_index in sorted(result):
                sel = result[read_index]
                f.write(struct.pack("<II", read_index, sel.shape[0]))
                f.write(sel.tobytes())
    return result


def _join(pairs, query, t_lo: int, t_hi: int, group):
    """Each query pair's matches among the table pairs [t_lo, t_hi):
    (match count per query pair, matched pair indices in gather order:
    query pair asc, then table index asc)."""
    dev = pairs["key"].device
    if group is not None:
        from ..parallel.pair_join import pair_join
        counts, matches = pair_join(pairs["key"][t_lo:t_hi] ^ _SIGN,
                                    query["key"] ^ _SIGN, group)
        return counts, matches + t_lo
    order = torch.sort(pairs["key"][t_lo:t_hi], stable=True).indices + t_lo
    tbl_key = pairs["key"][order]
    lo = torch.searchsorted(tbl_key, query["key"], right=False)
    hi = torch.searchsorted(tbl_key, query["key"], right=True)
    counts = hi - lo
    total = int(counts.sum())
    first = torch.cumsum(counts, 0) - counts
    return counts, order[(lo - first).repeat_interleave(counts,
                                                        output_size=total)
                         + torch.arange(total, device=dev)]


def _process_chunk(pairs, query, t_lo: int, t_hi: int, band: int,
                   used_coverage: int, group=None):
    """One chunk: the table of pairs [t_lo, t_hi) against every query
    pair. Returns the entries its selection keeps, (read, target,
    position count, positions), or None."""
    dev = pairs["key"].device
    if t_hi == t_lo or query["key"].numel() == 0:
        return None
    counts, j = _join(pairs, query, t_lo, t_hi, group)
    if j.numel() == 0:
        return None
    # expand ranges into anchors, in gather order: query read asc, query
    # pair asc, table order asc, as the JAX package's per-read loop
    q_sel = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts,
        output_size=j.shape[0])
    q_read, t_read = query["read"][q_sel], pairs["read"][j]
    keep = t_read != q_read
    q_sel, j, q_read, t_read = q_sel[keep], j[keep], q_read[keep], \
        t_read[keep]
    a_ref = pairs["center"][j]
    a_q = query["center"][q_sel]
    a_rev = pairs["rev"][j] != query["rev"][q_sel]
    a_idx = query["idx"][q_sel]

    # sort by (query read, target read, refPos, queryPos), stable over
    # the gather order (ReadMapper.hpp:745-756)
    s = _stable_order([q_read, t_read, a_ref, a_q], q_read.shape[0])
    q_read, t_read, a_ref, a_q, a_rev, a_idx = (
        x[s] for x in (q_read, t_read, a_ref, a_q, a_rev, a_idx))
    head = _run_starts(q_read, t_read)
    group = torch.cumsum(head.to(torch.int64), 0) - 1
    # groups of < 3 anchors cannot chain (ReadMapper.hpp:850)
    long_enough = torch.bincount(group)[group] >= 3
    q_read, t_read, a_ref, a_q, a_rev, a_idx, head = (
        x[long_enough] for x in (q_read, t_read, a_ref, a_q, a_rev, a_idx,
                                 head))
    if q_read.numel() == 0:
        return None
    group = torch.cumsum(head.to(torch.int64), 0) - 1
    starts = torch.nonzero(head).flatten()
    offsets = torch.cat([starts, torch.tensor([q_read.shape[0]],
                                              device=dev)])
    res = k4.chain_dp(a_ref, a_q, a_rev, a_idx.to(torch.int32), offsets,
                      band)

    # entries: the groups whose best chain has >= 3 anchors; each one's
    # positions fill the first chain_len slots of its group (q_idx >= 0)
    ok = res.chain_score != k4.INT32_MIN
    g_read, g_tgt = q_read[starts][ok], t_read[starts][ok]
    g_len = res.chain_len[ok].to(torch.int64)
    positions = res.chain_pos[(res.chain_pos >= 0) & ok[group]]
    selected = _select(g_read, g_tgt, res.chain_score[ok].to(torch.int64),
                       g_len, positions, used_coverage)
    return (g_read[selected], g_tgt[selected], g_len[selected],
            positions[selected.repeat_interleave(g_len)])
