"""k-min-mer extraction and counting, as torch ops on the tensors' device.

The port of metamdbg_tpu/count/kminmers.py (method semantics there):
- a k-min-mer is a window of k consecutive minimizers of a read, made
  canonical as the lexicographic min of it and its reverse;
- counting groups identical k-min-mers (kernel K2, kernels/count.py);
  solid = abundance > 1 (and >= --min-abundance on the first pass);
- rescue: reads whose median solid abundance is <= 10 contribute their
  abundance-1 k-min-mers at count 1, unless the whole read is abundance-1.

Rows are (N, k) int64 tensors of u32 values. 128-bit hash keys are pairs of
int64 tensors (h1, h2) holding the u64 bits; every sort and search on them
flips the sign bit first, so that their order is the unsigned order the
JAX package's uint64 arrays have. `count_kminmers_sharded`, the port of
`count_kminmers_mesh`, counts over a group of ranks through the sharded
count table (parallel/count_table.py, K5).
"""

import logging
import os

import numpy as np
import torch

from ..kernels import count as kcount
from ..kernels import window_hash
from ..kernels.count import SIGN, count_unique_rows, sort_rows_lex
from ..kernels.window_hash import normalize_rows

__all__ = ["count_unique_rows", "normalize_rows", "sort_rows_lex"]


def _empty_rows(k, device):
    return torch.zeros((0, k), dtype=torch.int64, device=device)


def _i64(n, device):
    return torch.zeros(n, dtype=torch.int64, device=device)


def stream(seqs, device):
    """Concatenate host u32 sequences into one int64 tensor on `device`;
    returns (cat, lens) with lens an int64 tensor on `device`."""
    lens = np.fromiter((s.shape[0] for s in seqs), np.int64, len(seqs))
    cat = (np.concatenate(seqs).astype(np.int64) if lens.sum()
           else np.zeros(0, np.int64))
    return (torch.from_numpy(cat).to(device),
            torch.from_numpy(lens).to(device))


def window_starts(lens: torch.Tensor, w: int):
    """Starts, in the concatenated stream, of every w-window lying inside
    one sequence, in sequence then position order; and the window offsets
    per sequence ((n+1,), int64)."""
    nwin = (lens - w + 1).clamp(min=0)
    offsets = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                          device=lens.device)
    torch.cumsum(nwin, 0, out=offsets[1:])
    seq_off = torch.cumsum(lens, 0) - lens
    total = int(offsets[-1])
    seq_of = torch.repeat_interleave(
        torch.arange(lens.shape[0], device=lens.device), nwin,
        output_size=total)
    local = torch.arange(total, device=lens.device) - offsets[:-1][seq_of]
    return seq_off[seq_of] + local, offsets


def flat_window_hashes(seqs, w: int, device):
    """hash128 of every normalized w-window of every host sequence, flat:
    (h1, h2, window offsets per sequence), one KW launch in its segmented
    mode: the offsets come from the host's lengths, and nothing waits for
    the card."""
    segment = window_hash.Segment(window_hash.Stream(seqs), w)
    return window_hash.hash_segments([segment], device)[0]


def batch_extract_kminmers(reads: list, k: int, device):
    """Concatenated normalized windows of many reads (host u32 arrays).

    Returns (rows (N,k), read_ids (N,), is_reversed (N,), read_offsets
    (n_reads+1,)), rows in read order and windows in position order.
    """
    if not reads:
        return (_empty_rows(k, device), _i64(0, device),
                torch.zeros(0, dtype=torch.bool, device=device),
                _i64(1, device))
    cat, lens = stream(reads, device)
    starts, offsets = window_starts(lens, k)
    read_ids = torch.repeat_interleave(
        torch.arange(len(reads), device=device), offsets[1:] - offsets[:-1],
        output_size=starts.shape[0])
    raw = cat[starts[:, None] + torch.arange(k, device=device)]
    rows, revs = normalize_rows(raw)
    return rows, read_ids, revs, offsets


def count_kminmers(reads: list, k: int, device, min_abundance: int = 0,
                   max_table_bytes: int | None = None):
    """First-pass counting + rescue. Returns a dict of tensors:

    - 'solid_rows', 'solid_counts': abundance>1 (>= min_abundance) kminmers
    - 'rescued_rows': abundance-1 kminmers rescued at count 1 (deduplicated)
    - 'all_rows', 'all_counts': the node set of the graph (solid + rescued)
      with per-node abundance (rescued -> 1)

    Memory bound: when the window table (int64 slots) would exceed
    max_table_bytes (default METAMDBG_TPU_COUNT_TABLE_GB, 20 GB), counting
    streams read chunks and merges the per-chunk sorted tables, then replays
    a second chunked pass for the rescue: identical output.
    """
    if max_table_bytes is None:
        max_table_bytes = int(float(os.environ.get(
            "METAMDBG_TPU_COUNT_TABLE_GB", "20")) * (1 << 30))
    est = sum(max(0, m.shape[0] - k + 1) for m in reads) * k * 8
    if est > max_table_bytes:
        return _count_kminmers_bounded(reads, k, device, min_abundance,
                                       max_table_bytes)
    rows, read_ids, _, offsets = batch_extract_kminmers(reads, k, device)
    uniq, counts = count_unique_rows(rows)
    return _assemble_first_pass(rows, read_ids, offsets, uniq, counts, k,
                                min_abundance)


def count_kminmers_sharded(group, reads: list, k: int, device,
                           min_abundance: int = 0):
    """count_kminmers with the abundance table sharded over `group` (two
    or more ranks, each holding the same `reads`).

    The count (hash every window, route each key to its owner, sort and
    count per rank) runs in parallel/count_table.py (K5), the twin of the
    reference's hash-sharded disk partitions
    (src/graph/CreateMdbg.hpp:3714-3883). Each rank keeps the unique rows
    (kminmerData_min.txt needs them) and the rescue, and joins the table's
    counts back by 128-bit hash: the result of count_kminmers."""
    from ..parallel.count_table import count_table
    rows, read_ids, _, offsets = batch_extract_kminmers(reads, k, device)
    if rows.shape[0] == 0:  # the same on every rank: no collective waits
        return count_kminmers(reads, k, device, min_abundance)
    h1, h2, key_counts = count_table(reads, k, device, group)
    uniq, _ = count_unique_rows(rows)
    q1, q2 = window_hash.hash_rows(uniq)
    counts, hit = PairTable(h1, h2, key_counts, presorted=True).lookup(
        q1, q2, 0)
    if not bool(hit.all()):
        raise RuntimeError(
            f"the sharded count table lacks {int((~hit).sum())} of "
            f"{uniq.shape[0]} k-min-mers counted on this rank")
    return _assemble_first_pass(rows, read_ids, offsets, uniq, counts, k,
                                min_abundance)


def _merge_counted(u1, c1, u2, c2):
    """Merge two lex-sorted unique-row tables, summing counts of equal rows."""
    if u1.shape[0] == 0:
        return u2, c2
    if u2.shape[0] == 0:
        return u1, c1
    rows = torch.cat([u1, u2])
    cnt = torch.cat([c1, c2])
    order = sort_rows_lex(rows)
    s, c = rows[order], cnt[order]
    head = kcount.row_heads(s)
    gid = torch.cumsum(head.to(torch.int64), 0) - 1
    summed = torch.zeros(int(gid[-1]) + 1, dtype=torch.int64,
                         device=s.device).index_add_(0, gid, c)
    return s[head], summed


def _iter_read_chunks(reads, k: int, budget_rows: int):
    """Yield read-list chunks whose window totals stay under budget_rows."""
    chunk = []
    n_rows = 0
    for m in reads:
        w = max(0, m.shape[0] - k + 1)
        if chunk and n_rows + w > budget_rows:
            yield chunk
            chunk, n_rows = [], 0
        chunk.append(m)
        n_rows += w
    if chunk:
        yield chunk


def _count_kminmers_bounded(reads, k, device, min_abundance,
                            max_table_bytes):
    budget_rows = max(1, max_table_bytes // (k * 8) // 4)
    log = logging.getLogger("metamdbg_tpu_torch")
    log.info(
        "bounded k-min-mer counting: table budget %.2f GB (%d rows/chunk)",
        max_table_bytes / (1 << 30), budget_rows)
    uniq, counts = _empty_rows(k, device), _i64(0, device)
    n_chunks = 0
    for chunk in _iter_read_chunks(reads, k, budget_rows):
        rows, _, _, _ = batch_extract_kminmers(chunk, k, device)
        u, c = count_unique_rows(rows)
        uniq, counts = _merge_counted(uniq, counts, u, c)
        n_chunks += 1
    log.info("bounded k-min-mer counting: %d chunks", n_chunks)

    solid_rows, solid_counts = _solid(uniq, counts, min_abundance)
    rescued_rows = _empty_rows(k, device)
    if min_abundance <= 1:
        parts = []
        for chunk in _iter_read_chunks(reads, k, budget_rows):
            rows, read_ids, _, offsets = batch_extract_kminmers(chunk, k,
                                                                device)
            if rows.shape[0] == 0:
                continue
            r = _rescue(rows, read_ids, offsets, solid_rows, solid_counts, k)
            if r.shape[0]:
                parts.append(r)
        if parts:
            rescued_rows, _ = count_unique_rows(torch.cat(parts))
    return _with_rescued(solid_rows, solid_counts, rescued_rows)


def _solid(uniq, counts, min_abundance):
    solid = counts > 1
    if min_abundance > 1:
        solid &= counts >= min_abundance
    return uniq[solid], counts[solid]


def _with_rescued(solid_rows, solid_counts, rescued_rows):
    if rescued_rows.shape[0]:
        all_rows = torch.cat([solid_rows, rescued_rows])
        all_counts = torch.cat([solid_counts,
                                torch.ones_like(rescued_rows[:, 0])])
        order = sort_rows_lex(all_rows)
        all_rows, all_counts = all_rows[order], all_counts[order]
    else:
        all_rows, all_counts = solid_rows, solid_counts
    return dict(solid_rows=solid_rows, solid_counts=solid_counts,
                rescued_rows=rescued_rows, all_rows=all_rows,
                all_counts=all_counts)


def _assemble_first_pass(rows, read_ids, offsets, uniq, counts, k,
                         min_abundance):
    solid_rows, solid_counts = _solid(uniq, counts, min_abundance)
    rescued_rows = _empty_rows(k, rows.device)
    if min_abundance <= 1 and rows.shape[0] > 0:
        rescued_rows = _rescue(rows, read_ids, offsets, solid_rows,
                               solid_counts, k)
    return _with_rescued(solid_rows, solid_counts, rescued_rows)


# -- 128-bit keys ------------------------------------------------------------

def sort_pairs(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Stable order of (h1, h2) u64 pairs, unsigned lexicographic (the order
    of np.lexsort((h2, h1)) on uint64 arrays)."""
    o = torch.sort(h2 ^ SIGN, stable=True).indices
    return o[torch.sort((h1 ^ SIGN)[o], stable=True).indices]


def pair_heads(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Head-of-run mask of sorted pairs."""
    head = torch.ones(h1.shape[0], dtype=torch.bool, device=h1.device)
    head[1:] = (h1[1:] != h1[:-1]) | (h2[1:] != h2[:-1])
    return head


class PairTable:
    """A table of (h1, h2) -> value, sorted in unsigned pair order, with
    batched lookups: torch.searchsorted on the sign-flipped h1 column, then
    a bisection over h2 inside runs of equal h1 (runs longer than one come
    only from 64-bit collisions, so it takes at most a step or two)."""

    def __init__(self, h1, h2, values, presorted: bool = False):
        if not presorted:
            order = sort_pairs(h1, h2)
            h1, h2, values = h1[order], h2[order], values[order]
        self.f1 = (h1 ^ SIGN).contiguous()
        self.f2 = (h2 ^ SIGN).contiguous()
        self.values = values

    def __len__(self):
        return self.f1.shape[0]

    @property
    def h1(self):
        return self.f1 ^ SIGN

    @property
    def h2(self):
        return self.f2 ^ SIGN

    def searchsorted(self, q1, q2):
        """Left insertion index of each query pair (the port of
        _searchsorted_pairs)."""
        m = len(self)
        g1 = (q1 ^ SIGN).contiguous()
        g2 = q2 ^ SIGN
        lo = torch.searchsorted(self.f1, g1, side="left")
        hi = torch.searchsorted(self.f1, g1, side="right")
        span = int((hi - lo).max()) if q1.numel() else 0
        for _ in range(span.bit_length()):
            active = lo < hi
            mid = (lo + hi) // 2
            less = self.f2[mid.clamp(max=m - 1)] < g2
            lo = torch.where(active & less, mid + 1, lo)
            hi = torch.where(active & ~less, mid, hi)
        return lo

    def lookup(self, q1, q2, default):
        """(values, hit) for query pairs; `default` where absent."""
        n = q1.shape[0]
        if len(self) == 0 or n == 0:
            return (torch.full((n,), default, dtype=self.values.dtype,
                               device=q1.device),
                    torch.zeros(n, dtype=torch.bool, device=q1.device))
        idx = self.searchsorted(q1, q2).clamp(max=len(self) - 1)
        hit = (self.f1[idx] == (q1 ^ SIGN)) & (self.f2[idx] == (q2 ^ SIGN))
        vals = torch.where(hit, self.values[idx],
                           torch.full_like(self.values[idx], default))
        return vals, hit


def _lookup_rows(query: torch.Tensor, table: torch.Tensor,
                 values: torch.Tensor, default):
    """For each query row, value of the matching table row, compared through
    128-bit hashes of the raw rows (collision probability ~2^-128)."""
    t1, t2 = window_hash.hash_rows(table)
    q1, q2 = window_hash.hash_rows(query)
    return PairTable(t1, t2, values).lookup(q1, q2, default)


def _rescue(rows, read_ids, offsets, solid_rows, solid_counts, k):
    """RescueKminmerFunctor semantics (src/graph/CreateMdbg.hpp:4579-4637),
    vectorized over reads as metamdbg_tpu/count/kminmers.py:_rescue."""
    abundances, hit = _lookup_rows(rows, solid_rows, solid_counts, 1)
    nreads = offsets.shape[0] - 1
    if rows.shape[0] == 0 or nreads == 0:
        return _empty_rows(k, rows.device)
    seg_len = offsets[1:] - offsets[:-1]
    nonempty = seg_len > 0

    csum = torch.zeros(hit.shape[0] + 1, dtype=torch.int64,
                       device=hit.device)
    torch.cumsum(hit.to(torch.int64), 0, out=csum[1:])
    any_hit = (csum[offsets[1:]] - csum[offsets[:-1]]) > 0

    # per-read sorted abundances: stable sort by abundance, then by read
    o = torch.sort(abundances, stable=True).indices
    s = abundances[o[torch.sort(read_ids[o], stable=True).indices]]
    half = seg_len // 2
    last = s.shape[0] - 1
    lo_idx = torch.where(nonempty, offsets[:-1] + (half - 1).clamp(min=0),
                         0).clamp(max=last)
    mid_idx = torch.where(nonempty, offsets[:-1] + half, 0).clamp(max=last)
    even = (seg_len % 2 == 0) & nonempty
    # u32 integer mean (Utils::compute_median, Commons.hpp:2982)
    med = torch.where(even, ((s[lo_idx] + s[mid_idx]) & 0xFFFFFFFF) // 2,
                      s[mid_idx])
    cutoff = med.to(torch.float32) * torch.tensor(0.1, dtype=torch.float32)
    keep_read = any_hit & (cutoff <= 1.0)

    weak = rows[keep_read[read_ids] & ~hit]
    if weak.shape[0] == 0:
        return _empty_rows(k, rows.device)
    uniq, _ = count_unique_rows(weak)
    return uniq
