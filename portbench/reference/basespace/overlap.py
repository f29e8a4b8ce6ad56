"""Anchor-based sequence overlap/mapping engine (minimap2's role).

Plays the part of the embedded minimap2 in the reference's base-space
subsystem (read-vs-read overlap verification, read-vs-contig mapping,
contig self-maps; src/toBasespace/ToBasespace2.hpp:3547-3720,
ContigPolisher.hpp:451-518, ContigDerep.hpp:75-133) with a TPU-friendly
formulation: universe-hash minimizer seeding (the same bit-exact sketch
kernel the assembler uses), diagonal-binned anchor chaining, and
closed-form identity estimation from seed survival — no base-level DP.
Exact base correspondences come for free at anchors (anchors are exact
15-mer matches), which is all the tiling/polishing stages consume.

Identity estimation: a seed at density d survives at a position iff its
15-mer window is error-free, so the anchor-covered fraction c of an
alignment span satisfies c ~= 1 - exp(-15 * d * s) with s = identity^15;
inverting gives the identity estimate used for the reference's
identity-threshold filters.
"""

import numpy as np

from ..sketch import kmers as _kmers
from ..sketch import minimizers as _mini

ALIGN_L = 15
ALIGN_DENSITY = 0.1


class Bounds:
    """AlignmentBounds analog (src/Commons.hpp:435-527)."""

    __slots__ = ("query_start", "query_end", "ref_start", "ref_end",
                 "query_length", "ref_length", "is_reversed", "nb_matches",
                 "identity", "tid", "anchors")

    def __init__(self, qs, qe, rs, re, qlen, rlen, rev, matches, identity,
                 tid=0, anchors=None):
        self.query_start = int(qs)
        self.query_end = int(qe)
        self.ref_start = int(rs)
        self.ref_end = int(re)
        self.query_length = int(qlen)
        self.ref_length = int(rlen)
        self.is_reversed = bool(rev)
        self.nb_matches = int(matches)
        self.identity = float(identity)
        self.tid = int(tid)
        # (q_pos, t_pos) int64 arrays of the chain's exact-match seeds, in
        # query order (t descending when reversed); each covers ALIGN_L bases
        self.anchors = anchors

    def align_length(self):
        return min(self.query_end - self.query_start,
                   self.ref_end - self.ref_start)

    def mappable_length(self):
        """AlignmentBounds::getMappableLength (src/Commons.hpp:483-525)."""
        ql, qs, qe = self.query_length, self.query_start, self.query_end
        tl, ts, te = self.ref_length, self.ref_start, self.ref_end
        align_length = max(qe - qs, te - ts)
        if self.is_reversed:
            tl5, tl3 = tl - te, ts
        else:
            tl5, tl3 = ts, tl - te
        ext5 = qs if qs < tl5 else tl5
        ext3 = (ql - qe) if (ql - qe) < tl3 else tl3
        return align_length + ext5 + ext3


def sketch(seq: np.ndarray, density: float = ALIGN_DENSITY):
    """(values u32, positions i64, dirs u8) of a raw (non-HPC) sequence."""
    codes, bad = _kmers.base_codes(np.asarray(seq, np.uint8))
    vals, pos, dirs = _mini.select_minimizers(codes, bad, ALIGN_L, density)
    return vals, pos.astype(np.int64), dirs


class SeqIndex:
    """Minimizer index over one or more target sequences."""

    def __init__(self, density: float = ALIGN_DENSITY):
        self.density = density
        self._vals = []
        self._tids = []
        self._pos = []
        self._dirs = []
        self.lengths: dict = {}

    def add(self, tid: int, seq: np.ndarray, sketched=None):
        vals, pos, dirs = sketched if sketched is not None else \
            sketch(seq, self.density)
        self._vals.append(vals)
        self._tids.append(np.full(vals.shape[0], tid, np.int64))
        self._pos.append(pos)
        self._dirs.append(dirs)
        self.lengths[tid] = int(np.asarray(seq).shape[0])

    def build(self):
        if self._vals:
            vals = np.concatenate(self._vals)
            order = np.argsort(vals, kind="stable")
            self.vals = vals[order]
            self.tids = np.concatenate(self._tids)[order]
            self.pos = np.concatenate(self._pos)[order]
            self.dirs = np.concatenate(self._dirs)[order]
        else:
            self.vals = np.zeros(0, np.uint32)
            self.tids = np.zeros(0, np.int64)
            self.pos = np.zeros(0, np.int64)
            self.dirs = np.zeros(0, np.uint8)
        self._vals = self._tids = self._pos = self._dirs = None
        return self


def _extract_chains(q_pos, t_pos, rev, qlen, tlen, tid, density,
                    min_span, band, max_chains, min_anchors):
    """Iterative diagonal-band chain extraction for one (target, strand).

    Anchors: q_pos/t_pos int64 (query ascending not required). Returns
    Bounds list, best chain first.
    """
    out = []
    # reversed overlaps advance t backwards as q advances: use anti-diagonal
    diag = (t_pos + q_pos) if rev else (t_pos - q_pos)
    alive = np.ones(q_pos.shape[0], bool)
    for _ in range(max_chains):
        idx = np.flatnonzero(alive)
        if idx.shape[0] < min_anchors:
            break
        d = diag[idx]
        # densest diagonal corridor of width `band`
        ds = np.sort(d)
        j = np.searchsorted(ds, ds + band, side="right")
        counts = j - np.arange(ds.shape[0])
        peak = int(np.argmax(counts))
        lo, hi = ds[peak], ds[peak] + band
        sel = idx[(d >= lo) & (d <= hi)]
        alive[sel] = False
        if sel.shape[0] < min_anchors:
            continue
        q = q_pos[sel]
        t = t_pos[sel]
        order = np.lexsort((t, q))
        q, t = q[order], t[order]
        # keep a monotone subsequence (record-setters of t along q)
        tt = -t if rev else t
        keep = tt >= np.maximum.accumulate(tt)
        q, t = q[keep], t[keep]
        if q.shape[0] < min_anchors:
            continue
        qs, qe = int(q[0]), int(q[-1]) + ALIGN_L
        if rev:
            ts, te = int(t[-1]), int(t[0]) + ALIGN_L
        else:
            ts, te = int(t[0]), int(t[-1]) + ALIGN_L
        span = min(qe - qs, te - ts)
        if span < min_span:
            continue
        # covered query bases (union of seed windows)
        covered = int(np.minimum(np.diff(q), ALIGN_L).sum()) + ALIGN_L
        cov_frac = min(1.0, covered / max(1, qe - qs))
        if cov_frac >= 0.999:
            identity = 1.0
        else:
            s = min(1.0, -np.log(1.0 - cov_frac) / (ALIGN_L * density))
            identity = float(s ** (1.0 / ALIGN_L))
        matches = int(identity * span)
        if matches < min_span:  # min_chain_score role (-m 500)
            continue
        out.append(Bounds(qs, qe, ts, te, qlen, tlen, rev, matches, identity,
                          tid, anchors=(q, t)))
    out.sort(key=lambda b: -b.nb_matches)
    return out


def _bounds_from_chain_tuple(c, qlen, index):
    (qs, qe, ts, te, matches, identity, tid, rev, aq, at) = c
    return Bounds(qs, qe, ts, te, qlen, index.lengths[tid], rev, matches,
                  identity, tid, anchors=(aq, at))


def map_sketched(index: SeqIndex, q_vals, q_pos, q_dirs, qlen,
                 min_span: int = 500, max_occ: int = 16, band: int = 500,
                 max_chains: int = 4, min_anchors: int = 4,
                 exclude_tid: int | None = None,
                 exclude_self_diag: bool = False):
    """All chains of a pre-sketched query against the index.

    Production host path is the native engine (native/overlap.cpp,
    bit-identical — tests/test_overlap_native.py); the numpy path below is
    the golden oracle and the METAMDBG_TPU_HOST_OVERLAP fallback."""
    from . import overlap_native
    if overlap_native.available():
        res = overlap_native.map_sketched_batch(
            index, [(q_vals, q_pos, q_dirs, qlen,
                     -1 if exclude_tid is None else exclude_tid)],
            index.density, min_span, max_occ, band, max_chains, min_anchors,
            ALIGN_L, exclude_self_diag, n_threads=1)
        if res is not None:
            return [_bounds_from_chain_tuple(c, qlen, index)
                    for c in res[0]]
    return map_sketched_numpy(index, q_vals, q_pos, q_dirs, qlen, min_span,
                              max_occ, band, max_chains, min_anchors,
                              exclude_tid, exclude_self_diag)


def map_sketched_numpy(index: SeqIndex, q_vals, q_pos, q_dirs, qlen,
                       min_span: int = 500, max_occ: int = 16,
                       band: int = 500, max_chains: int = 4,
                       min_anchors: int = 4, exclude_tid: int | None = None,
                       exclude_self_diag: bool = False):
    """Numpy golden path (the parity oracle for the native engine)."""
    if q_vals.shape[0] == 0 or index.vals.shape[0] == 0:
        return []
    lo = np.searchsorted(index.vals, q_vals, side="left")
    hi = np.searchsorted(index.vals, q_vals, side="right")
    counts = hi - lo
    counts = np.where(counts > max_occ, 0, counts)  # mid_occ seed filter
    total = int(counts.sum())
    if total == 0:
        return []
    qi = np.repeat(np.arange(q_vals.shape[0]), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.repeat(lo - offs, counts) + np.arange(total)
    a_t = index.pos[j]
    a_tid = index.tids[j]
    a_rev = (index.dirs[j] != q_dirs[qi])
    a_q = q_pos[qi]

    if exclude_tid is not None:
        keep = a_tid != exclude_tid
        a_t, a_tid, a_rev, a_q = a_t[keep], a_tid[keep], a_rev[keep], a_q[keep]
    if exclude_self_diag:
        keep = ~((~a_rev) & (a_t == a_q))
        a_t, a_tid, a_rev, a_q = a_t[keep], a_tid[keep], a_rev[keep], a_q[keep]
    if a_t.shape[0] == 0:
        return []

    out = []
    key = a_tid * 2 + a_rev
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(key_s)) + 1,
                             [key_s.shape[0]]])
    for s, e in zip(starts[:-1], starts[1:]):
        if e - s < min_anchors:
            continue
        sel = order[s:e]
        tid = int(a_tid[sel[0]])
        rev = bool(a_rev[sel[0]])
        out.extend(_extract_chains(
            a_q[sel], a_t[sel], rev, qlen, index.lengths[tid], tid,
            index.density, min_span, band, max_chains, min_anchors))
    out.sort(key=lambda b: -b.nb_matches)
    return out


def map_seq(index: SeqIndex, q_seq: np.ndarray, **kw):
    q_vals, q_pos, q_dirs = sketch(np.asarray(q_seq, np.uint8), index.density)
    return map_sketched(index, q_vals, q_pos, q_dirs,
                        int(np.asarray(q_seq).shape[0]), **kw)


def overlap_pair(t_sketch, t_len, q_sketch, q_len, min_span: int = 500,
                 t_index=None):
    """computeAlignment's role for one (read1=target, read2=query) pair
    (ToBasespace2.hpp:3588-3720): all chains, best (longest align) first.

    `t_index`: optional prebuilt overlap_native.PairIndex of the target
    (tiling caches one per read — the walk queries each read against many
    neighbors)."""
    from . import overlap_native
    q_vals, q_pos, q_dirs = q_sketch
    if overlap_native.available():
        if t_index is None:
            t_index = overlap_native.PairIndex(t_sketch, t_len)
        res = overlap_native.map_pair(t_index, q_vals, q_pos, q_dirs, q_len,
                                      ALIGN_DENSITY, min_span, 5,
                                      align_l=ALIGN_L)
        if res is not None:
            return [Bounds(qs, qe, ts, te, q_len, t_len, rev, matches,
                           identity, tid, anchors=(aq, at))
                    for (qs, qe, ts, te, matches, identity, tid, rev,
                         aq, at) in res]
    idx = SeqIndex()
    idx.add(0, np.zeros(0, np.uint8), sketched=t_sketch)
    idx.lengths[0] = t_len
    idx.build()
    return map_sketched_numpy(idx, q_vals, q_pos, q_dirs, q_len,
                              min_span=min_span, max_occ=5)


def coverage_profile(bounds: Bounds, t_len: int, gap_tolerance: int = 50):
    """(coverages, coverages_mapping) over the TARGET of one chain — the
    role of the reference's M/D CIGAR walk in isErroneousRead
    (ToBasespace2.hpp:3062-3095): M-ish spans (anchors + small consistent
    gaps) count in both; target-only advances (deletions in the query)
    count only in coverages_mapping."""
    cov_map = np.zeros(t_len, bool)
    if bounds.anchors is None:
        return np.zeros(t_len, bool), cov_map
    q, t = bounds.anchors
    if bounds.is_reversed:
        q, t = q[::-1], t[::-1]  # t ascending
    cov_map[max(0, int(t[0])):min(t_len, int(t[-1]) + ALIGN_L)] = True
    # interval union via a difference array (vectorized over anchors)
    delta = np.zeros(t_len + 1, np.int32)
    # anchor windows always count as matches
    starts = np.clip(t, 0, t_len).astype(np.int64)
    ends = np.clip(t + ALIGN_L, 0, t_len).astype(np.int64)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    # small consistent inter-anchor gaps count as matches too
    dt = np.diff(t)
    dq = np.abs(np.diff(q))
    ok = np.flatnonzero((np.abs(dt - dq) <= gap_tolerance) & (dt > ALIGN_L))
    if ok.size:
        gs = np.clip(t[ok] + ALIGN_L, 0, t_len).astype(np.int64)
        ge = np.clip(t[ok + 1], 0, t_len).astype(np.int64)
        np.add.at(delta, gs, 1)
        np.add.at(delta, ge, -1)
    cov = np.cumsum(delta[:-1]) > 0
    return cov, cov_map
