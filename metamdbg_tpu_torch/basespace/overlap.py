"""Anchor-based sequence overlap/mapping engine (minimap2's role).

Plays the part of the embedded minimap2 in the reference's base-space
subsystem (read-vs-read overlap verification, read-vs-contig mapping,
contig self-maps; src/toBasespace/ToBasespace2.hpp:3547-3720,
ContigPolisher.hpp:451-518, ContigDerep.hpp:75-133): universe-hash
minimizer seeding (the sketch kernel K1 the assembler uses, at l=15 and
density 0.1), diagonal-binned anchor chaining in the native engine
(native/overlap.cpp), and closed-form identity estimation from seed
survival, with no base-level DP. Exact base correspondences come for free
at anchors (anchors are exact 15-mer matches), which is all the
tiling/polishing stages consume. The port of
metamdbg_tpu/basespace/overlap.py.

Identity estimation: a seed at density d survives at a position iff its
15-mer window is error-free, so the anchor-covered fraction c of an
alignment span satisfies c ~= 1 - exp(-15 * d * s) with s = identity^15;
inverting gives the identity estimate used for the reference's
identity-threshold filters.
"""

import numpy as np

from ..sketch import kmers as _kmers
from ..sketch.batch import BatchSketcher
from . import overlap_native

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


def sketch_many(seqs, device):
    """[(values u32, positions i64, dirs u8)] of raw (non-HPC) sequences,
    in input order: kernel K1 through sketch/batch.BatchSketcher, the
    trim=1 selection of metamdbg_tpu's overlap.sketch."""
    if not seqs:
        return []
    codes, bads = zip(*(_kmers.base_codes(np.asarray(s, np.uint8))
                        for s in seqs))
    sk = BatchSketcher(ALIGN_L, ALIGN_DENSITY, None, device)
    return [(vals, pos.astype(np.int64), dirs)
            for vals, pos, dirs in sk.sketch_many(codes, bads)]


def sketch(seq: np.ndarray, device):
    return sketch_many([seq], device)[0]


class SeqIndex:
    """Minimizer index over one or more target sequences."""

    def __init__(self, density: float = ALIGN_DENSITY):
        self.density = density
        self._vals = []
        self._tids = []
        self._pos = []
        self._dirs = []
        self.lengths: dict = {}

    def add(self, tid: int, length: int, sketched):
        vals, pos, dirs = sketched
        self._vals.append(vals)
        self._tids.append(np.full(vals.shape[0], tid, np.int64))
        self._pos.append(pos)
        self._dirs.append(dirs)
        self.lengths[tid] = int(length)

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


def _bounds_from_chain_tuple(c, qlen, index):
    (qs, qe, ts, te, matches, identity, tid, rev, aq, at) = c
    return Bounds(qs, qe, ts, te, qlen, index.lengths[tid], rev, matches,
                  identity, tid, anchors=(aq, at))


def map_sketched(index: SeqIndex, q_vals, q_pos, q_dirs, qlen,
                 min_span: int = 500, max_occ: int = 16, band: int = 500,
                 max_chains: int = 4, min_anchors: int = 4,
                 exclude_tid: int | None = None,
                 exclude_self_diag: bool = False):
    """All chains of a pre-sketched query against the index, best first
    (native/overlap.cpp)."""
    res = overlap_native.map_sketched_batch(
        index, [(q_vals, q_pos, q_dirs, qlen,
                 -1 if exclude_tid is None else exclude_tid)],
        index.density, min_span, max_occ, band, max_chains, min_anchors,
        ALIGN_L, exclude_self_diag, n_threads=1)
    return [_bounds_from_chain_tuple(c, qlen, index) for c in res[0]]


def overlap_pair(t_sketch, t_len, q_sketch, q_len, min_span: int = 500,
                 t_index=None):
    """computeAlignment's role for one (read1=target, read2=query) pair
    (ToBasespace2.hpp:3588-3720): all chains, best (longest align) first.

    `t_index`: optional prebuilt overlap_native.PairIndex of the target
    (tiling caches one per read: the walk queries each read against many
    neighbors)."""
    q_vals, q_pos, q_dirs = q_sketch
    if t_index is None:
        t_index = overlap_native.PairIndex(t_sketch, t_len)
    res = overlap_native.map_pair(t_index, q_vals, q_pos, q_dirs, q_len,
                                  ALIGN_DENSITY, min_span, 5,
                                  align_l=ALIGN_L)
    return [Bounds(qs, qe, ts, te, q_len, t_len, rev, matches, identity, tid,
                   anchors=(aq, at))
            for (qs, qe, ts, te, matches, identity, tid, rev, aq, at) in res]


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
