"""Minimizer-pair anchor chaining shared by the post-processing stages.

Mirrors the chaining machinery of DerepSmallContigs / ReadVsContigMapper
(src/toBasespace/DerepSmallContigs.hpp:519-1014,
src/toBasespace/ReadVsContigMapper.hpp:440-780): contigs are indexed by their
normalized minimizer *pairs* (2-min-mers packed to u64); query anchors are
chained with a banded DP (band 10, anchor weight 20, gap cap 100) and the
best-scoring chain per (query, reference) pair competes for the query's best
mapping.
"""

import dataclasses

import numpy as np


def normalized_pairs(minimizers: np.ndarray):
    """All normalized consecutive pairs, packed u64, with isReversed flags.

    Matches getKminmers_complete at k=2 + KmerVec::packPair
    (src/Commons.hpp:937-939): pack = norm[0]<<32 | norm[1]; ties reversed.
    """
    m = np.asarray(minimizers, dtype=np.uint64)
    if m.shape[0] < 2:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    a, b = m[:-1], m[1:]
    is_rev = ~(a < b)
    lo = np.where(is_rev, b, a)
    hi = np.where(is_rev, a, b)
    packed = (lo << np.uint64(32)) | hi
    return packed, is_rev


class PairIndex:
    """Sorted (pair, refIndex, position, isReversed) table + range lookup."""

    def __init__(self):
        self._pairs = []
        self._refs = []
        self._positions = []
        self._revs = []
        self.pairs = None

    def add(self, ref_index: int, minimizers: np.ndarray):
        packed, is_rev = normalized_pairs(minimizers)
        self._pairs.append(packed)
        self._refs.append(np.full(packed.shape[0], ref_index, np.uint32))
        self._positions.append(np.arange(packed.shape[0], dtype=np.uint32))
        self._revs.append(is_rev)

    def build(self):
        if not self._pairs:
            self.pairs = np.zeros(0, np.uint64)
            self.refs = np.zeros(0, np.uint32)
            self.positions = np.zeros(0, np.uint32)
            self.revs = np.zeros(0, bool)
            return
        pairs = np.concatenate(self._pairs)
        order = np.argsort(pairs, kind="stable")
        self.pairs = pairs[order]
        self.refs = np.concatenate(self._refs)[order]
        self.positions = np.concatenate(self._positions)[order]
        self.revs = np.concatenate(self._revs)[order]
        self._pairs = self._refs = self._positions = self._revs = None

    def lookup_range(self, packed: int):
        lo = np.searchsorted(self.pairs, packed, side="left")
        hi = np.searchsorted(self.pairs, packed, side="right")
        return lo, hi


@dataclasses.dataclass
class ChainResult:
    score: float
    n_matches: int
    n_differences: int
    query_start: int
    query_end: int
    reference_start: int
    reference_end: int
    is_reversed: bool


def collect_anchors(index: PairIndex, minimizers: np.ndarray,
                    exclude_ref: int | None = None):
    """Anchors (refIndex, refPos, queryPos, isReversed) sorted by
    (refIndex, refPos, queryPos) (DerepSmallContigs.hpp:527-586)."""
    packed, q_rev = normalized_pairs(minimizers)
    out = []
    for qpos in range(packed.shape[0]):
        lo, hi = index.lookup_range(packed[qpos])
        if lo == hi:
            continue
        for j in range(lo, hi):
            ref = int(index.refs[j])
            if exclude_ref is not None and ref == exclude_ref:
                continue
            out.append((ref, int(index.positions[j]), qpos,
                        bool(index.revs[j]) != bool(q_rev[qpos])))
    out.sort(key=lambda a: (a[0], a[1], a[2]))
    return out


def chain_anchors(anchors: list, max_band: int = 10, w: float = 20.0):
    """Banded chaining DP (DerepSmallContigs.hpp:750-973). anchors: list of
    (refPos, queryPos, isReversed) for ONE reference, in (refPos, queryPos)
    order. Returns ChainResult or None (chain < 3 anchors)."""
    n = len(anchors)
    scores = [0.0] * n
    parents = [-1] * n
    for i in range(n):
        rp_i, qp_i, rev_i = anchors[i]
        best_score = 0.0
        best_prev = i
        j = i - 1
        while j >= 0 and i - j <= max_band:
            rp_j, qp_j, rev_j = anchors[j]
            if rp_i == rp_j or qp_i == qp_j or rev_i != rev_j:
                j -= 1
                continue
            d_q = (qp_j - qp_i) if rev_i else (qp_i - qp_j)
            d_r = rp_i - rp_j
            if d_r <= 0:
                j -= 1
                continue
            gap = abs(d_r - d_q)
            if gap > 100:
                j -= 1
                continue
            if rev_i:
                if qp_i > qp_j:
                    j -= 1
                    continue
            else:
                if qp_i < qp_j:
                    j -= 1
                    continue
            new_score = scores[j] + (w - gap)
            if new_score > best_score:
                best_score = new_score
                best_prev = j
            j -= 1
        if best_prev != i:
            scores[i] = best_score
            parents[i] = best_prev
        else:
            scores[i] = w
            parents[i] = -1

    max_score = 0.0
    best_index = -1
    for i in range(n):
        if scores[i] > max_score:
            max_score = scores[i]
            best_index = i

    interval = []
    idx = best_index
    while idx != -1:
        interval.append(idx)
        idx = parents[idx]
    if len(interval) < 3:
        return None
    interval.reverse()

    first = anchors[interval[0]]
    last = anchors[interval[-1]]
    n_matches = len(interval)
    is_reversed = first[1] > last[1]
    if is_reversed:
        n_diff_q = (first[1] - last[1] + 1) - n_matches
        q_start, q_end = last[1], first[1]
    else:
        n_diff_q = (last[1] - first[1] + 1) - n_matches
        q_start, q_end = first[1], last[1]
    n_diff_r = (last[0] - first[0] + 1) - n_matches
    return ChainResult(max_score, n_matches, n_diff_q + n_diff_r,
                       q_start, q_end, first[0], last[0], is_reversed)


def best_mapping(index: PairIndex, minimizers: np.ndarray,
                 exclude_ref: int | None = None):
    """Best (matchScore) chain across references; ties keep the first
    reference in index order (DerepSmallContigs.hpp:1004-1013).

    Returns (ref_index, ChainResult) or None.
    """
    anchors = collect_anchors(index, minimizers, exclude_ref)
    best = None
    i = 0
    n = len(anchors)
    while i < n:
        ref = anchors[i][0]
        j = i
        sub = []
        while j < n and anchors[j][0] == ref:
            sub.append(anchors[j][1:])
            j += 1
        if len(sub) >= 3:
            chain = chain_anchors(sub)
            if chain is not None and chain.score != 0:
                if best is None or chain.n_matches > best[1].n_matches:
                    best = (ref, chain)
        i = j
    return best
