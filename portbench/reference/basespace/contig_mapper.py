"""Read-vs-contig mapping, faithful to ReadVsContigMapper
(src/toBasespace/ReadVsContigMapper.hpp:440-1040):

- contigs indexed by normalized minimizer pairs (pair INDEX positions);
- per read, anchors grouped by contig, chained with band 10 / w 20 /
  index-gap cap 100, plus bp-spacing caps of 5000 on both sequences
  (hpp:820-866); chains need >= 2 anchors;
- matchScore = nbMatches - overhangStart - overhangEnd where overhangs are
  read bp before/after the chain divided by the average minimizer distance
  (hpp:920-923);
- one best mapping per read; score ties prefer the smaller contigStart,
  else the first contig in index order (hpp:1030-1042).

Output record = ReadMapping2 (src/Commons.hpp:344-381): read, contig,
readStart, readEnd, contigStart, contigEnd (pair indexes, ends +1),
isReversed, matchScore, bp positions of the chain ends, read length.
"""

import struct

import numpy as np

from ..io import records
from .chaining import PairIndex, normalized_pairs

CHAIN_BAND = 10
CHAIN_W = np.float32(20.0)


def _chain(anchors, q_pos_bp, avg_dist):
    """anchors: (refPos, queryPos, isRev) int arrays sorted by
    (refPos, queryPos); q_pos_bp: read minimizer bp positions. Returns
    (score, interval root->best) or None."""
    ref_pos, q_pos, is_rev = anchors
    n = ref_pos.shape[0]
    scores = np.zeros(n, np.float32)
    parents = np.full(n, -1, np.int64)
    for i in range(n):
        best_score = np.float32(0.0)
        best_prev = i
        for j in range(i - 1, -1, -1):
            if i - j > CHAIN_BAND:
                break
            if is_rev[i] != is_rev[j]:
                continue
            if ref_pos[i] == ref_pos[j] or q_pos[i] == q_pos[j]:
                continue
            if is_rev[i]:
                d_q = q_pos[j] - q_pos[i]
            else:
                d_q = q_pos[i] - q_pos[j]
            d_r = ref_pos[i] - ref_pos[j]
            if (ref_pos[i] - ref_pos[j]) * avg_dist > 5000:
                continue
            if d_r <= 0:
                continue
            gap = abs(d_r - d_q)
            if gap > 100:
                continue
            if is_rev[i]:
                if q_pos_bp[q_pos[j]] - q_pos_bp[q_pos[i]] > 5000:
                    continue
                if q_pos[i] > q_pos[j]:
                    continue
            else:
                if q_pos_bp[q_pos[i]] - q_pos_bp[q_pos[j]] > 5000:
                    continue
                if q_pos[i] < q_pos[j]:
                    continue
            new_score = scores[j] + (CHAIN_W - np.float32(gap))
            if new_score > best_score:
                best_score = new_score
                best_prev = j
        if best_prev != i:
            scores[i] = best_score
            parents[i] = best_prev
        else:
            scores[i] = CHAIN_W
            parents[i] = -1

    best_index = -1
    max_score = np.float32(0.0)
    for i in range(n):
        if scores[i] > max_score:
            max_score = scores[i]
            best_index = i
    if best_index < 0:
        return None
    interval = []
    idx = best_index
    while idx != -1:
        interval.append(idx)
        idx = parents[idx]
    interval.reverse()
    if len(interval) < 2:
        return None
    return float(max_score), interval


_CHAIN_BUCKETS = (64, 256, 1024, 4096)


def _d_r_max(avg_dist: float) -> int:
    """Largest integer d_r with d_r * avg_dist <= 5000 under the host's
    exact f64 product (hpp:845)."""
    t = int(5000.0 / avg_dist)
    while (t + 1) * float(avg_dist) <= 5000.0:
        t += 1
    while t > 0 and t * float(avg_dist) > 5000.0:
        t -= 1
    return t


def _groups_of_read(rec, index, avg_dist):
    """Anchor groups (one per candidate contig) for one read, or []."""
    packed, q_rev = normalized_pairs(rec.minimizers)
    if packed.shape[0] == 0 or index.pairs.shape[0] == 0:
        return []
    lo = np.searchsorted(index.pairs, packed, side="left")
    hi = np.searchsorted(index.pairs, packed, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return []
    q_sel = np.repeat(np.arange(packed.shape[0]), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.repeat(lo - offs, counts) + np.arange(total)
    t_contig = index.refs[j].astype(np.int64)
    a_ref = index.positions[j].astype(np.int64)
    a_rev = index.revs[j] != q_rev[q_sel]

    order = np.lexsort((q_sel, a_ref, t_contig))
    t_contig = t_contig[order]
    a_ref = a_ref[order]
    a_rev = a_rev[order]
    a_q = q_sel[order].astype(np.int64)

    groups = []
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(t_contig)) + 1, [t_contig.shape[0]]])
    for s, e in zip(starts[:-1], starts[1:]):
        if e - s < 2:  # processAnchors minimum (hpp:636)
            continue
        groups.append((int(t_contig[s]), a_ref[s:e], a_q[s:e], a_rev[s:e]))
    return groups


def _mapping_from_interval(rec, pos_bp, contig, a_ref, a_q, interval,
                           avg_dist):
    first_q = int(a_q[interval[0]])
    last_q = int(a_q[interval[-1]])
    first_r = int(a_ref[interval[0]])
    last_r = int(a_ref[interval[-1]])
    nb_matches = len(interval)
    is_reversed = first_q > last_q
    if is_reversed:
        read_start, read_end = last_q, first_q + 1
    else:
        read_start, read_end = first_q, last_q + 1
    contig_start, contig_end = first_r, last_r + 1
    overhang_start = int(pos_bp[read_start] / avg_dist)
    overhang_end = int((rec.read_length - pos_bp[read_end]) / avg_dist)
    match_score = nb_matches - overhang_start - overhang_end
    return (rec.index, contig, read_start, read_end, contig_start,
            contig_end, 1 if is_reversed else 0, match_score,
            int(pos_bp[read_start]), int(pos_bp[read_end]), rec.read_length)


def map_reads_to_contigs(read_file: str, contig_file: str, output_file: str,
                         avg_minimizer_distance: float):
    """Writes readsVsContigsAlignments.bin-style records; returns them.

    The banded chain DP runs on the host (the native engine, or `_chain`);
    anchor building and best-mapping selection too."""
    avg_dist = avg_minimizer_distance
    index = PairIndex()
    for rec in records.read_read_data(contig_file, with_quality=False):
        index.add(rec.index, rec.minimizers)
    index.build()

    out = []
    fmt = struct.Struct("<IIIIIIBiIII")
    f = open(output_file, "wb")
    recs = []
    groups = []          # (rec_slot, contig, a_ref, a_q, a_rev)
    CHUNK_RECS = 65536   # RAM bound: chain + flush per chunk

    def flush():
        for mapping in _chain_and_select(recs, groups, avg_dist):
            if mapping is None:
                continue
            out.append(mapping)
            f.write(fmt.pack(*mapping))
        recs.clear()
        groups.clear()

    for rec in records.read_read_data(read_file, with_quality=True):
        slot = len(recs)
        recs.append(rec)
        for contig, a_ref, a_q, a_rev in _groups_of_read(rec, index,
                                                         avg_dist):
            groups.append((slot, contig, a_ref, a_q, a_rev))
        if len(recs) >= CHUNK_RECS:
            flush()
    flush()
    f.close()
    return out


def _chain_and_select(recs, groups, avg_dist):
    """Chains all anchor groups and returns the best mapping per read
    slot, in slot order."""
    intervals = [None] * len(groups)
    if groups:
        from ..sketch import native_sketch
        nat = None
        if native_sketch.available():
            garrs = []
            for (slot, contig, a_ref, a_q, a_rev) in groups:
                pos_bp = recs[slot].positions.astype(np.int64)
                garrs.append((a_ref, a_q, pos_bp[a_q], a_rev))
            nat = native_sketch.chain_batch_native(
                garrs, float(avg_dist), CHAIN_BAND, float(CHAIN_W), 100, 5000)
        if nat is not None:
            best_i, parents_list = nat
            for gi in range(len(groups)):
                b = int(best_i[gi])
                if b < 0:
                    continue
                par = parents_list[gi]
                interval = []
                idx = b
                while idx != -1:
                    interval.append(idx)
                    idx = int(par[idx])
                interval.reverse()
                if len(interval) >= 2:
                    intervals[gi] = interval
        else:
            for gi, (slot, contig, a_ref, a_q, a_rev) in enumerate(groups):
                pos_bp = recs[slot].positions.astype(np.int64)
                chained = _chain((a_ref, a_q, a_rev), pos_bp, avg_dist)
                if chained is not None:
                    intervals[gi] = chained[1]

    # best mapping per read (hpp:1030-1042 tie-breaks), in slot order
    best_per_slot = [None] * len(recs)
    for gi, (slot, contig, a_ref, a_q, a_rev) in enumerate(groups):
        if intervals[gi] is None:
            continue
        rec = recs[slot]
        pos_bp = rec.positions.astype(np.int64)
        mapping = _mapping_from_interval(rec, pos_bp, contig, a_ref, a_q,
                                         intervals[gi], avg_dist)
        best = best_per_slot[slot]
        if best is None or mapping[7] > best[7] or \
                (mapping[7] == best[7] and mapping[4] < best[4]):
            best_per_slot[slot] = mapping
    return best_per_slot


def map_one_read(rec, index: PairIndex, avg_dist: float):
    packed, q_rev = normalized_pairs(rec.minimizers)
    if packed.shape[0] == 0 or index.pairs.shape[0] == 0:
        return None
    pos_bp = rec.positions.astype(np.int64)

    lo = np.searchsorted(index.pairs, packed, side="left")
    hi = np.searchsorted(index.pairs, packed, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return None
    q_sel = np.repeat(np.arange(packed.shape[0]), counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.repeat(lo - offs, counts) + np.arange(total)
    t_contig = index.refs[j].astype(np.int64)
    a_ref = index.positions[j].astype(np.int64)
    a_rev = index.revs[j] != q_rev[q_sel]

    order = np.lexsort((q_sel, a_ref, t_contig))
    t_contig = t_contig[order]
    a_ref = a_ref[order]
    a_rev = a_rev[order]
    a_q = q_sel[order].astype(np.int64)

    best = None  # ReadMapping2 tuple
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(t_contig)) + 1, [t_contig.shape[0]]])
    for s, e in zip(starts[:-1], starts[1:]):
        if e - s < 2:  # processAnchors minimum (hpp:636)
            continue
        chained = _chain((a_ref[s:e], a_q[s:e], a_rev[s:e]), pos_bp, avg_dist)
        if chained is None:
            continue
        _, interval = chained
        first_q = int(a_q[s + interval[0]])
        last_q = int(a_q[s + interval[-1]])
        first_r = int(a_ref[s + interval[0]])
        last_r = int(a_ref[s + interval[-1]])
        nb_matches = len(interval)
        is_reversed = first_q > last_q
        if is_reversed:
            read_start, read_end = last_q, first_q + 1
        else:
            read_start, read_end = first_q, last_q + 1
        contig_start, contig_end = first_r, last_r + 1

        overhang_start = int(pos_bp[read_start] / avg_dist)
        overhang_end = int((rec.read_length - pos_bp[read_end]) / avg_dist)
        match_score = nb_matches - overhang_start - overhang_end

        mapping = (rec.index, int(t_contig[s]), read_start, read_end,
                   contig_start, contig_end, 1 if is_reversed else 0,
                   match_score, int(pos_bp[read_start]), int(pos_bp[read_end]),
                   rec.read_length)
        if best is None:
            best = mapping
        elif mapping[7] == best[7]:
            # tie: readIndex equal within one read; prefer smaller contigStart
            if mapping[4] < best[4]:
                best = mapping
        elif mapping[7] > best[7]:
            best = mapping
    return best
