"""Read-tiling base-space contig construction, faithful to ToBasespace2
(src/toBasespace/ToBasespace2.hpp:1665-2740,3006-3544).

Per contig: reads mapped to the contig (ReadVsContigMapper records) are
sorted by contig interval; `get_path` greedily extends a read path from the
best-scoring leftmost alignment, verifying every junction with a real
read-vs-read overlap (overlap.py plays minimap2-ava's role) and rejecting
erroneous reads (chimera detection by mapping ~10x neighbor reads onto the
read, `is_erroneous_read`); failures trigger the reference's exclude/pop/
aggressive-retry machinery. Accepted paths are stitched into draft contigs
at exact-match junction anchors, trimmed (oversize ends, 1000 bp circular
margin), and filtered (complexity, highly-repetitive, self-overlap).

Reads are stored contig-oriented (ReadPartitionner reverse-complements on
write), so all junction overlaps are forward-strand.

The port of metamdbg_tpu/basespace/tiling.py. Read and contig sketches come
from kernel K1 on the tiler's `device` (overlap.sketch_many), one batch per
contig ahead of the walk; the overlaps from the native engine. The JAX
package's parallel precompute of the erroneous-read cache
(tiling.py:_precompute_erroneous, which forks) is not carried over: the
walk fills the same cache lazily, with the same values. Ported on Python
threads, it made the tiling of a 4 Mb HiFi isolate 182.6-271.8 s at 8
threads against 11.7-12.5 s without it, on an 8-core NVIDIA H100 host
(tools/thread_walls.py; PERF.md §6): the check is Python under the
interpreter lock, run for every read where the walk checks a few.
"""

import numpy as np

from ..sketch import kmers as _kmers
from ..utils import spans
from . import overlap, overlap_native

MIN_OVERLAP = 500          # ToBasespace2::_minOverlap
INT_FRAC = 0.8             # ToBasespace2::_intFrac
MAX_HANG = 200             # ToBasespace2::_maxHang


class Mapping:
    """ReadMapping2 (src/Commons.hpp:312-382)."""

    __slots__ = ("read_index", "contig_index", "read_start", "read_end",
                 "contig_start", "contig_end", "is_reversed", "match_score",
                 "read_start_real", "read_end_real", "read_length_bp")

    def __init__(self, tup):
        (self.read_index, self.contig_index, self.read_start, self.read_end,
         self.contig_start, self.contig_end, self.is_reversed,
         self.match_score, self.read_start_real, self.read_end_real,
         self.read_length_bp) = tup


class ContigTiler:
    """Shared per-partition state: oriented read sequences + sketches."""

    def __init__(self, reads: dict, avg_dist: float, min_contig_length: int,
                 device, n_threads: int = 1):
        self.reads = reads            # read_index -> np.uint8 array (oriented)
        self.avg_dist = avg_dist
        self.min_contig_length = min_contig_length
        self.device = device
        self.n_threads = n_threads
        self._sketches: dict = {}
        self._indexes: dict = {}
        self._pair_cache: dict = {}
        self._erroneous_cache: dict = {}

    def sketch_of(self, read_index: int):
        s = self._sketches.get(read_index)
        if s is None:
            s = overlap.sketch(self.reads[read_index], self.device)
            self._sketches[read_index] = s
        return s

    def index_of(self, read_index: int):
        """Cached prebuilt PairIndex of a read."""
        idx = self._indexes.get(read_index)
        if idx is None:
            idx = overlap_native.PairIndex(
                self.sketch_of(read_index),
                self.reads[read_index].shape[0])
            self._indexes[read_index] = idx
        return idx

    def prewarm_sketches(self, read_indexes):
        """Batch-sketch many reads ahead of the path walk: one K1 batch."""
        todo = [r for r in read_indexes
                if r not in self._sketches and r in self.reads]
        for r, sk in zip(todo, overlap.sketch_many(
                [self.reads[r] for r in todo], self.device)):
            self._sketches[r] = sk

    # -- read-vs-read overlaps (computeAlignment role) ----------------------
    def pair_alignments(self, r1: int, r2: int):
        key = (r1, r2)
        spans.add("pair_calls")
        hit = self._pair_cache.get(key)
        if hit is None:
            s1, s2 = self.sketch_of(r1), self.sketch_of(r2)
            t_index = self.index_of(r1)
            with spans.timed("pair_s"):
                hit = overlap.overlap_pair(
                    s1, self.reads[r1].shape[0], s2, self.reads[r2].shape[0],
                    min_span=MIN_OVERLAP, t_index=t_index)
            self._pair_cache[key] = hit
        else:
            spans.add("pair_cache_hits")
        return hit

    def clear_contig_caches(self):
        self._pair_cache.clear()
        self._erroneous_cache.clear()
        self._indexes.clear()  # pair queries are contig-local; bound memory

    # -- erroneous-read detection (ToBasespace2.hpp:3006-3164) --------------
    def is_erroneous_read(self, ii: int, alignments, contig_coverage: float):
        used_coverage = 10
        a1 = alignments[ii]
        r1 = a1.read_index
        spans.add("erroneous_calls")
        cached = self._erroneous_cache.get(r1)
        if cached is not None:
            spans.add("erroneous_cache_hits")
            return cached
        read1 = self.reads[r1]
        t_len = read1.shape[0]
        coverages = np.zeros(t_len, np.int64)
        coverages_mapping = np.zeros(t_len, np.int64)

        selected = subsample_mapped_reads(ii, alignments, used_coverage)
        s1 = self.sketch_of(r1)
        sel2 = []
        for a2 in selected:
            if a2.contig_start > a1.contig_end:
                break  # reference truncates at the first non-overlapper
            sel2.append(a2)
        with spans.timed("erroneous_s"):
            overlaps = self._pair_overlaps_batch(r1, s1, t_len, sel2)
        for bl in overlaps:
            if not bl:
                continue
            best = max(bl, key=lambda b: b.align_length())
            cov, cov_map = overlap.coverage_profile(best, t_len)
            coverages += cov
            coverages_mapping += cov_map

        result = is_chimeric(coverages, coverages_mapping, contig_coverage,
                             used_coverage)
        self._erroneous_cache[r1] = result
        return result

    def _pair_overlaps_batch(self, r1, s1, t_len, sel2):
        """All of sel2's reads vs read r1 in one native engine call: the
        same engine, parameters and per-query chain order as overlap_pair,
        so the same results."""
        if not sel2:
            return []
        idx = overlap.SeqIndex()
        idx.add(0, t_len, s1)
        idx.build()
        queries = []
        for a2 in sel2:
            qv, qp, qd = self.sketch_of(a2.read_index)
            queries.append((qv, qp, qd, self.reads[a2.read_index].shape[0],
                            -1))
        res = overlap_native.map_sketched_batch(
            idx, queries, overlap.ALIGN_DENSITY, MIN_OVERLAP, 5, 500, 4, 4,
            overlap.ALIGN_L, False, n_threads=self.n_threads)
        return [[overlap._bounds_from_chain_tuple(c, q[3], idx)
                 for c in chains]
                for q, chains in zip(queries, res)]


# -- pure-bounds helpers -----------------------------------------------------

def is_valid_overlap_alignment(b: overlap.Bounds, check_maxhang: bool):
    """ToBasespace2::isValidOverlapAlignment (hpp:3723-3812)."""
    if b.query_start == -1 or b.is_reversed:
        return False
    ql, qs, qe = b.query_length, b.query_start, b.query_end
    tl, ts, te = b.ref_length, b.ref_start, b.ref_end
    if ts < qs:
        return False
    tl5, tl3 = ts, tl - te  # is_reversed already rejected
    ext5 = qs if qs < tl5 else tl5
    ext3 = (ql - qe) if (ql - qe) < tl3 else tl3
    if check_maxhang:
        if ext5 > MAX_HANG or ext3 > MAX_HANG or \
                qe - qs < (qe - qs + ext5 + ext3) * INT_FRAC:
            return False
    if qs <= tl5 and ql - qe <= tl3:
        return False  # query contained
    if qs >= tl5 and ql - qe >= tl3:
        return False  # target contained
    if qe - qs + ext5 + ext3 < MIN_OVERLAP:
        return False
    if te - ts + ext5 + ext3 < MIN_OVERLAP:
        return False
    return True


def overlap_on_the_reference(a1: Mapping, a2: Mapping):
    """ToBasespace2::overlapOnTheReference (hpp:3849-3861)."""
    off = 1
    return (a2.contig_start > a1.contig_start + off
            and a2.contig_start < a1.contig_end - off
            and a2.contig_end > a1.contig_end + off)


def alignment_overlaps_read_paths(al: Mapping, read_paths):
    """ToBasespace2::alignmentOverlapExistingReadPath (hpp:3815-3837)."""
    for (_, start, end) in read_paths:
        if al.contig_start >= start and al.contig_end <= end:
            return True
        if al.contig_start <= start and al.contig_end >= end:
            return True
        if al.contig_start >= start and end - al.contig_start > 0:
            return True
        if al.contig_end <= end and al.contig_end - start > 0:
            return True
    return False


def subsample_mapped_reads(ii: int, alignments, used_coverage: int):
    """ToBasespace2::subsampleMappedReads (hpp:3167-3328)."""
    a1 = alignments[ii]
    contig_start, contig_end = a1.contig_start, a1.contig_end

    next_alignments = []
    for j in range(ii - 1, -1, -1):
        a2 = alignments[j]
        if a2.contig_end < a1.contig_start + 3:
            continue
        next_alignments.append(a2)
    for j in range(ii + 1, len(alignments)):
        a2 = alignments[j]
        if a2.contig_start + 3 > a1.contig_end:
            break
        next_alignments.append(a2)

    next_alignments.sort(key=lambda a: (a.match_score, a.read_index))

    n = contig_end - contig_start
    coverages = np.zeros(max(n, 1), np.int64)
    for al in next_alignments:
        a = max(0, al.contig_start - contig_start)
        b = min(n, al.contig_end - contig_start)
        if b > a:
            coverages[a:b] += 1

    removed = set()
    for al in next_alignments:
        a = max(0, al.contig_start - contig_start)
        b = min(n, al.contig_end - contig_start)
        if b <= a:
            continue
        seg = coverages[a:b]
        # isRemoveAllow true iff any in-range position exists
        if seg.shape[0] and (seg > used_coverage).all():
            removed.add(al.read_index)
            coverages[a:b] -= 1

    return [al for al in next_alignments if al.read_index not in removed]


def collect_low_high_depth_regions(coverages, contig_coverage):
    """ToBasespace2::collectLowHighDepthRegions (hpp:3475-3544).
    Returns list of (start, end_inclusive, is_low)."""
    min_coverage = 0
    if contig_coverage > 30:
        min_coverage = 1
    if contig_coverage > 70:
        min_coverage = 2
    if contig_coverage > 200:
        min_coverage = 3
    low = coverages <= min_coverage
    regions = []
    boundaries = np.flatnonzero(np.diff(low)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries - 1, [low.shape[0] - 1]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        regions.append((s, e, bool(low[s])))
    return regions


def is_chimeric(coverages, coverages_mapping, contig_coverage,
                used_coverage):
    """ToBasespace2::isChimeric (hpp:3331-3473)."""
    if coverages.shape[0] == 0:
        return False
    for (s, e, is_low) in collect_low_high_depth_regions(coverages,
                                                         contig_coverage):
        if is_low and (e - s) >= 200:
            if contig_coverage < 10:
                # supported-by-read check (CoverageRegion::isSupportedByRead)
                return bool((coverages_mapping[s:e] > 0).all())
            return True
    return False


# -- getPath / getBestSuccessor ----------------------------------------------

def get_best_successor(tiler: ContigTiler, alignments, i, read_index1,
                       alignment1, contig_coverage, used_alignments,
                       readindex_to_i, excluded, overlap_on_ref_only,
                       allow_erroneous):
    """ToBasespace2::getBestSuccessor (hpp:2223-2395). Returns Mapping or
    None; records the chosen Bounds in used_alignments."""
    next_alignments = []
    for j in range(i + 1, len(alignments)):
        a2 = alignments[j]
        if a2.read_index in excluded:
            continue
        if overlap_on_ref_only:
            if a2.contig_start > alignment1.contig_end:
                break
            if not overlap_on_the_reference(alignment1, a2):
                continue
        else:
            if a2.contig_start == alignment1.contig_start:
                continue
            if a2.contig_end < alignment1.contig_end:
                continue
            if a2.contig_start > alignment1.contig_end + 100:
                break
        next_alignments.append(a2)

    next_alignments.sort(key=lambda a: (-a.match_score, a.read_index))

    for a2 in next_alignments:
        r2 = a2.read_index
        all_alignments = tiler.pair_alignments(read_index1, r2)

        best = None
        min_length = 0
        for al in all_alignments:
            if not is_valid_overlap_alignment(al, not allow_erroneous):
                continue
            ln = min(al.query_end - al.query_start,
                     al.ref_end - al.ref_start)
            if ln > min_length:
                min_length = ln
                best = al
        if best is None:
            continue
        if not allow_erroneous and tiler.is_erroneous_read(
                readindex_to_i[r2], alignments, contig_coverage):
            continue
        used_alignments[(read_index1, r2)] = best
        spans.add("successors_accepted")
        return a2
    return None


def get_path(tiler: ContigTiler, read_paths, alignments, readindex_to_al,
             readindex_to_i, used_alignments, contig_coverage,
             max_contig_end):
    """ToBasespace2::getPath (hpp:1976-2219). Appends to read_paths entries
    (read_path list, contig_start, contig_end); returns found_start."""
    is_aggressive = False
    max_aggressive_contig_end = 0
    current = ([], 0, 0)
    excluded = set()

    start_i = 0
    best_start = None
    max_score = None
    min_contig_start = None
    for i, al in enumerate(alignments):
        if alignment_overlaps_read_paths(al, read_paths):
            continue
        if tiler.is_erroneous_read(readindex_to_i[al.read_index], alignments,
                                   contig_coverage):
            continue
        if min_contig_start is None:
            min_contig_start = al.contig_start
        if al.contig_start > min_contig_start:
            break
        if max_score is None or al.match_score > max_score:
            best_start = al
            max_score = al.match_score
            start_i = i
    if best_start is None:
        return False

    nb_failed = 0
    failed_contig_end = 0
    read_path = [best_start.read_index]

    i = start_i
    while i < len(alignments):
        alignment1 = alignments[i]
        read_index1 = read_path[-1]
        if read_index1 in excluded:
            i += 1
            continue

        last = get_best_successor(
            tiler, alignments, i, read_index1, alignment1, contig_coverage,
            used_alignments, readindex_to_i, excluded, True, is_aggressive)
        if last is None:
            last = get_best_successor(
                tiler, alignments, i, read_index1, alignment1,
                contig_coverage, used_alignments, readindex_to_i, excluded,
                False, is_aggressive)

        found = last is not None
        if found:
            if last.contig_end > max_aggressive_contig_end:
                is_aggressive = False
            read_path.append(last.read_index)
        if found and last.contig_end >= max_contig_end:
            found = False  # contig cannot be extended further

        if not found:
            if read_path:
                a_start = readindex_to_al[read_path[0]]
                a_end = readindex_to_al[read_path[-1]]
                if not current[0]:
                    current = (list(read_path), a_start.contig_start,
                               a_end.contig_end)
                elif a_end.contig_end > current[2]:
                    current = (list(read_path), a_start.contig_start,
                               a_end.contig_end)

            if last is not None and last.contig_end >= max_contig_end:
                break

            excluded.add(read_path[-1])
            read_path.pop()
            if alignment1.contig_end > failed_contig_end:
                nb_failed = 0
                failed_contig_end = alignment1.contig_end
            if not read_path:
                break
            nb_failed += 1
            if nb_failed > 10:
                if is_aggressive:
                    break
                if max_aggressive_contig_end == current[2]:
                    break
                is_aggressive = True
                max_aggressive_contig_end = current[2]
                nb_failed = 0
                excluded.clear()
                read_path = list(current[0])

        i = readindex_to_i[read_path[-1]] - 1
        i += 1

    if current[0]:
        read_paths.append(current)
    return True


# -- contig assembly from read paths ------------------------------------------

def compute_sequence_complexity(seq: np.ndarray, w: int = 64, step: int = 32):
    """CreateBaseContigsFunctor::computeSequenceComplexity (hpp:2783-2847):
    max window score over canonical trinucleotide counts (partial trailing
    windows included)."""
    codes, bad = _kmers.base_codes(seq)
    vals, _, valid = _kmers.canonical_kmers(codes, bad, 3)
    kmers = vals[valid].astype(np.int64)
    n = kmers.shape[0]
    if n == 0:
        return 0.0
    l = w - 2
    max_score = 0.0
    for ii in range(0, n, step):
        window = kmers[ii:ii + w]
        counts = np.bincount(window, minlength=64).astype(np.float64)
        score = float((counts * (counts - 1) / 2.0).sum() / (l - 1))
        if score > max_score:
            max_score = score
    return max_score


def is_highly_repetitive(seq: np.ndarray):
    """CreateBaseContigsFunctor::isHighlyRepetitive (hpp:2742-2780):
    returns -1 (super repetitive), 0 (fine), or the most abundant 21-mer
    count when the repeated fraction exceeds 0.4."""
    codes, bad = _kmers.base_codes(seq)
    vals, _, valid = _kmers.canonical_kmers(codes, bad, 21)
    kmers = vals[valid]
    if kmers.shape[0] == 0:
        return 0
    uniq, counts = np.unique(kmers, return_counts=True)
    repeated = counts[counts > 1].sum()
    frac = repeated / kmers.shape[0]
    if frac > 0.9:
        return -1
    if frac > 0.4:
        return int(counts.max())
    return 0


def compute_self_overlap(seq: np.ndarray, device,
                         min_span: int = MIN_OVERLAP):
    """CreateBaseContigsFunctor::computeSelfOverlap (hpp:2850-2916):
    longest same-strand prefix-suffix self-alignment length."""
    n = int(np.asarray(seq).shape[0])
    sk = overlap.sketch(seq, device)
    idx = overlap.SeqIndex()
    idx.add(0, n, sk)
    idx.build()
    best = 0
    for b in overlap.map_sketched(idx, *sk, n, min_span=min_span, max_occ=64,
                                  exclude_self_diag=True):
        if b.is_reversed:
            continue
        if b.query_start > 50:
            continue
        if n - b.ref_end > 50:
            continue
        length = max(b.query_end, n - b.ref_start)
        if length >= n:
            continue
        best = max(best, length)
    return best


def read_paths_to_contigs(tiler: ContigTiler, contig_minimizers,
                          is_circular_in, contig_coverage, read_paths,
                          used_alignments, readindex_to_al):
    """ToBasespace2::readPathsToContigs (hpp:2397-2739). Returns a list of
    (sequence bytes, is_circular, minimizer slice, read_path)."""
    out = []
    is_circular = is_circular_in and len(read_paths) <= 1
    if not read_paths:
        return out

    for (read_path, c_start, c_end) in read_paths:
        if len(read_path) == 1:
            seq = tiler.reads[read_path[0]]
            pieces = [seq]
        else:
            pieces = []
            current_len = 0
            for i in range(len(read_path) - 1):
                r1, r2 = read_path[i], read_path[i + 1]
                al = used_alignments.get((r1, r2))
                if al is None:
                    continue
                read2 = tiler.reads[r2]
                if i == 0:
                    pieces.append(tiler.reads[r1])
                    current_len = pieces[0].shape[0]
                prev_overhang = al.ref_length - al.ref_end
                if prev_overhang > 0:
                    # trim the assembled tail back to the junction anchor
                    target = current_len - prev_overhang
                    while pieces and target < current_len:
                        lastp = pieces[-1]
                        drop = current_len - target
                        if drop >= lastp.shape[0]:
                            current_len -= lastp.shape[0]
                            pieces.pop()
                        else:
                            pieces[-1] = lastp[:lastp.shape[0] - drop]
                            current_len -= drop
                tail = read2[al.query_end:]
                pieces.append(tail)
                current_len += tail.shape[0]
        seq = np.concatenate([p for p in pieces if p.shape[0]]) \
            if pieces else np.zeros(0, np.uint8)

        a_start = readindex_to_al[read_path[0]]
        oversize_start = a_start.read_start_real
        if a_start.is_reversed:
            oversize_start = (tiler.reads[a_start.read_index].shape[0]
                              - a_start.read_end_real)
        a_end = readindex_to_al[read_path[-1]]
        oversize_end = (tiler.reads[a_end.read_index].shape[0]
                        - a_end.read_end_real)
        if a_end.is_reversed:
            oversize_end = a_end.read_start_real

        if is_circular:
            # leave <=1000 bp of overlap for the contig trimmer (hpp:2506)
            oversize_start = oversize_start - 1000 if oversize_start > 1000 \
                else 0
            oversize_end = oversize_end - 1000 if oversize_end > 1000 else 0

        if oversize_start + oversize_end < seq.shape[0]:
            seq = seq[oversize_start: seq.shape[0] - oversize_end]
        else:
            seq = np.zeros(0, np.uint8)

        if seq.shape[0] < tiler.min_contig_length:
            continue
        if (compute_sequence_complexity(seq) > 8 and contig_coverage < 6
                and seq.shape[0] < 50000):
            continue

        is_invalid = False
        is_repetitive = False
        nb_iters = 0
        while True:
            most_abundant = is_highly_repetitive(seq)
            if most_abundant == -1 and contig_coverage < 10:
                is_invalid = True
                break
            if most_abundant != -1 and most_abundant < 20:
                break
            if seq.shape[0] < 1000:
                break
            remove = int(seq.shape[0] * 0.1)
            seq = seq[:seq.shape[0] - remove]
            nb_iters += 1
            is_repetitive = True
            if nb_iters > 1000:
                break
        spans.add("repeat_trims", nb_iters)
        if is_invalid or seq.shape[0] < tiler.min_contig_length:
            continue

        if is_repetitive:
            spans.add("self_overlap_calls")
            self_olap = compute_self_overlap(seq, tiler.device)
            if self_olap > 0:
                seq = seq[:seq.shape[0] - self_olap]
        if seq.shape[0] < tiler.min_contig_length:
            continue

        minimizers = contig_minimizers[c_start:c_end + 1]
        out.append((seq, is_circular, minimizers, list(read_path)))
    return out


def create_base_contig(tiler: ContigTiler, contig_minimizers, is_circular,
                       alignments_in):
    """CreateBaseContigsFunctor::operator() (hpp:1698-1971) for one contig.
    alignments_in: list of Mapping. Returns (pieces, contig_coverage) where
    pieces comes from read_paths_to_contigs."""
    with spans.span("tiling", rss=True) as s:
        s.add("alignments", len(alignments_in))
        if not alignments_in:
            return [], 0.0
        tiler.clear_contig_caches()

        n = len(contig_minimizers)
        depth = np.zeros(max(n, 1), np.int64)
        max_contig_end = 0
        for al in alignments_in:
            depth[al.contig_start: min(al.contig_end, n)] += 1
            max_contig_end = max(max_contig_end, al.contig_end)
        contig_coverage = float(depth[:n].sum() / max(n, 1))
        s.add("coverage", contig_coverage)
        if contig_coverage <= 1:
            return [], contig_coverage

        alignments = sorted(alignments_in, key=lambda a: (
            a.contig_start, a.contig_end, a.read_index))
        readindex_to_i = {a.read_index: i for i, a in enumerate(alignments)}
        readindex_to_al = {a.read_index: a for a in alignments}

        with spans.span("tiling.sketch") as sketch:
            tiler.prewarm_sketches([a.read_index for a in alignments])
            sketch.add("reads", len(alignments))

        read_paths = []
        used_alignments: dict = {}
        with spans.span("tiling.walk"):
            while True:
                if not get_path(tiler, read_paths, alignments,
                                readindex_to_al, readindex_to_i,
                                used_alignments, contig_coverage,
                                max_contig_end):
                    break

        with spans.span("tiling.contigs") as pieces_span:
            pieces = read_paths_to_contigs(
                tiler, contig_minimizers, is_circular, contig_coverage,
                read_paths, used_alignments, readindex_to_al)
            pieces_span.add("pieces", len(pieces))
        return pieces, contig_coverage
