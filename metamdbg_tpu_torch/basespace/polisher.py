"""Windowed POA contig polishing, faithful to ContigPolisher
(src/toBasespace/ContigPolisher.hpp:122-2868).

Two polishing passes per partition (execute2, hpp:249-278). Each pass:
map partition reads to the current contigs (overlap.py plays minimap2
map-ont/map-hifi; maximal-mapping + non-overlapping best-alignment
selection per read, hpp:1155-1425), split contigs into 500 bp windows,
cut read fragments at window boundaries (racon's find_breaking_points,
here computed from exact-match seed anchors, hpp:1550-1795), cap each
window at 100 fragments with the reference's eviction rules
(hpp:1798-2094), POA each window (native spoa-semantics engine,
native/poa.cpp) with coverage trim (hpp:2458-2724), and re-assemble +
validate contigs (hpp:2744-2868).

The port of metamdbg_tpu/basespace/polisher.py. Sketches come from kernel
K1 on `device` (contigs, and reads the tiler did not sketch, one batch
each); mapping, window cutting and POA are the native engines
(native/overlap.cpp, window_cut.cpp, poa.cpp) on `n_threads` Python
threads, each batch packed once in Python and run in ranges. The
JAX package's fork-pool fallbacks and its Python window-cut oracle
(find_breaking_points) are not ported; the POA batch goes to the native
engine directly (one GPU, one host: no multi-host sharding).
"""

import logging

import numpy as np

from ..parallel.polish_mesh import polish_windows_distributed
from ..utils import spans, threadmap
from . import overlap, overlap_native, window_cut_native

log = logging.getLogger("metamdbg_tpu_torch")

WINDOW_LEN = 500                       # hpp:134
WINDOW_VARIANCE = int(WINDOW_LEN * 0.02)  # hpp:135
MAX_WINDOW_COPIES = 100                # hpp:136
QUALITY_THRESHOLD = 10.0               # hpp:137
MAX_MAPPING_OFFSET = 300               # hpp:17


class Alignment:
    """ContigPolisher's Alignment (src/Commons.hpp:385-433)."""

    __slots__ = ("contig_index", "read_index", "read_start", "read_end",
                 "contig_start", "contig_end", "identity", "read_length",
                 "contig_length", "anchors")

    def __init__(self, contig_index, read_index, read_start, read_end,
                 contig_start, contig_end, identity, read_length,
                 contig_length, anchors):
        self.contig_index = contig_index
        self.read_index = read_index
        self.read_start = read_start
        self.read_end = read_end
        self.contig_start = contig_start
        self.contig_end = contig_end
        self.identity = identity
        self.read_length = read_length
        self.contig_length = contig_length
        self.anchors = anchors  # (q, t) ascending exact-match seeds

    def score(self):
        return min(self.read_end - self.read_start,
                   self.contig_end - self.contig_start) * self.identity

    def is_maximal_mapping(self, max_overhang):
        return ((self.read_start < max_overhang
                 or self.contig_start < max_overhang)
                and (self.read_end + max_overhang > self.read_length
                     or self.contig_end + max_overhang > self.contig_length))


def _alignment_overlaps(a: Alignment, b: Alignment, allowed: int = 500):
    """alignmentOverlapExistingAlignment (hpp:1401-1425), read coords."""
    if a.read_start >= b.read_start and a.read_end <= b.read_end:
        return True
    if a.read_start <= b.read_start and a.read_end >= b.read_end:
        return True
    if a.read_start >= b.read_start and b.read_end - a.read_start > allowed:
        return True
    if a.read_end <= b.read_end and a.read_end - b.read_start > allowed:
        return True
    return False


def _index_read_alignment(existing: list, al: Alignment):
    """indexReadAlignment (hpp:1340-1399).

    Equal-score tie-break divergence (r5, VERDICT r4 #6): the reference's
    tie comparator (`_readIndex >`) compares a read against itself and
    never fires, so its winner is minimap2's arrival order — not a rule we
    can reproduce. For identical repeat copies this decides which contig
    the ambiguous reads polish AND the coverage ContigDerep sees: in the
    reference the small duplicate copy ends up starved (< cov/2 of the
    primary) and dereplicated; our engine listed the small copy first, so
    it kept the reads and survived (0.53 Gbp ONT: 10 vs 7 contigs). We
    break score ties deterministically toward the LONGER target contig,
    which reproduces the reference's observed outcome."""
    if not existing:
        existing.append(al)
        return
    has_overlap = False
    for e in existing:
        if _alignment_overlaps(al, e):
            if al.score() < e.score():
                return  # overlapWithBetterAlignment
            has_overlap = True
    is_better = False
    kept = []
    for e in existing:
        if _alignment_overlaps(al, e) and (
                al.score() > e.score()
                or (al.score() == e.score()
                    and al.contig_length > e.contig_length)):
            is_better = True
        else:
            kept.append(e)
    existing[:] = kept
    if is_better or not has_overlap:
        existing.append(al)


def map_reads_to_contigs(contigs: dict, reads: list, device,
                         read_sketches=None, n_threads: int = 1):
    """MapReadsFunctor + loadAllAlignments_read2 (hpp:451-618,1155-1245).

    contigs: contig_index -> sequence (np.uint8); reads: list of
    (read_index, seq, qual|None). Returns read_index -> [Alignment]: one
    native batch map over all reads."""
    index = overlap.SeqIndex()
    for (cid, seq), sk in zip(contigs.items(), overlap.sketch_many(
            list(contigs.values()), device)):
        index.add(cid, seq.shape[0], sk)
    index.build()

    queries = []
    missing = []
    for (read_index, seq, _qual) in reads:
        if read_sketches is not None and read_index in read_sketches:
            v, p, d = read_sketches[read_index]
            queries.append((v, p, d, seq.shape[0], -1))
        else:
            queries.append(None)
            missing.append((len(queries) - 1, seq))
    for (qi, seq), (v, p, d) in zip(missing, overlap.sketch_many(
            [seq for _, seq in missing], device)):
        queries[qi] = (v, p, d, seq.shape[0], -1)
    per_query = overlap_native.map_sketched_batch(
        index, queries, index.density, 500, 64, 500, 4, 4, overlap.ALIGN_L,
        n_threads=n_threads)
    all_alignments: dict = {}
    for (read_index, seq, _qual), chains in zip(reads, per_query):
        for c in chains:
            b = overlap._bounds_from_chain_tuple(c, seq.shape[0], index)
            if b.is_reversed:
                continue  # partition reads are contig-oriented (hpp:1193)
            mappable = b.mappable_length()
            identity = b.nb_matches / max(1, mappable)
            al = Alignment(b.tid, read_index, b.query_start, b.query_end,
                           b.ref_start, b.ref_end, identity, b.query_length,
                           b.ref_length, b.anchors)
            if not al.is_maximal_mapping(MAX_MAPPING_OFFSET):
                continue
            _index_read_alignment(all_alignments.setdefault(read_index, []),
                                  al)
    return all_alignments


def compute_contig_coverages(contigs: dict, all_alignments: dict):
    """computeContigCoveragesAll (hpp:620-691)."""
    intervals: dict = {cid: [] for cid in contigs}
    for als in all_alignments.values():
        for al in als:
            intervals.setdefault(al.contig_index, []).append(
                (al.contig_start, al.contig_end))
    coverages = {}
    for cid, seq in contigs.items():
        n = seq.shape[0]
        cov = np.zeros(n, np.int64)
        for (a, b) in intervals.get(cid, []):
            if a >= n:
                continue
            cov[a:min(b, n)] += 1
        if n < 160:
            coverages[cid] = 1.0
        else:
            coverages[cid] = float(cov[75:n - 75].sum() / n)
    return coverages


class Window:
    """ContigPolisher::Window (hpp:51-79)."""

    __slots__ = ("seq", "qual", "pos_start", "pos_end", "score", "_hash")

    def __init__(self, seq: bytes, qual, pos_start: int, pos_end: int,
                 score: float, hash_val: int | None = None):
        self.seq = seq
        self.qual = qual
        self.pos_start = pos_start
        self.pos_end = pos_end
        self.score = score
        if hash_val is not None:  # prefix-sum fast path (same value)
            self._hash = int(hash_val)
        elif qual:
            self._hash = int((np.frombuffer(seq, np.uint8).astype(np.uint64)
                              * np.frombuffer(qual, np.uint8)).sum())
        else:
            self._hash = int(np.frombuffer(seq, np.uint8).astype(
                np.uint64).sum())

    def hash(self):
        return self._hash


# boundary regions are at most a window plus change; the cutter drops (and
# counts) a fragment whose DP span exceeds this (inconsistent anchors)
_NW_MAX_M = 4 * WINDOW_LEN


def index_window(windows: list, window: Window):
    """Window-pool insertion with eviction (indexWindow, hpp:1798-2094)."""
    if MAX_WINDOW_COPIES == 0 or len(windows) < MAX_WINDOW_COPIES - 1:
        windows.append(window)
        return

    is_incomplete = abs(len(window.seq) - WINDOW_LEN) > WINDOW_VARIANCE
    current_distance = abs(len(window.seq) - WINDOW_LEN)

    incomplete_index = -1
    larger_distance = 0
    for i, w in enumerate(windows):
        distance = abs(len(w.seq) - WINDOW_LEN)
        if distance < current_distance:
            continue
        if distance > WINDOW_VARIANCE:
            if distance > larger_distance:
                larger_distance = distance
                incomplete_index = i
            elif distance == larger_distance and incomplete_index >= 0 \
                    and w.hash() > windows[incomplete_index].hash():
                incomplete_index = i

    if incomplete_index != -1:
        if larger_distance == current_distance:
            if window.hash() < windows[incomplete_index].hash():
                windows[incomplete_index] = window
        else:
            windows[incomplete_index] = window
    elif not is_incomplete:
        lowest = 0
        lowest_score = None
        for i, w in enumerate(windows):
            if lowest_score is None or w.score < lowest_score:
                lowest_score = w.score
                lowest = i
            elif w.score == lowest_score and \
                    w.hash() > windows[lowest].hash():
                lowest = i
        if window.score == lowest_score:
            if window.hash() < windows[lowest].hash():
                windows[lowest] = window
        elif lowest_score is not None and window.score > lowest_score:
            windows[lowest] = window


def trim_consensus(seq: bytes, coverages: np.ndarray, nb_sequences: int,
                   is_last_window: bool):
    """trimConsensus (hpp:2687-2724)."""
    trimmed = b""
    average_coverage = nb_sequences // 2
    while True:
        n = len(seq)
        begin = 0
        while begin < n and coverages[begin] < average_coverage:
            begin += 1
        end = n - 1
        while end >= 0 and coverages[end] < average_coverage:
            end -= 1
        if begin < end:
            trimmed = seq[begin:end + 1]
        if is_last_window:
            break
        if len(trimmed) > WINDOW_LEN * 0.8:
            break
        average_coverage += 1
        if average_coverage > nb_sequences:
            return seq
    return trimmed


def polish_pass(contigs: dict, headers: dict, reads: list,
                min_contig_length: int, min_contig_coverage: float,
                final_headers: bool, device, n_threads: int = 1,
                read_sketches=None, restrict=None, group=None):
    """One polishPartition pass (hpp:281-448). contigs: cid -> uint8 seq;
    headers: cid -> (orig_index, is_circular); reads: [(idx, seq, qual)].
    Returns (new contigs dict, new headers dict, coverages, header strings,
    changed) where `changed` maps cid -> [(start, end)] OUTPUT intervals
    whose consensus differs from the input backbone.

    `restrict`: optional cid -> [(start, end)] input intervals. Windows
    outside every interval short-circuit to their backbone (the targeted
    refinement pass re-polishes only regions the previous pass was still
    changing); contigs with no active window pass through unfiltered.
    With `group` (two or more ranks), the window POAs fan out over the
    ranks (parallel/polish_mesh.py).
    """
    with spans.span("polish.map") as s_map:
        all_alignments = map_reads_to_contigs(contigs, reads, device,
                                              read_sketches=read_sketches,
                                              n_threads=n_threads)
        contig_coverages = compute_contig_coverages(contigs, all_alignments)
        s_map.add("reads", len(reads))
        s_map.add("alignments", sum(len(v) for v in all_alignments.values()))

    with spans.span("polish.cut") as s_cut:
        # collect window fragments
        window_seqs: dict = {cid: [[] for _ in range(
            int(np.ceil(seq.shape[0] / WINDOW_LEN)))]
            for cid, seq in contigs.items()}
        read_map = {r[0]: r for r in reads}

        active: dict | None = None
        if restrict is not None:
            active = {}
            for cid, seq in contigs.items():
                n_windows = len(window_seqs[cid])
                mask = np.zeros(n_windows, bool)
                for (s, e) in restrict.get(cid, ()):
                    w0 = max(0, int(s) // WINDOW_LEN)
                    w1 = min(n_windows, int(e) // WINDOW_LEN + 1)
                    mask[w0:w1] = True
                active[cid] = mask

        # filtered (read, alignment) work list, oracle iteration order
        items = []
        for read_index, als in all_alignments.items():
            _, seq, qual = read_map[read_index]
            for al in als:
                if al.contig_index not in contigs:
                    continue
                contig_len = contigs[al.contig_index].shape[0]
                if al.contig_start >= contig_len:
                    continue
                al.contig_end = min(al.contig_end, contig_len)
                if al.identity < 0.9:
                    continue
                items.append((read_index, al, seq, qual))

        cut_items = [(seq, al) for (_, al, seq, _) in items
                     if al.anchors is not None and al.anchors[0].shape[0]]
        cuts = window_cut_native.window_cut_batch(
            cut_items, contigs, WINDOW_LEN, overlap.ALIGN_L, _NW_MAX_M,
            n_threads=n_threads) if cut_items else []
        s_cut.add("alignments", len(cut_items))

    with spans.span("polish.index") as s_index:
        ci = 0
        for (read_index, al, seq, qual) in items:
            if al.anchors is None or al.anchors[0].shape[0] == 0:
                continue
            fq_a, lq_a, ft_a, lt_a, dropped = cuts[ci]
            ci += 1
            for _ in range(dropped):
                log.warning("window cut DP span exceeds %d (inconsistent "
                            "anchors); fragment dropped", _NW_MAX_M)
            identity = al.identity
            pool = window_seqs[al.contig_index]
            for fq, lq, ft, lt in zip(fq_a.tolist(), lq_a.tolist(),
                                      ft_a.tolist(), lt_a.tolist()):
                wid = ft // WINDOW_LEN
                if wid >= len(pool):
                    continue
                if active is not None and not active[al.contig_index][wid]:
                    continue
                frag_seq = seq[fq:lq]
                if qual is not None:
                    frag_q = qual[fq:lq]
                    q_sum = int(frag_q.sum(dtype=np.int64))
                    avg_q = q_sum / (lq - fq) - 33.0
                    if avg_q < QUALITY_THRESHOLD:
                        continue
                    hash_val = int((frag_seq.astype(np.int64) * frag_q).sum())
                    frag_qual = frag_q.tobytes()
                else:
                    hash_val = int(frag_seq.sum(dtype=np.int64))
                    frag_qual = None
                ws = wid * WINDOW_LEN
                index_window(pool[wid],
                             Window(frag_seq.tobytes(), frag_qual, ft - ws,
                                    lt - ws - 1, identity,
                                    hash_val=hash_val))
        if spans.recording():
            s_index.add("fragments", sum(
                len(w) for pool in window_seqs.values() for w in pool))

    with spans.span("polish.poa") as s_poa:
        # POA per window (batched through the native engine)
        batch = []
        keys = []
        results: dict = {}
        with threadmap.packing("poa"):
            for cid, contig_windows in window_seqs.items():
                seq = contigs[cid]
                for wid, windows in enumerate(contig_windows):
                    ws = wid * WINDOW_LEN
                    we = min(seq.shape[0], ws + WINDOW_LEN)
                    backbone = seq[ws:we].tobytes()
                    if active is not None and not active[cid][wid]:
                        results[(cid, wid)] = backbone
                        continue
                    if len(windows) < 2:
                        results[(cid, wid)] = backbone
                        continue
                    windows.sort(key=lambda w: (w.pos_start, w.hash()))
                    frags = [(w.seq, w.qual, w.pos_start, w.pos_end)
                             for w in windows]
                    batch.append((backbone, frags))
                    keys.append((cid, wid, len(windows),
                                 wid == len(contig_windows) - 1))

        if batch:
            for (cid, wid, nseq, is_last), (cons, covs) in zip(
                    keys, polish_windows_distributed(
                        batch, n_threads=n_threads, group=group)):
                results[(cid, wid)] = trim_consensus(cons, covs, nseq,
                                                     is_last)
        s_poa.add("windows", len(batch))
        s_poa.add("threads", n_threads)

    # reassemble + validate (dumpCorrectedContig, hpp:2744-2868)
    with spans.span("polish.stitch") as s_stitch:
        out_contigs: dict = {}
        out_headers: dict = {}
        header_strings: dict = {}
        changed: dict = {}
        for cid, contig_windows in window_seqs.items():
            seq = contigs[cid]
            parts = []
            out_off = 0
            cid_changed = []
            for wid in range(len(contig_windows)):
                part = results[(cid, wid)]
                ws = wid * WINDOW_LEN
                backbone = seq[ws:min(seq.shape[0],
                                      ws + WINDOW_LEN)].tobytes()
                if part != backbone:
                    cid_changed.append((out_off, out_off + len(part)))
                parts.append(part)
                out_off += len(part)
            contig_seq = b"".join(parts)
            length = len(contig_seq)
            coverage = contig_coverages.get(cid, 0.0)
            passthrough = (active is not None and not active[cid].any())
            if not passthrough:
                if coverage <= min_contig_coverage:
                    continue
                if length < min_contig_length:
                    continue
                if length < 7500 and coverage < 4:
                    continue
            orig_index, is_circular = headers[cid]
            out_contigs[cid] = np.frombuffer(contig_seq, np.uint8)
            out_headers[cid] = (orig_index, is_circular)
            if cid_changed:
                changed[cid] = cid_changed
            if final_headers:
                circ = "yes" if is_circular else "no"
                header_strings[cid] = (f"ctg{orig_index} length={length} "
                                       f"coverage={coverage:.2f} "
                                       f"circular={circ}")
        s_stitch.add("contigs", len(out_contigs))
    pack_poa = s_poa.counts.get("pack.poa", 0.0)
    log.info("  polish pass timing: map %.1fs (pack %.1fs) cut %.1fs "
             "(pack %.1fs) index %.1fs pack %.1fs poa %.1fs stitch %.1fs "
             "(%d windows, %d fragments, %d threads)",
             s_map.seconds, s_map.counts.get("pack.map", 0.0),
             s_cut.seconds, s_cut.counts.get("pack.cut", 0.0),
             s_index.seconds, pack_poa, s_poa.seconds - pack_poa,
             s_stitch.seconds, len(batch), len(items), n_threads)
    return (out_contigs, out_headers, contig_coverages, header_strings,
            changed)
