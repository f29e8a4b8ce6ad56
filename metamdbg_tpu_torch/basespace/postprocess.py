"""Final-pass minimizer-space post-processing:
derepSmall -> removeOverlaps -> removeRepeats.

The port of metamdbg_tpu/basespace/postprocess.py, itself after
src/toBasespace/DerepSmallContigs.hpp, OverlapRemover2.hpp and
RepeatRemover.hpp (single-thread write order). The walks are host numpy and
Python, as there; the k-min-mer hash keys of every contig of a stage are
computed in one kernel KW launch on `device` (kernels/window_hash.py), and
a contig trimmed in removeOverlaps reads its keys as a slice of its
untrimmed ones (a window inside the slice hashes the same).
"""

import dataclasses
import os
import struct

import numpy as np
import torch

from ..count import kminmers
from ..graph import gio
from ..io import records
from . import chaining


def _write_record(f, minimizers: np.ndarray, is_circular: int):
    f.write(struct.pack("<IB", minimizers.shape[0], is_circular))
    f.write(np.asarray(minimizers, np.uint32).tobytes())


def kminmer_hash_keys(seqs, k: int, device) -> list:
    """Per sequence, the (n - k + 1, 2) u64 [h1, h2] hash128 keys of its
    normalized k-windows in position order (metamdbg_tpu's
    postprocess._kminmer_hash_keys), all in one KW launch."""
    if not seqs:
        return []
    seqs = [np.asarray(s, np.uint32) for s in seqs]
    h1, h2, offsets = kminmers.flat_window_hashes(seqs, k,
                                                  torch.device(device))
    keys = torch.stack([h1, h2], dim=1).cpu().numpy().view(np.uint64)
    offs = offsets.cpu().numpy()
    return [keys[offs[i]:offs[i + 1]] for i in range(len(seqs))]


def _key_tuples(keys: np.ndarray):
    return map(tuple, keys.tolist())


# ---------------------------------------------------------------------------
# derepSmall (DerepSmallContigs.hpp:182-1629)
# ---------------------------------------------------------------------------

def run_derep_small(out_dir: str, params: records.Parameters, first_k: int,
                    last_k: int):
    contig_file = os.path.join(out_dir, "contig_data_init.txt")
    out_file = os.path.join(out_dir, "contig_data_init_small.txt")

    index = chaining.PairIndex()
    for rec in records.read_read_data(contig_file, with_quality=False):
        index.add(rec.index, rec.minimizers)
    index.build()

    with open(out_file, "wb") as out:
        # small contigs per multiplex pass, k ascending
        for k in range(first_k, last_k + 1):
            path = os.path.join(out_dir, "smallContigs",
                                f"smallContigs_k{k}.bin")
            if not os.path.exists(path):
                continue
            for rec in records.read_read_data(path, with_quality=False):
                n_kminmers = max(0, rec.minimizers.shape[0] - 2 + 1)
                best = chaining.best_mapping(index, rec.minimizers)
                drop = (best is not None
                        and (n_kminmers - best[1].n_matches) <= 3)
                if not drop and rec.minimizers.shape[0] > 0:
                    _write_record(out, rec.minimizers, 0)
        # append long contigs verbatim
        for rec in records.read_read_data(contig_file, with_quality=False):
            _write_record(out, rec.minimizers, 1 if rec.is_circular else 0)


# ---------------------------------------------------------------------------
# removeOverlaps (OverlapRemover2.hpp:165-770)
# ---------------------------------------------------------------------------

def run_remove_overlaps(out_dir: str, params: records.Parameters, device):
    # the stage works at k = firstK-1 (OverlapRemover2.hpp:149)
    k = params.kminmer_size_first - 1
    in_file = os.path.join(out_dir, "contig_data_init_small.txt")
    out_file = in_file + ".nooverlaps"

    contigs = list(records.read_read_data(in_file, with_quality=False))
    sizes = [c.minimizers.shape[0] for c in contigs]
    all_keys = kminmer_hash_keys([c.minimizers for c in contigs], k, device)

    # kminmer hash -> [(contigIndex, positionIndex)]
    table: dict = {}
    for c, keys in zip(contigs, all_keys):
        for i, key in enumerate(_key_tuples(keys)):
            table.setdefault(key, []).append((c.index, i))

    with open(out_file, "wb") as out:
        for c, keys0 in zip(contigs, all_keys):
            minimizers = np.asarray(c.minimizers, np.uint32)
            lo = 0  # minimizers == c.minimizers[lo:lo + len(minimizers)]
            dropped = False
            while True:
                keys = keys0[lo:lo + max(0, minimizers.shape[0] - k + 1)]
                left, right = _compute_overlaps(c.index, minimizers, keys,
                                                sizes, table, k)
                if left == 0 and right == 0:
                    break
                overlap_left = left + k - 1 if left > 0 else 0
                overlap_right = right + k - 1 if right > 0 else 0
                index_end = minimizers.shape[0] - overlap_right
                if overlap_left + overlap_right >= minimizers.shape[0] \
                        or overlap_left >= index_end:
                    dropped = True
                    break
                new_m = minimizers[overlap_left:index_end]
                if new_m.shape[0] <= k + 1:
                    dropped = True
                    break
                minimizers = new_m
                lo += overlap_left
            if dropped:
                continue
            minimizers = _remove_overlaps_self(minimizers)
            if minimizers.shape[0] > 0:
                _write_record(out, minimizers, 1 if c.is_circular else 0)


def _compute_overlaps(ref_index, minimizers, keys, sizes, table, k):
    """computeOverlaps (OverlapRemover2.hpp:395-560); `keys` are the
    minimizers' k-min-mer hash keys."""
    ref_len = minimizers.shape[0]
    per_query: dict = {}
    for i, key in enumerate(_key_tuples(keys)):
        hits = table.get(key)
        if not hits:
            continue
        for (q_index, q_pos) in hits:
            if q_index == ref_index:
                continue
            if sizes[q_index] < ref_len:
                continue
            per_query.setdefault(q_index, []).append((i, q_pos))

    left = right = 0
    for q_index, anchors in per_query.items():
        anchors.sort()
        left = max(left, _max_overlap_left(anchors))
        right = max(right, _max_overlap_right(anchors, ref_len, k))
    return left, right


def _max_overlap_left(anchors):
    """getMaxOverlapLeft (OverlapRemover2.hpp:562-604)."""
    best = 0
    for i in range(len(anchors)):
        rp, qp = anchors[i]
        if rp > 0:
            break
        cur_r, cur_q = rp, qp
        run = 1
        for j in range(i + 1, len(anchors)):
            rj, qj = anchors[j]
            if rj - cur_r > 1:
                break
            if rj == cur_r + 1 and (qj == cur_q + 1 or qj == cur_q - 1):
                run += 1
                cur_r, cur_q = rj, qj
        best = max(best, run)
    return best


def _max_overlap_right(anchors, ref_len, k):
    """getMaxOverlapRight (OverlapRemover2.hpp:608-655)."""
    best = 0
    last_pos = ref_len - 1 - k + 1
    for i in range(len(anchors) - 1, -1, -1):
        rp, qp = anchors[i]
        if rp != last_pos:
            break
        cur_r, cur_q = rp, qp
        run = 1
        for j in range(i - 1, -1, -1):
            rj, qj = anchors[j]
            if cur_r - rj > 1:
                break
            if rj == cur_r - 1 and (qj == cur_q + 1 or qj == cur_q - 1):
                run += 1
                cur_r, cur_q = rj, qj
        best = max(best, run)
    return best


def _remove_overlaps_self(minimizers: np.ndarray) -> np.ndarray:
    """KMP longest-prefix-suffix trim (OverlapRemover2.hpp:685-760)."""
    m = minimizers
    n = m.shape[0]
    if n == 0:
        return m
    lps = np.zeros(n, np.int64)
    length = 0
    i = 1
    while i < n:
        if m[i] == m[length]:
            length += 1
            lps[i] = length
            i += 1
        elif length != 0:
            length = lps[length - 1]
        else:
            lps[i] = 0
            i += 1
    trim = int(lps[n - 1]) - 1
    if trim <= 0:
        return m
    return m[:n - trim]


# ---------------------------------------------------------------------------
# ReadVsContigMapper (src/toBasespace/ReadVsContigMapper.hpp)
# ---------------------------------------------------------------------------

def run_read_vs_contig_mapper(read_file: str, contig_file: str,
                              output_file: str):
    index = chaining.PairIndex()
    for rec in records.read_read_data(contig_file, with_quality=False):
        index.add(rec.index, rec.minimizers)
    index.build()

    with open(output_file, "wb") as out:
        for rec in records.read_read_data(read_file, with_quality=True):
            best = chaining.best_mapping(index, rec.minimizers)
            if best is None:
                continue
            ref, chain = best
            out.write(struct.pack(
                "<IIIIIIBiIII", rec.index, ref, chain.query_start,
                chain.query_end, chain.reference_start, chain.reference_end,
                1 if chain.is_reversed else 0, chain.n_matches, 0, 0,
                rec.read_length))


def read_alignments(path: str):
    """ReadMapping2 records (src/Commons.hpp:344-381)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    rec = struct.Struct("<IIIIIIBiIII")
    off = 0
    while off + rec.size <= len(data):
        out.append(rec.unpack_from(data, off))
        off += rec.size
    return out


# ---------------------------------------------------------------------------
# removeRepeats (RepeatRemover.hpp:221-1670)
# ---------------------------------------------------------------------------

def run_remove_repeats(out_dir: str, params: records.Parameters, device):
    # the stage works at k = firstK+1 (RepeatRemover.hpp:179)
    params = dataclasses.replace(params,
                                 kminmer_size=params.kminmer_size_first + 1)
    k = params.kminmer_size
    in_file = os.path.join(out_dir, "contig_data_init_small.txt.nooverlaps")
    out_file = os.path.join(out_dir, "contig_data_init_small.txt.norepeats")
    aln_file = os.path.join(out_dir, "readsVsContigsAlignments.bin")

    run_read_vs_contig_mapper(os.path.join(out_dir, "read_data_init.txt"),
                              in_file, aln_file)

    # unitig index: kminmer -> unitigIndex from unitig_data.txt.init.k<k>
    unitig_index: dict = {}
    unitig_file = os.path.join(out_dir, f"unitig_data.txt.init.k{k}")
    if os.path.exists(unitig_file):
        unitigs = list(records.read_read_data(unitig_file,
                                              with_quality=False))
        for rec, keys in zip(unitigs, kminmer_hash_keys(
                [u.minimizers for u in unitigs], k, device)):
            for key in _key_tuples(keys):
                unitig_index[key] = rec.index

    # abundance index from kminmerData_abundance_init_k<k>.txt
    abundance: dict = {}
    ab_file = os.path.join(out_dir, f"kminmerData_abundance_init_k{k}.txt")
    if os.path.exists(ab_file):
        keys, counts = gio.read_kminmer_abundances(ab_file)
        for key, cnt in zip(_key_tuples(keys), counts.tolist()):
            if cnt <= 1:
                continue
            abundance[key] = cnt

    # alignments per contig
    contig_alignments: dict = {}
    for al in read_alignments(aln_file):
        contig_alignments.setdefault(al[1], []).append((al[4], al[5]))

    contigs = list(records.read_read_data(in_file, with_quality=False))
    all_keys = kminmer_hash_keys([c.minimizers for c in contigs], k, device)
    with open(out_file, "wb") as out:
        for rec, keys in zip(contigs, all_keys):
            pieces, is_circ = _break_unbridged_repeats(
                rec, keys, unitig_index, abundance,
                contig_alignments.get(rec.index, []), params)
            for piece in pieces:
                if piece.shape[0] > 0:
                    _write_record(out, piece, is_circ)

    for name in (in_file + ".fragments", in_file + ".fragments.coverage",
                 aln_file):
        if os.path.exists(name):
            os.remove(name)


def _fragment_contig(key_list, unitig_index):
    """FragmentFunctor (RepeatRemover.hpp:650-707): split at unitig borders."""
    n = len(key_list)
    fragments = []
    last_unitig = -1
    start = 0
    for i, key in enumerate(key_list):
        u = unitig_index.get(key, -1)
        if u != last_unitig or i == n - 1:
            last_unitig = u
            if i == 0:
                continue
            end = i - 1
            if i == n - 1:
                end = n - 1
            fragments.append((start, end))
            start = i
    return fragments


def _break_unbridged_repeats(rec, keys, unitig_index, abundance, alignments,
                             params):
    """BreakUnbridgedRepeatsFunctor (RepeatRemover.hpp:1099-1326); `keys`
    are the contig's k-min-mer hash keys."""
    k = params.kminmer_size
    minimizers = np.asarray(rec.minimizers, np.uint32)
    is_circ = 1 if rec.is_circular else 0
    if is_circ:
        return [minimizers], is_circ

    key_list = list(_key_tuples(keys))
    raw_fragments = _fragment_contig(key_list, unitig_index)
    if not raw_fragments:
        return [minimizers], is_circ
    if not alignments:
        return [minimizers], is_circ

    fragments = []
    for fi, (start, end) in enumerate(raw_fragments):
        s = 0.0
        n = 0
        for j in range(start, end + 1):
            s += abundance.get(key_list[j], 1)
            n += 1
        cov = float(np.float32(s / n)) if n else 0.0
        fragments.append({
            "index": fi, "start": start, "end": end,
            "length": end - start + 1, "coverage": cov,
            "final": -1, "bridges": {},
        })

    # bridging reads (hpp:1329-1371)
    for (a_start, a_end) in alignments:
        mapped = []
        for f in fragments:
            if a_start < f["start"] and a_end > f["end"]:
                mapped.append(f["index"])
            elif f["start"] < a_start < f["end"]:
                mapped.append(f["index"])
            elif f["start"] < a_end < f["end"]:
                mapped.append(f["index"])
        if len(mapped) <= 1:
            continue
        for i in range(len(mapped)):
            for j in range(i + 1, len(mapped)):
                f1, f2 = fragments[mapped[i]], fragments[mapped[j]]
                f1["bridges"][f2["index"]] = \
                    f1["bridges"].get(f2["index"], 0) + 1
                f2["bridges"][f1["index"]] = \
                    f2["bridges"].get(f1["index"], 0) + 1

    density = np.float32(params.density_assembly)
    paths = []
    for f in fragments:
        if f["length"] * (1 / density) < 10000:
            continue
        paths.append(_get_cov_path(f, fragments))
    paths.sort(key=lambda p: p[1] - p[0])

    for i, (lo, hi) in enumerate(paths):
        for j in range(lo, hi + 1):
            if fragments[j]["final"] == -1:
                fragments[j]["final"] = i

    current = fragments[0]["final"]
    fragments.append({"index": len(fragments), "start": 0, "end": 0,
                      "length": 0, "coverage": 0, "final": -2, "bridges": {}})

    nb_final = 0
    for f in fragments:
        if f["final"] != current:
            current = f["final"]
            nb_final += 1
    if nb_final > 1:
        is_circ = 0

    contigs = []
    start_pos = 0
    current = fragments[0]["final"]
    for i, f in enumerate(fragments):
        if f["final"] != current:
            end_pos = fragments[i - 1]["end"]
            contigs.append(minimizers[start_pos: end_pos + k])
            start_pos = f["start"]
            current = f["final"]
    return contigs, is_circ


def _get_cov_path(source, fragments):
    """getCovPath (RepeatRemover.hpp:1375-1462)."""
    source_cov = source["coverage"]
    current_cov = source_cov
    lo = hi = 0
    while True:
        loop_cov = current_cov
        hi, current_cov = _cov_path_dir(source, fragments, current_cov,
                                        source_cov, True)
        lo, current_cov = _cov_path_dir(source, fragments, current_cov,
                                        source_cov, False)
        if current_cov == loop_cov:
            break
    return lo, hi


def _cov_path_dir(source, fragments, source_cov, source_cov_init, forward):
    """getCovPath_direction (hpp:1410-1462): walk in one direction; if a
    reached fragment has higher (non-repeat) coverage, adopt it and signal a
    restart by returning index -1."""
    specific = [source["index"]]
    while True:
        nxt = _next_specific(fragments, specific, source_cov, forward)
        if nxt == -1:
            break
        f = fragments[nxt]
        if f["coverage"] > source_cov and \
                f["coverage"] < float(np.float32(source_cov_init * 1.5)):
            return -1, f["coverage"]
        specific.append(nxt)
    return specific[-1], source_cov


def _next_specific(fragments, specific, source_cov, forward):
    """getNextSpecificFragmentIndex (hpp:1464-1542)."""
    min_repeat_cov = float(np.float32(source_cov * 2.0))
    for ii in range(len(specific) - 1, -1, -1):
        src = fragments[specific[ii]]
        latest = specific[-1]
        rng = range(latest + 1, len(fragments)) if forward \
            else range(latest - 1, -1, -1)
        for i in rng:
            f = fragments[i]
            if f["coverage"] >= min_repeat_cov:
                continue
            adjacent = (src["index"] + 1 == f["index"]) if forward \
                else (src["index"] == f["index"] + 1)
            if adjacent:
                return i
            if src["bridges"].get(f["index"], 0) == 0:
                continue
            return i
    return -1
