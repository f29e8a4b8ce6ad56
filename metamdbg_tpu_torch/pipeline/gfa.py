"""`gfa` subcommand: export assembly graphs saved during multi-k passes.

Mirrors GenerateGfa (src/graph/GenerateGfa.hpp:134-230,414-560,653-786,883-1010)
+ ToBasespaceGfa (unitig base sequences rebuilt from the original reads):

- ``k=0``: list available checkpoints (k -> approx bp: 1/density*(k-1)+l);
- else write ``assemblyGraph_k<k>.gfa`` (S lines carry reconstructed unitig
  sequences, dp coverage; L lines carry base-space overlap sizes computed
  from the unitig sequence minimizers, GenerateGfa.hpp:395-406,540-580),
  ``assemblyGraph_k<k>.noseq.gfa`` (S sequences replaced by ``*``),
  ``assemblyGraph_k<k>_contigPath.tsv`` + ``_contigNames.csv`` (final contigs
  mapped onto the graph's unitigs, GenerateGfa.hpp:653-786 — v1.4 generates
  the contig path unconditionally, GenerateGfa.hpp:105-108);
- ``--coverage``: recompute unitig dp from k=4 k-min-mer abundances
  (GenerateGfa.hpp:883-1010).

The port of metamdbg_tpu/pipeline/gfa.py, byte for byte. The reads are
mapped to the unitigs and the drafts tiled on the host, as there; the
unitig sketch runs on kernel K1 (one BatchSketcher call over every draft)
and the k-min-mer keys on kernel KW, on `device`. A k-min-mer is looked up
by its 128-bit hash, which is its identity throughout the reference
(src/Commons.hpp:941-970), where the JAX package keys on the window's
bytes.
"""

import logging
import os

import numpy as np
import torch

from ..basespace import postprocess, reconstruct, tiling
from ..count import kminmers
from ..io import fastq, records
from ..io import gfa as gfa_io
from ..io.records import load_repetitive_minimizers
from ..sketch import kmers, rle
from ..sketch.batch import BatchSketcher
from . import open_device

log = logging.getLogger("metamdbg_tpu_torch")

ABUNDANCE_RECORD = np.dtype([("lo", "<u8"), ("hi", "<u8"), ("count", "<u4")])


def available_ks(tmp_dir: str) -> list:
    """getAvailableKValues (GenerateGfa.hpp:237-267): pass_k dirs holding an
    assembly_graph.gfa.unitigs file."""
    out = []
    for name in sorted(os.listdir(tmp_dir)):
        if name.startswith("pass_k") and os.path.exists(
                os.path.join(tmp_dir, name, "assembly_graph.gfa.unitigs")):
            out.append(int(name[len("pass_k"):]))
    return sorted(out)


def key_table(h1, h2, values, last: bool):
    """PairTable of the distinct (h1, h2) keys. A key seen more than once
    keeps the value of its last occurrence when `last` (a dict assignment)
    or of its first (dict.setdefault): the sort is stable."""
    if last:
        h1, h2, values = h1.flip(0), h2.flip(0), values.flip(0)
    order = kminmers.sort_pairs(h1, h2)
    h1, h2, values = h1[order], h2[order], values[order]
    head = kminmers.pair_heads(h1, h2)
    return kminmers.PairTable(h1[head], h2[head], values[head],
                              presorted=True)


def window_owner(offsets: torch.Tensor) -> torch.Tensor:
    """The sequence index of each window, from the window offsets."""
    n = offsets.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=offsets.device), offsets[1:] - offsets[:-1],
        output_size=int(offsets[-1]))


def _unitig_minimizers(sequences, params, repetitive, device):
    """LoadUnitigsFunctor (GenerateGfa.hpp:358-420): RLE + minimizer parse
    with _trimBps=0, every sequence in one BatchSketcher call (kernel K1);
    per sequence (minimizers, rle positions of each minimizer's original
    start, rle_positions array)."""
    rles = [rle.rle_encode(np.asarray(s, np.uint8),
                           params.use_homopolymer_compression)
            for s in sequences]
    if not rles:
        return []
    codes, bads = zip(*(kmers.base_codes(r) for r, _ in rles))
    sketcher = BatchSketcher(params.minimizer_size, params.density_assembly,
                             repetitive, device, trim=0)
    return [(mins, pos, rle_pos) for (mins, pos, _), (_, rle_pos) in
            zip(sketcher.sketch_many(list(codes), list(bads)), rles)]


def _unitig_overlaps(sequences, params, repetitive, device):
    """Base-space overlap spans of each unitig's two ends
    (GenerateGfa.hpp:395-406); (0, 0) for a missing sequence."""
    k = params.kminmer_size
    live = [i for i, s in enumerate(sequences) if s is not None]
    out = [(0, 0)] * len(sequences)
    parsed = _unitig_minimizers([sequences[i] for i in live], params,
                                repetitive, device)
    for i, (mins, pos, rle_pos) in zip(live, parsed):
        if mins.shape[0] < k:
            continue
        ovl_plus = int(len(sequences[i])) - int(
            rle_pos[int(pos[mins.shape[0] - k + 1])])
        ovl_minus = int(rle_pos[int(pos[k - 2]) + params.minimizer_size])
        out[i] = (ovl_plus, ovl_minus)
    return out


def _recomputed_coverages(tmp_dir: str, unitig_records, device) -> list:
    """computeUnitigCoverage (GenerateGfa.hpp:883-1010): mean k=4 k-min-mer
    abundance per unitig, missing k-min-mers counted as 1; 1.0 for a unitig
    with no k=4 window. The abundances are summed as exact integers, then
    divided once, as the JAX package's float64 sum of integers does."""
    path = os.path.join(tmp_dir, "kminmerData_abundance_init.txt")
    with open(path, "rb") as f:
        rec = np.frombuffer(f.read(), dtype=ABUNDANCE_RECORD)
    rec = rec[rec["count"] > 1]

    def column(name):
        return torch.from_numpy(np.ascontiguousarray(
            rec[name]).view(np.int64)).to(device)

    table = key_table(column("hi"), column("lo"),
                      torch.from_numpy(rec["count"].astype(np.int64))
                      .to(device), last=True)
    h1, h2, offsets = kminmers.flat_window_hashes(
        [r.minimizers for r in unitig_records], 4, device)
    counts, _ = table.lookup(h1, h2, 1)
    csum = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=csum[1:])
    totals = (csum[offsets[1:]] - csum[offsets[:-1]]).tolist()
    n_windows = (offsets[1:] - offsets[:-1]).tolist()
    return [float(t) / n if n else 1.0 for t, n in zip(totals, n_windows)]


def _paths(table, h1, h2, offsets):
    """Per sequence, the unitigs its windows walk through: each window
    looked up in the unitig table, windows missing from it skipped and
    consecutive repeats dropped (GenerateGfa.hpp:700-740)."""
    u, hit = table.lookup(h1, h2, -1)
    owner = window_owner(offsets)[hit]
    u = u[hit]
    keep = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    keep[1:] = (u[1:] != u[:-1]) | (owner[1:] != owner[:-1])
    u, owner = u[keep].cpu().numpy(), owner[keep].cpu().numpy()
    bounds = np.searchsorted(owner, np.arange(offsets.shape[0]))
    return [u[bounds[i]:bounds[i + 1]] for i in range(offsets.shape[0] - 1)]


def _walk_paths(unitig_records, walkers, k, device):
    """The unitig paths of each list of minimizer records in `walkers`:
    the unitigs' k-min-mers and the walkers' in one KW launch; a k-min-mer
    in several unitigs belongs to the last (the JAX package's dict
    overwrite in unitig order)."""
    seqs = [r.minimizers for r in unitig_records]
    for recs in walkers:
        seqs += [r.minimizers for r in recs]
    h1, h2, offsets = kminmers.flat_window_hashes(seqs, k, device)
    nu = len(unitig_records)
    cut = int(offsets[nu])
    table = key_table(h1[:cut], h2[:cut], window_owner(offsets[:nu + 1]),
                      last=True)
    out, start = [], nu
    for recs in walkers:
        end = start + len(recs)
        win = offsets[start:end + 1]
        a, b = int(win[0]), int(win[-1])
        out.append(_paths(table, h1[a:b], h2[a:b], win - a))
        start = end
    return out


def _generate_paths(tmp_dir: str, out_prefix: str, params, unitig_records,
                    utg_names: list, read_path: bool, device):
    """generateContigPath (GenerateGfa.hpp:653-786) and, with `read_path`,
    the path of each read (GenerateGfa::generateReadPath,
    GenerateGfa.hpp:796-876, dormant in the reference v1.4 binary, working
    here): walk each final contig's or read's k-min-mers, map them to the
    graph's unitigs (named per the GFA S line at the same position,
    _unitigOrderRev GenerateGfa.hpp:489), dedupe consecutive repeats.
    Returns (contig path and names files or None, read path file or
    None)."""
    contig_data = os.path.join(tmp_dir, "contig_data_final.bin")
    contigs = None
    if os.path.exists(contig_data):
        contigs = list(records.read_read_data(contig_data,
                                              with_quality=False))
    else:
        log.info("Can't find contig data at location: %s", contig_data)
        log.info("Skip contig path")
    read_data = os.path.join(tmp_dir, "read_data_init.txt")
    reads = None
    if read_path:
        if os.path.exists(read_data):
            reads = list(records.read_read_data(read_data, with_quality=True))
        else:
            log.info("Can't find read data at location: %s", read_data)
            log.info("Skip read path")
    walkers = [w for w in (contigs, reads) if w is not None]
    walked = iter(_walk_paths(unitig_records, walkers, params.kminmer_size,
                              device) if walkers else ())

    paths = None
    if contigs is not None:
        path_file = out_prefix + "_contigPath.tsv"
        name_file = out_prefix + "_contigNames.csv"
        with open(path_file, "w") as pf, open(name_file, "w") as nf:
            nf.write("Name,ContigName\n")
            for ci, path in enumerate(next(walked)):
                if not path.size:
                    continue
                names = [utg_names[u] for u in path.tolist()]
                pf.write(f"ctg{ci}\t" + "\t".join(names) + "\n")
                nf.write("".join(f"{name},ctg{ci}\n" for name in names))
        paths = (path_file, name_file)
    rpath = None
    if reads is not None:
        rpath = out_prefix + "_readPath.tsv"
        with open(rpath, "w") as pf:
            for rec, path in zip(reads, next(walked)):
                if path.size:
                    pf.write(f"read{rec.index}\t" + "\t".join(
                        utg_names[u] for u in path.tolist()) + "\n")
    return paths, rpath


def run_gfa(out_dir: str, k: int, output_path: str | None = None,
            recompute_coverage: bool = False, read_path: bool = False,
            device="cuda", n_threads: int = 1):
    device = open_device(device)
    tmp_dir = os.path.join(out_dir, "tmp")
    ks = available_ks(tmp_dir)
    params = records.Parameters.load(os.path.join(tmp_dir, "parameters.gz"))
    if k == 0:
        print("Available assembly graphs (k -> approx k-min-mer span in bp):")
        for kk in ks:
            bp = int(1 / np.float32(params.density_assembly) * (kk - 1)
                     + params.minimizer_size)
            print(f"  k={kk}\t~{bp} bp")
        return ks

    if k not in ks:
        raise SystemExit(f"no assembly graph saved for k={k}; available: {ks}")

    pass_dir = os.path.join(tmp_dir, f"pass_k{k}")
    gfa_in = os.path.join(pass_dir, "assembly_graph.gfa")
    unitigs_file = os.path.join(pass_dir, "assembly_graph.gfa.unitigs")
    params = records.Parameters.load(os.path.join(pass_dir, "parameters.gz"))
    repetitive = np.sort(load_repetitive_minimizers(
        os.path.join(tmp_dir, "repetitiveMinimizers.bin")))
    if repetitive.size == 0:
        repetitive = None

    # map reads to the unitig minimizer sequences and rebuild base sequences
    aln_file = os.path.join(tmp_dir, "gfaAlignments.bin")
    postprocess.run_read_vs_contig_mapper(
        os.path.join(tmp_dir, "read_data_init.txt"), unitigs_file, aln_file)

    with open(os.path.join(tmp_dir, "input.txt")) as f:
        read_paths = [line.strip() for line in f if line.strip()]

    unitig_records = list(records.read_read_data(unitigs_file,
                                                 with_quality=False))
    per_unitig: dict = {i: [] for i in range(len(unitig_records))}
    needed = set()
    for al in postprocess.read_alignments(aln_file):
        per_unitig[al[1]].append(tiling.Mapping(al))
        needed.add(al[0])

    read_seqs = {}
    for read in fastq.iter_reads(read_paths):
        if read.index in needed:
            read_seqs[read.index] = read.seq

    avg_dist = float(1.0 / np.float32(params.density_assembly))
    sequences = [reconstruct.reconstruct_unpolished(
        rec.minimizers, rec.is_circular, per_unitig[i], read_seqs, avg_dist,
        device, n_threads) for i, rec in enumerate(unitig_records)]
    overlaps = dict(enumerate(_unitig_overlaps(sequences, params, repetitive,
                                               device)))
    os.remove(aln_file)

    coverages = (_recomputed_coverages(tmp_dir, unitig_records, device)
                 if recompute_coverage else None)

    if output_path is None:
        out_prefix = os.path.join(out_dir, f"assemblyGraph_k{k}")
        output_path = out_prefix + ".gfa"
    else:
        out_prefix = output_path[:-4] if output_path.endswith(".gfa") \
            else output_path
    noseq_path = out_prefix + ".noseq.gfa"

    # order index (S-line position) per utg name, as _unitigOrder
    # (GenerateGfa.hpp:484-490)
    utg_order: dict = {s.name: i
                       for i, s in enumerate(gfa_io.iter_segments(gfa_in))}

    # two passes like the reference: all S lines, then all L lines
    # (GenerateGfa.hpp:444-500 then 502-585); dp uses C++ to_string(float)
    # formatting (6 fixed decimals)
    with open(gfa_in) as fin, open(output_path, "w") as fout, \
            open(noseq_path, "w") as fnoseq:
        s_index = 0
        for line in fin:
            fields = line.rstrip("\n").split("\t")
            if fields[0] != "S":
                continue
            if coverages is not None:
                cov = float(coverages[s_index])
            else:
                cov = float(fields[4][5:])  # strip "dp:i:"
            seq = sequences[s_index] if s_index < len(sequences) else None
            if seq is not None:
                seq_str = bytes(seq).decode()
                fout.write(f"S\t{fields[1]}\t{seq_str}\t"
                           f"LN:i:{len(seq_str)}\tdp:i:{cov:.6f}\n")
            else:
                fout.write("\t".join(fields[:4]) + f"\tdp:i:{cov:.6f}\n")
            fnoseq.write(f"S\t{fields[1]}\t*\t{fields[3]}\tdp:i:{cov:.6f}\n")
            s_index += 1
        fin.seek(0)
        for line in fin:
            fields = line.rstrip("\n").split("\t")
            if fields[0] != "L":
                continue
            oi_from = utg_order[fields[1]]
            oi_to = utg_order[fields[3]]
            plus_f, minus_f = overlaps.get(oi_from, (0, 0))
            plus_t, minus_t = overlaps.get(oi_to, (0, 0))
            ovl = plus_f if fields[2] == "+" else minus_f
            ovl = min(ovl, minus_t if fields[4] == "+" else plus_t)
            out_line = "\t".join(fields[:5]) + f"\t{ovl}M\n"
            fout.write(out_line)
            fnoseq.write(out_line)

    utg_names = [name for name, _ in
                 sorted(utg_order.items(), key=lambda kv: kv[1])]
    paths, rpath = _generate_paths(tmp_dir, out_prefix, params,
                                   unitig_records, utg_names, read_path,
                                   device)

    log.info("Assembly graph: %s", output_path)
    log.info("Assembly graph (without sequences): %s", noseq_path)
    if paths:
        log.info("Contig path: %s", paths[0])
    if rpath:
        log.info("Read path: %s", rpath)
    log.info("Done!")
    return output_path
