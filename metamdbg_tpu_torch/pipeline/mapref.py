"""`map` subcommand: color an exported assembly graph by reference genomes.

Plays the role of MappingContigToGraph (src/mapping/MappingContigToGraph.hpp:
104-360, the `map` dev tool): reference genome sequences are sketched at the
pass's parameters, each graph unitig is assigned the reference owning the
majority of its k-min-mers, and a Bandage-style `contigColor.csv`
(Name,Color) plus `contigName.csv` (Name,ReferenceName) are written next to
the graph.

The port of metamdbg_tpu/pipeline/mapref.py, byte for byte: every
reference in one BatchSketcher call (kernel K1, the asm's read-end trim and
blacklist), the k-min-mer keys of the references and the unitigs in one
kernel KW launch, on `device`. A k-min-mer is looked up by its 128-bit
hash, its identity throughout the reference (src/Commons.hpp:941-970),
where the JAX package keys on the window's values.
"""

import logging
import os

import numpy as np

from ..count import kminmers
from ..io import fastq, records
from ..io import gfa as gfa_io
from ..io.records import load_repetitive_minimizers
from ..sketch import kmers, rle
from ..sketch.batch import BatchSketcher
from . import open_device
from .gfa import available_ks, key_table, window_owner

log = logging.getLogger("metamdbg_tpu_torch")

PALETTE = ["#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4", "#46f0f0",
           "#f032e6", "#bcf60c", "#fabebe", "#008080", "#e6beff", "#9a6324",
           "#fffac8", "#800000", "#aaffc3", "#808000", "#ffd8b1", "#000075"]


def _reference_minimizers(reference_paths, params, repetitive, device):
    """(names, minimizers) of every reference record, named
    `<file basename>:<record index in its file>`; read one file at a time,
    so that the index restarts at 0 in each."""
    names, codes, bads = [], [], []
    for path in reference_paths:
        for read in fastq.iter_reads([path]):
            names.append(f"{os.path.basename(path)}:{read.index}")
            seq_rle, _ = rle.rle_encode(read.seq,
                                        params.use_homopolymer_compression)
            c, b = kmers.base_codes(seq_rle)
            codes.append(c)
            bads.append(b)
    if not codes:
        return names, []
    sketcher = BatchSketcher(params.minimizer_size, params.density_assembly,
                             repetitive, device)
    return names, [m for m, _, _ in sketcher.sketch_many(codes, bads)]


def _best_references(ref_of, unitig_of, n_unitigs):
    """Per unitig, (reference, count) of the reference that holds most of
    its looked-up k-min-mers, ties to the lower reference index; (-1, 0)
    where none is held."""
    best = np.full(n_unitigs, -1, np.int64)
    count = np.zeros(n_unitigs, np.int64)
    if ref_of.size == 0:
        return best, count
    pairs, n = np.unique(np.stack([unitig_of, ref_of]), axis=1,
                         return_counts=True)
    order = np.lexsort((pairs[1], -n, pairs[0]))
    u, r, n = pairs[0][order], pairs[1][order], n[order]
    first = np.ones(u.shape[0], bool)
    first[1:] = u[1:] != u[:-1]
    best[u[first]] = r[first]
    count[u[first]] = n[first]
    return best, count


def run_map(out_dir: str, k: int, reference_paths, output_prefix=None,
            device="cuda"):
    device = open_device(device)
    tmp_dir = os.path.join(out_dir, "tmp")
    ks = available_ks(tmp_dir)
    if k not in ks:
        raise SystemExit(f"no assembly graph saved for k={k}; available: {ks}")
    pass_dir = os.path.join(tmp_dir, f"pass_k{k}")
    params = records.Parameters.load(os.path.join(pass_dir, "parameters.gz"))
    repetitive = np.sort(load_repetitive_minimizers(
        os.path.join(tmp_dir, "repetitiveMinimizers.bin")))
    if repetitive.size == 0:
        repetitive = None

    ref_names, ref_mins = _reference_minimizers(reference_paths, params,
                                                repetitive, device)
    # unitig minimizer paths of the saved graph; the .unitigs records are in
    # the same order as the GFA's S lines, whose names we reuse
    unitigs_file = os.path.join(pass_dir, "assembly_graph.gfa.unitigs")
    unitigs = [r.minimizers for r in
               records.read_read_data(unitigs_file, with_quality=False)]
    seg_names = [s.name for s in gfa_io.iter_segments(
        os.path.join(pass_dir, "assembly_graph.gfa"))]

    # reference k-min-mers -> reference index (ties: first reference), and
    # each unitig k-min-mer's reference
    h1, h2, offsets = kminmers.flat_window_hashes(
        ref_mins + unitigs, params.kminmer_size, device)
    nr = len(ref_mins)
    cut = int(offsets[nr])
    table = key_table(h1[:cut], h2[:cut], window_owner(offsets[:nr + 1]),
                      last=False)
    ref, hit = table.lookup(h1[cut:], h2[cut:], -1)
    unitig_of = window_owner(offsets[nr:] - cut)
    best, count = _best_references(ref[hit].cpu().numpy(),
                                   unitig_of[hit].cpu().numpy(), len(unitigs))
    n_rows = (offsets[nr + 1:] - offsets[nr:-1]).cpu().numpy()

    if output_prefix is None:
        output_prefix = os.path.join(out_dir, f"assemblyGraph_k{k}")
    color_path = output_prefix + ".contigColor.csv"
    name_path = output_prefix + ".contigName.csv"
    n_colored = 0
    with open(color_path, "w") as cf, open(name_path, "w") as nf:
        cf.write("Name,Color\n")
        nf.write("Name,ReferenceName\n")
        for i in range(len(unitigs)):
            if best[i] < 0 or count[i] * 2 <= max(int(n_rows[i]), 1):
                continue  # majority required
            seg = seg_names[i] if i < len(seg_names) else f"utg{i}"
            cf.write(f"{seg},{PALETTE[best[i] % len(PALETTE)]}\n")
            nf.write(f"{seg},{ref_names[best[i]]}\n")
            n_colored += 1
    log.info("map: %d unitigs colored -> %s", n_colored, color_path)
    return color_path, name_path
