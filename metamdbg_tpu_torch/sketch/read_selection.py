"""Stage 1 — read selection: reads -> minimizer space.

Re-implements the `readSelection` subcommand
(src/readSelection/ReadSelection.hpp:92-303): for each read,
homopolymer-compress (HiFi), select minimizers by universe hash, apply the
complexity and quality filters, and write `read_data_init.txt`,
`read_stats.txt` and `repetitiveMinimizers.bin`; for HiFi or
skip-correction runs, palindrome-purge into `read_data_corrected.txt`
(ReadSelection.hpp:300-302,1374-1431). Byte-identical to
metamdbg_tpu/sketch/read_selection.py.

Sketching always runs on `device` through the sketch kernel
(sketch/batch.py -> kernels/sketch.py); the ONT blacklist pass at
correction density uses the same kernel.

The stage runs in a span `readselection` (utils/spans.py) with its
`reads`, `bases` and `minimizers`, and the fastq decode's seconds as
`decode`; below it `readselection.repeats` (the blacklist pass), per chunk
of reads `readselection.sketch` (K1, with each launch's bound inputs),
`.filters` and `.write`, and `readselection.palindromes`.
"""

import os

import numpy as np

from ..constants import (
    COMPLEXITY_MAX_SCORE,
    COMPLEXITY_STEP,
    COMPLEXITY_WINDOW,
    REPETITIVE_MINIMIZER_FRACTION,
    REPETITIVE_MINIMIZER_MAX_READS,
    compute_last_k,
)
from ..io import fastq, records
from ..utils import spans
from ..utils.stats import compute_mean_length, compute_n50
from . import batch, filters, kmers, native_sketch, palindrome, rle

CHUNK_READS = 4096


def chunked(iterable, n: int):
    chunk = []
    for x in iterable:
        chunk.append(x)
        if len(chunk) == n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def sketch_chunk(sketcher, chunk, use_hpc):
    """Sketch a chunk of reads. Returns [(mins, pos, dirs, rle_pos)] in
    chunk order. `pos` are k-mer indices in the RLE'd read."""
    rles = [rle.rle_encode(read.seq, use_hpc) for read in chunk]
    coded = [kmers.base_codes(seq_rle) for seq_rle, _ in rles]
    sketched = sketcher.sketch_many([c for c, _ in coded],
                                    [b for _, b in coded])
    return [(mins, pos, dirs, rles[i][1])
            for i, (mins, pos, dirs) in enumerate(sketched)]


def determine_repetitive_minimizers(input_paths, out_path: str, l: int,
                                    density_correction: float,
                                    use_hpc: bool, device) -> np.ndarray:
    """ONT-only blacklist of hyper-abundant minimizers (ReadSelection.hpp:497-561).

    Counts minimizers at correction density over the first 1M reads and bans
    the top 1e-5 fraction (>= 1). Skipped (empty file) when HPC is on (HiFi).
    Ties in abundance break by minimizer value descending, as in the JAX
    package. Returns the banned minimizers sorted, as BatchSketcher needs.
    """
    if use_hpc:
        open(out_path, "wb").close()
        return np.zeros(0, dtype=np.uint32)

    counts: dict[int, int] = {}
    sketcher = batch.BatchSketcher(l, density_correction, None, device)
    reads = fastq.iter_reads(input_paths,
                             max_reads=REPETITIVE_MINIMIZER_MAX_READS)
    for chunk in chunked(reads, CHUNK_READS):
        for mins, _, _, _ in sketch_chunk(sketcher, chunk, use_hpc):
            vals, cnt = np.unique(mins, return_counts=True)
            for v, c in zip(vals.tolist(), cnt.tolist()):
                counts[v] = counts.get(v, 0) + c

    if not counts:
        open(out_path, "wb").close()
        return np.zeros(0, dtype=np.uint32)

    items = np.array(sorted(counts.items(), key=lambda kv: (-kv[1], -kv[0])),
                     dtype=np.int64)
    nb = max(int(REPETITIVE_MINIMIZER_FRACTION * len(items)), 1)
    banned = items[:nb, 0].astype(np.uint32)
    records.save_repetitive_minimizers(out_path, banned)
    return np.sort(banned)


def run_read_selection(input_paths, out_dir: str, params: records.Parameters,
                       device, min_read_quality: float = 0.0,
                       skip_correction: bool = False) -> records.ReadStats:
    """Full stage on `device` ("cuda" or "cpu"); returns the ReadStats.
    Runs in a root span `readselection`, its phases in spans below it."""
    with spans.span("readselection", rss=True) as root:
        stats = _read_selection(input_paths, out_dir, params, device,
                                min_read_quality, skip_correction)
        root.add("reads", stats.nb_reads)
        root.add("bases", stats.nb_bases)
        root.add("minimizers", stats.nb_minimizers)
    return stats


def _read_selection(input_paths, out_dir, params, device, min_read_quality,
                    skip_correction):
    l = params.minimizer_size
    density = params.density_assembly
    use_hpc = params.use_homopolymer_compression

    with spans.span("readselection.repeats"):
        repetitive = determine_repetitive_minimizers(
            input_paths, os.path.join(out_dir, "repetitiveMinimizers.bin"),
            l, params.density_correction, use_hpc, device)

    out_path = os.path.join(out_dir, "read_data_init.txt")
    all_read_sizes = []
    nb_kmers = 0
    nb_bases = 0
    nb_minimizers = 0
    quality_sum = np.longdouble(0.0)
    quality_n = 0

    sketcher = batch.BatchSketcher(l, density, repetitive, device)
    empty_u32 = np.zeros(0, np.uint32)
    empty_u8 = np.zeros(0, np.uint8)
    with records.ReadDataWriter(out_path, with_quality=True) as writer:
        for chunk in chunked(fastq.iter_reads(input_paths), CHUNK_READS):
            with spans.span("readselection.sketch") as s:
                sketched = sketch_chunk(sketcher, chunk, use_hpc)
                s.add("reads", len(chunk))
            with spans.span("readselection.filters"):
                complexity, mean_quality = native_sketch.read_filters_batch(
                    [r.seq for r in chunk], [r.qual for r in chunk],
                    COMPLEXITY_WINDOW, COMPLEXITY_STEP, filters._QUAL_TABLE)
            with spans.span("readselection.write"):
                for ri, (read, (mins, pos, dirs, rle_pos)) in enumerate(
                        zip(chunk, sketched)):
                    mean_q = float(mean_quality[ri])
                    # NaN compares False: reads without a complete window
                    # or without qualities are kept
                    if float(complexity[ri]) > COMPLEXITY_MAX_SCORE or \
                            mean_q < min_read_quality:
                        mins, pos, dirs = empty_u32, empty_u32, empty_u8
                    if not mean_q < min_read_quality:
                        quality_sum += np.longdouble(mean_q)
                        quality_n += 1

                    quals = filters.minimizer_min_qualities(
                        read.qual, rle_pos, pos, l)
                    writer.write(records.MinimizerRead(
                        read.index, mins, pos, dirs, quals, mean_q,
                        read.seq.shape[0]))

                    all_read_sizes.append(read.seq.shape[0])
                    nb_minimizers += mins.shape[0]
                    nb_kmers += read.seq.shape[0] - l + 1
                    nb_bases += read.seq.shape[0]

    sizes = np.asarray(all_read_sizes, dtype=np.uint32)
    stats = records.ReadStats(
        nb_reads=len(all_read_sizes),
        n50=compute_n50(sizes),
        density=float(np.float32(np.longdouble(nb_minimizers)
                                 / np.longdouble(nb_kmers)))
        if nb_kmers else 0.0,
        nb_bases=nb_bases,
        avg_quality=float(np.float32(quality_sum / quality_n))
        if quality_n else 0.0,
        mean_length=compute_mean_length(sizes),
        nb_minimizers=nb_minimizers,
    )
    stats.save(os.path.join(out_dir, "read_stats.txt"))

    if use_hpc or skip_correction:
        with spans.span("readselection.palindromes"):
            purge_palindromes(out_path,
                              os.path.join(out_dir,
                                           "read_data_corrected.txt"),
                              params, stats.n50)
    return stats


def purge_palindromes(in_path: str, out_path: str, params: records.Parameters,
                      n50_read_length: int):
    """HiFi path: rewrite reads with palindromic windows removed
    (ReadSelection.hpp:1374-1431)."""
    last_k = compute_last_k(params.density_assembly, n50_read_length,
                            params.kminmer_size_first, 0)
    with records.ReadDataWriter(out_path, with_quality=False) as writer:
        for read in records.read_read_data(in_path, with_quality=True):
            purged = palindrome.purge_palindrome(
                read.minimizers, params.kminmer_size_first, last_k)
            writer.write(records.MinimizerRead(
                read.index, purged, None, None, None))
