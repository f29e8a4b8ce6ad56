"""Base-space reconstruction orchestrator, faithful to ToBasespace2::execute
(src/toBasespace/ToBasespace2.hpp:332-526):

1. align reads vs final minimizer-space contigs (contig_mapper, byte-parity
   ReadVsContigMapper) -> readsVsContigsAlignments.bin;
2. partition contigs + reads under the RAM model (partition.py,
   ReadPartitionner) — reads stored contig-oriented;
3. per partition: alignment-verified read tiling into draft contigs
   (tiling.py, getPath/readPathsToContigs), then two windowed-POA polishing
   passes (polisher.py, ContigPolisher.execute2);
4. dereplicate (derep.py, ContigDerep @ identity 0.9) and trim
   (ContigTrimmer) -> contigs.fasta.gz + contig_data_final.bin.
"""

import logging
import os
import struct

import numpy as np

from ..io import fastq, records
from . import derep as derep_mod
from . import partition as partition_mod
from . import polisher as polisher_mod
from . import tiling

log = logging.getLogger("portbench.reference")


def reconstruct_unpolished(minimizers, is_circular, alignments, read_seqs,
                           avg_dist: float):
    """Unpolished draft sequence of one minimizer-space contig/unitig via
    verified read tiling (ToBasespaceGfa's role: raw sequences for GFA
    S-lines, src/toBasespace/ToBasespaceGfa.hpp:280). alignments:
    tiling.Mapping list; read_seqs: read_index -> forward-strand uint8."""
    reads = {}
    for al in alignments:
        seq = read_seqs.get(al.read_index)
        if seq is None:
            continue
        reads[al.read_index] = partition_mod.revcomp(seq) \
            if al.is_reversed else seq
    tiler = tiling.ContigTiler(reads, avg_dist, min_contig_length=1)
    pieces, _ = tiling.create_base_contig(
        tiler, np.asarray(minimizers, np.uint32), is_circular,
        [al for al in alignments if al.read_index in reads])
    if not pieces:
        return None
    return np.concatenate([p[0] for p in pieces])


def run_to_basespace(out_dir: str, read_paths, output_contig_file: str,
                     params: records.Parameters, min_contig_length: int = 50,
                     min_contig_coverage: float = 1.0,
                     repetitive: np.ndarray | None = None,
                     n_threads: int | None = None):
    contig_file = os.path.join(out_dir, "contig_data_init_small.txt.norepeats")
    aln_file = os.path.join(out_dir, "readsVsContigsAlignments.bin")
    partition_dir = os.path.join(out_dir, "_polish_readPartitions")
    os.makedirs(partition_dir, exist_ok=True)
    avg_dist = float(1.0 / np.float32(params.density_assembly))

    log.info("  Aligning reads vs contigs")
    from .contig_mapper import map_reads_to_contigs
    raw_alignments = map_reads_to_contigs(
        os.path.join(out_dir, "read_data_init.txt"), contig_file, aln_file,
        avg_minimizer_distance=avg_dist)
    alignments = [tiling.Mapping(t) for t in raw_alignments]

    contigs = [(i, np.asarray(rec.minimizers, np.uint32), rec.is_circular)
               for i, rec in enumerate(
                   records.read_read_data(contig_file, with_quality=False))]

    log.info("  Partitioning reads (%d contigs, %d alignments)",
             len(contigs), len(alignments))
    partitionner = partition_mod.Partitionner(contigs, alignments, avg_dist)
    partition_mod.write_read_partitions(
        partitionner, fastq.iter_reads(read_paths, need_headers=False),
        partition_dir,
        use_qual=True)
    partition_mod.write_contig_partitions(partitionner, contigs,
                                          partition_dir)

    per_contig_alignments: dict = {}
    for al in alignments:
        per_contig_alignments.setdefault(al.contig_index, []).append(al)

    global_contig_index = 0
    polished_contigs: dict = {}
    polished_headers: dict = {}
    polished_coverages: dict = {}
    used_reads: dict = {}
    used_read_sketches: dict = {}
    final_min = open(os.path.join(out_dir, "contig_data_final.bin"), "wb")
    used_read_file = fastq.open_maybe_gzip(
        os.path.join(partition_dir, "usedReads.fasta.gz"), "wb")

    checksum_total = 0
    for pi in range(partitionner.nb_partitions):
        log.info("  Processing partition %d/%d", pi,
                 partitionner.nb_partitions)
        read_file = os.path.join(partition_dir, f"{pi}_reads.bin")
        bin_file = os.path.join(partition_dir, f"{pi}_contigs.bin")

        reads: dict = {}
        quals: dict = {}
        for idx, seq, qual in partition_mod.read_read_partition(read_file):
            reads[idx] = seq
            quals[idx] = qual

        import time as _time
        _t0 = _time.perf_counter()
        tiler = tiling.ContigTiler(reads, avg_dist, min_contig_length)
        tiler.n_threads = n_threads or 1

        # draft contigs via verified read tiling
        partition_contigs: dict = {}
        partition_headers: dict = {}
        partition_reads: list = []
        seen_reads = set()
        for (cid, minimizers, is_circular) in \
                partition_mod.read_contig_partition(bin_file):
            als = [al for al in per_contig_alignments.get(cid, [])
                   if al.read_index in reads]
            pieces, coverage = tiling.create_base_contig(
                tiler, minimizers, is_circular, als)
            for (seq, circ, mins, read_path) in pieces:
                ci = global_contig_index
                global_contig_index += 1
                partition_contigs[ci] = seq
                partition_headers[ci] = (ci, circ)
                checksum_total += int(
                    (seq.astype(np.uint64) * seq.shape[0] * cid).sum()
                    & 0xFFFFFFFFFFFFFFFF)
                final_min.write(struct.pack("<IB", len(mins),
                                            1 if circ else 0))
                final_min.write(np.asarray(mins, np.uint32).tobytes())
                for r in read_path:
                    if r in seen_reads:
                        continue
                    seen_reads.add(r)
                    used_reads[r] = reads[r]
                    used_read_sketches[r] = tiler.sketch_of(r)
                    used_read_file.write(b">read_%d\n" % r)
                    used_read_file.write(reads[r].tobytes() + b"\n")

        log.info("  partition %d tiling: %.1fs (%d draft contigs)", pi,
                 _time.perf_counter() - _t0, len(partition_contigs))
        if not partition_contigs:
            continue

        for r in reads:
            partition_reads.append((r, reads[r], quals[r]))

        # two polishing passes (ContigPolisher::execute2), then a targeted
        # refinement pass over the regions pass 2 was still changing —
        # indel-dense (ONT) consensus sometimes needs one more local
        # iteration to converge; re-polishing only the active windows costs
        # a remap plus a handful of window POAs.
        # METAMDBG_TPU_POLISH_PASSES / _POLISH_REFINE=0 override.
        n_passes = int(os.environ.get("METAMDBG_TPU_POLISH_PASSES", "2"))
        refine = os.environ.get("METAMDBG_TPU_POLISH_REFINE", "1") != "0"
        sketches = dict(tiler._sketches)
        c1, h1 = partition_contigs, partition_headers
        cov1: dict = {}
        changed: dict = {}
        for p in range(max(n_passes, 1)):
            c1, h1, cov1, _, changed = polisher_mod.polish_pass(
                c1, h1, partition_reads, min_contig_length,
                min_contig_coverage, final_headers=(p == n_passes - 1),
                n_threads=n_threads, read_sketches=sketches)
        if refine and changed:
            margin = polisher_mod.WINDOW_LEN
            if params.data_type == 1:
                # ONT: indel fixes shift every downstream window's grid
                # alignment, and indel-dense consensus converges slower —
                # re-polish changed contigs fully (unchanged contigs still
                # pass through untouched). Measured: this reaches the
                # reference's error rate where the targeted scope left one
                # stable mid-window deletion behind.
                restrict = {cid: [(0, int(c1[cid].shape[0]))]
                            for cid in changed if cid in c1}
            else:
                restrict = {cid: [(max(0, s - margin), e + margin)
                                  for (s, e) in ivals]
                            for cid, ivals in changed.items()}
            log.info("  Polish refinement: %d contigs, %d active regions",
                     len(restrict),
                     sum(len(v) for v in restrict.values()))
            c1, h1, cov_r, _, _ = polisher_mod.polish_pass(
                c1, h1, partition_reads, min_contig_length,
                min_contig_coverage, final_headers=True,
                n_threads=n_threads, read_sketches=sketches,
                restrict=restrict)
            cov1.update(cov_r)
        for cid in c1:
            polished_contigs[cid] = c1[cid]
            polished_headers[cid] = h1[cid]
            polished_coverages[cid] = cov1.get(cid, 0.0)

    final_min.close()
    used_read_file.close()
    log.info("  Checksum curated contigs: %d", checksum_total)

    log.info("  Dereplicating contigs")
    derep_contigs = derep_mod.dereplicate_contigs(
        polished_contigs, polished_coverages, polished_headers,
        min_contig_length)

    log.info("  Trimming contigs")
    trimmed = derep_mod.trim_contigs(derep_contigs, polished_headers,
                                     used_reads, min_contig_length,
                                     read_sketches=used_read_sketches)

    out_records = []
    for cid in sorted(trimmed):
        seq = trimmed[cid]
        orig_index, is_circular = polished_headers[cid]
        coverage = polished_coverages.get(cid, 0.0)
        circ = "yes" if is_circular else "no"
        header = (f"ctg{orig_index} length={seq.shape[0]} "
                  f"coverage={coverage:.2f} circular={circ}")
        out_records.append((header, bytes(seq)))
    fastq.write_fasta(output_contig_file, out_records)
    return len(out_records)
