"""RAM-bounded read/contig partitioning for base-space polishing, faithful
to ReadPartitionner (src/toBasespace/ReadPartitionner.hpp:63-494).

Contigs are greedily packed into partitions under a memory model
(coverage * (length + length/4), hpp:305-328, 4 GB cap per partition);
every read is routed to the partition of its (single) best contig, written
reverse-complemented when its mapping is reversed so partition reads are
contig-oriented. Per-partition outputs: `{i}_reads.bin` (plain binary
records — internal tmp state, no gzip/fastq overhead) and
`{i}_contigs.bin`.

Host numpy, a copy of metamdbg_tpu/basespace/partition.py.
"""

import os
import struct

import numpy as np


def _max_partition_memory() -> int:
    """4 GB per partition (hpp:71); METAMDBG_TPU_MAX_PARTITION_GB lowers it
    so scale tests can force multi-partition polishing on small inputs."""
    return int(float(os.environ.get("METAMDBG_TPU_MAX_PARTITION_GB", "4"))
               * 1_000_000_000)


REVCOMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    REVCOMP[_a] = _b


def revcomp(seq: np.ndarray) -> np.ndarray:
    return REVCOMP[seq[::-1]]


class Partitionner:

    def __init__(self, contigs, alignments, avg_minimizer_distance,
                 n_cores: int = 1):
        """contigs: list of (index, minimizers, is_circular); alignments:
        iterable of Mapping (tiling.Mapping)."""
        self.avg_dist = avg_minimizer_distance
        self.contig_to_partition: dict = {}
        self.read_to_contig: dict = {}

        # contig coverages over minimizer positions (hpp:144-216)
        nmin = {c[0]: len(c[1]) for c in contigs}
        hits: dict = {}
        for al in alignments:
            hits.setdefault(al.contig_index, []).append(
                (al.contig_start, al.contig_end))
            # last alignment wins (hpp:229-238 overwrites)
            self.read_to_contig[al.read_index] = (al.contig_index,
                                                  al.is_reversed)
        coverages: dict = {}
        for cid, intervals in hits.items():
            n = max(nmin.get(cid, 1), 1)
            cov = np.zeros(n, np.int64)
            for (a, b) in intervals:
                cov[a:min(b, n)] += 1
            coverages[cid] = float(cov.sum() / n)

        # greedy packing (hpp:82-123)
        n_init = max(1, n_cores)
        memory = [0] * n_init
        for (cid, minimizers, _circ) in contigs:
            pi = int(np.argmin(memory))
            contig_length = len(minimizers) * self.avg_dist
            cov = max(1, int(coverages.get(cid, 0)))
            contig_memory = int(np.ceil(cov * (contig_length
                                               + contig_length / 4.0)))
            if memory[pi] > 0 and memory[pi] + contig_memory \
                    > _max_partition_memory():
                memory.append(0)
                pi = len(memory) - 1
            memory[pi] += contig_memory
            self.contig_to_partition[cid] = pi
        self.nb_partitions = sum(1 for m in memory if m > 0)

    def partition_of_read(self, read_index: int):
        hit = self.read_to_contig.get(read_index)
        if hit is None:
            return None, False
        cid, is_reversed = hit
        pi = self.contig_to_partition.get(cid)
        return pi, is_reversed


def write_read_partitions(partitionner: Partitionner, reads_iter, out_dir,
                          use_qual: bool = True):
    """Routes reads to per-partition binary files (the role of the
    reference's gzipped partition fastqs, hpp:331-434); reads are written
    contig-oriented. The format is internal tmp state, so it skips both
    gzip and fastq line parsing (each cost double-digit seconds at 285 Mbp):
    records are <u32 index, u32 seq_len, u32 qual_len> + seq + qual."""
    files = {}
    for i in range(partitionner.nb_partitions):
        files[i] = open(os.path.join(out_dir, f"{i}_reads.bin"), "wb",
                        buffering=1 << 20)
    try:
        for read in reads_iter:
            pi, is_reversed = partitionner.partition_of_read(read.index)
            if pi is None:
                continue
            seq = read.seq
            qual = read.qual if use_qual else None
            if qual is not None and not qual.size:
                qual = None
            if is_reversed:
                seq = revcomp(seq)
                if qual is not None:
                    qual = qual[::-1]
            f = files[pi]
            f.write(struct.pack("<III", read.index, seq.shape[0],
                                qual.shape[0] if qual is not None else 0))
            f.write(seq.tobytes())
            if qual is not None:
                f.write(qual.tobytes())
    finally:
        for f in files.values():
            f.close()


def read_read_partition(path: str):
    """Reads one {i}_reads.bin; yields (read_index, seq u8, qual u8|None)."""
    data = np.fromfile(path, np.uint8)
    off = 0
    n = data.shape[0]
    while off + 12 <= n:
        idx, slen, qlen = struct.unpack_from("<III", data, off)
        off += 12
        seq = data[off:off + slen]
        off += slen
        qual = data[off:off + qlen] if qlen else None
        off += qlen
        yield int(idx), seq, qual


def write_contig_partitions(partitionner: Partitionner, contigs, out_dir):
    """Per-partition contig bins (hpp:438-493): u32 size, u8 circular,
    u32 minimizers[], u32 contigIndex."""
    files = {}
    for i in range(partitionner.nb_partitions):
        files[i] = open(os.path.join(out_dir, f"{i}_contigs.bin"), "wb")
    try:
        for (cid, minimizers, is_circular) in contigs:
            pi = partitionner.contig_to_partition.get(cid)
            if pi is None:
                continue
            f = files[pi]
            f.write(struct.pack("<IB", len(minimizers),
                                1 if is_circular else 0))
            f.write(np.asarray(minimizers, np.uint32).tobytes())
            f.write(struct.pack("<I", cid))
    finally:
        for f in files.values():
            f.close()


def read_contig_partition(path: str):
    """Reads one {i}_contigs.bin; yields (contig_index, minimizers,
    is_circular)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(5)
            if len(head) < 5:
                break
            size, circ = struct.unpack("<IB", head)
            minimizers = np.frombuffer(f.read(4 * size), np.uint32)
            (cid,) = struct.unpack("<I", f.read(4))
            yield cid, minimizers, bool(circ)
