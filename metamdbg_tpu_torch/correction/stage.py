"""Read correction stage orchestration (`readCorrection`, ONT only).

The port of metamdbg_tpu/correction/stage.py, after ReadCorrection::execute
(src/readSelection/ReadCorrection.hpp:1759-2151): memory model ->
all-vs-all mapping (correction/mapper.py, on `device`, with kernel K4) ->
Jaccard-BFS read partitioning -> per-partition correction on the native
engine (correction/poa_native.py, `n_threads` Python threads, nothing
forks) -> read_data_corrected.txt ({u32 n, u8 linear, u32 minimizers[n]}
records, ReadCorrection.hpp:6367-6484). The reads are re-sketched at
correction density on `device` through kernel K1 (sketch/batch.py).

Determinism notes:
- the reference's corrected-record order equals ascending read index within
  each partition (single-writer iteration over the partition's load order);
- partition membership is reproduced with the same Jaccard-priority BFS;
  heap ties follow (distance, insertion order), which can diverge from
  libstdc++ heap mechanics only when several neighbors share a distance in a
  multi-partition run (never in a single-partition run).
"""

import dataclasses
import heapq
import logging
import os

import numpy as np
import torch

from ..constants import CONTIG_LINEAR
from ..io import fastq, records
from ..sketch import batch, read_selection
from ..sketch.palindrome import purge_palindrome
from ..utils import spans
from ..utils.hashing import minimizer_is_selected
from . import mapper, poa_native

log = logging.getLogger("metamdbg_tpu_torch")

MAX_MEMORY_BASE_GB = 8.0            # ReadCorrection.hpp:1789
MEMORY_PER_MINIMIZER = 15           # ReadCorrection.hpp:1822 (8+4+1+1+1)
MINIMIZER_POSITION_BYTES = 48       # sizeof(MinimizerPosition2)*2 (hpp:1829)


@dataclasses.dataclass
class SimpleRead:
    """A read at correction density, as the native engine takes it."""
    index: int
    minimizers: np.ndarray
    positions: np.ndarray
    directions: np.ndarray
    qualities: np.ndarray
    read_length: int


def compute_max_memory(nb_bases: int) -> int:
    """Affine RAM model (ReadCorrection.hpp:1788-1817).

    METAMDBG_TPU_CORRECTION_MEMORY_GB overrides the model so scale tests
    can force multi-partition correction on small inputs."""
    ovr = os.environ.get("METAMDBG_TPU_CORRECTION_MEMORY_GB")
    if ovr:
        return int(float(ovr) * 1_000_000_000)
    x1, y1 = np.float32(MAX_MEMORY_BASE_GB), np.float32(50.0)
    x2, y2 = np.float32(250.0), np.float32(5000.0)
    a = (y2 - y1) / (x2 - x1)
    b = y1 - a * x1
    gb_actual = np.longdouble(nb_bases) / np.longdouble(1_000_000_000)
    x3 = (np.float32(gb_actual) - b) / a
    max_gb = max(np.longdouble(x3), np.longdouble(MAX_MEMORY_BASE_GB))
    max_gb = min(max_gb, np.longdouble(900))
    return int(max_gb * np.longdouble(1_000_000_000))


def _min_qualities(qual, rle_pos, pos, l):
    """getMinQuality (ReadCorrection.hpp:2469-2487): min of the raw-space
    qualities over the INCLUSIVE span rle_pos[p] .. rle_pos[p+l-1]."""
    q = np.asarray(qual, np.uint8).astype(np.int32) - 33
    rp = rle_pos.astype(np.int64)
    p = pos.astype(np.int64)
    starts = rp[p]
    ends = rp[p + l - 1] + 1
    if starts.shape[0] == 0:
        return np.zeros(0, np.uint8)
    # pairwise reduceat: even slots reduce q[start:end); odd slots (the
    # inter-span gaps) are discarded
    qpad = np.concatenate([q, np.zeros(1, np.int32)])
    inds = np.empty(2 * starts.shape[0], np.int64)
    inds[0::2] = starts
    inds[1::2] = ends
    mins = np.minimum.reduceat(qpad, inds)[0::2]
    return mins.astype(np.uint8)


def sketch_high_density_reads(input_paths, params: records.Parameters,
                              repetitive: np.ndarray, device):
    """Re-sketch the original reads at correction density, on `device`
    through the sketch kernel, with the repetitive blacklist and per-
    minimizer INCLUSIVE-end min qualities (ReadCorrection.hpp:2228-2344
    ReadSelectionFunctor + getMinQuality 2469-2487 — note the `i<=endPos`
    span, unlike read selection's exclusive end)."""
    l = params.minimizer_size
    use_hpc = params.use_homopolymer_compression
    sketcher = batch.BatchSketcher(l, params.density_correction, repetitive,
                                   device)
    out = []
    for chunk in read_selection.chunked(fastq.iter_reads(input_paths),
                                        read_selection.CHUNK_READS):
        sketched = read_selection.sketch_chunk(sketcher, chunk, use_hpc)
        for read, (mins, pos, dirs, rle_pos) in zip(chunk, sketched):
            if read.qual.size == 0:
                quals = np.ones(mins.shape[0], np.uint8)
            else:
                quals = _min_qualities(read.qual, rle_pos, pos, l)
            out.append(SimpleRead(read.index, mins, pos, dirs, quals,
                                  read.seq.shape[0]))
    return out


def run_read_correction(tmp_dir: str, params: records.Parameters, device,
                        min_identity: float = 0.96,
                        min_overlap_length: int = 1000, n_threads: int = 1,
                        group=None):
    """The whole stage in `tmp_dir`; returns the correction checksum.
    With `group` (two or more ranks), the mapper's joins run sharded."""
    with spans.span("correction.map") as s_map:
        stats = records.ReadStats.load(os.path.join(tmp_dir,
                                                    "read_stats.txt"))
        reads = list(records.read_read_data(
            os.path.join(tmp_dir, "read_data_init.txt"), with_quality=True))
        with open(os.path.join(tmp_dir, "input.txt")) as f:
            input_paths = [line.strip() for line in f if line.strip()]
        repetitive = np.sort(records.load_repetitive_minimizers(
            os.path.join(tmp_dir, "repetitiveMinimizers.bin")))

        max_memory = compute_max_memory(stats.nb_bases)
        memory_per_read = int(np.float32(
            np.float32(stats.mean_length)
            * np.float32(params.density_correction))
            * np.float32(MEMORY_PER_MINIMIZER))
        memory_per_read = max(memory_per_read, 500)

        mem_low = np.longdouble(stats.nb_minimizers) \
            * MINIMIZER_POSITION_BYTES
        nb_passes = np.ceil(mem_low / np.longdouble(max_memory))
        nb_passes = min(max(nb_passes, np.longdouble(1)),
                        np.longdouble(10))
        chunk_size = int(np.longdouble(stats.nb_minimizers) / nb_passes) + 10

        band = int(np.float32(2500) * np.float32(params.density_correction))

        alignments = mapper.run_read_mapper(
            reads, chunk_size, band, device,
            alignment_path=os.path.join(tmp_dir,
                                        "readAlignmentsLowDensity.bin"),
            group=group)
        s_map.add("reads", len(reads))

    # ---- partitioning (ReadCorrection.hpp:1965-1994, 4519-4713) ----
    with spans.span("correction.partition") as s_part:
        align_lists = [alignments.get(i, np.zeros(0, np.uint32)).tolist()
                       for i in range(stats.nb_reads)]
        partitions = None
        pass_no = 0
        memory_increased = int(max_memory * 0.33)
        cur_memory = max_memory
        while True:
            partitions, nb_written = partition_reads(align_lists, cur_memory,
                                                     memory_per_read)
            density = stats.nb_reads / nb_written if nb_written else 1.0
            if density > 0.15:
                break
            pass_no += 1
            cur_memory += memory_increased
            if pass_no > 10:
                break

        log.info("correction partitions: %d (max memory %.2f GB)",
                 len(partitions), float(cur_memory) / 1e9)
        n_alignments = sum(len(a) for a in align_lists)
        s_part.add("alignments", n_alignments)
        s_part.add("partitions", len(partitions))

    # ---- correction (on re-sketched correction-density reads) ----
    with spans.span("correction.sketch") as s_sketch:
        high_reads = sketch_high_density_reads(input_paths, params,
                                               repetitive, device)
        buffers = poa_native.ReadSetBuffers(high_reads)
        s_sketch.add("reads", len(high_reads))

    checksum = 0
    out_path = os.path.join(tmp_dir, "read_data_corrected.txt")
    with spans.span("correction.correct") as s_correct, \
            records.ReadDataWriter(out_path, with_quality=False) as writer:
        for (to_load, to_correct) in partitions:
            correct_set = set(to_correct)
            work = [ri for ri in sorted(set(to_load)) if ri in correct_set]
            with spans.timed("poa_s"):
                outs = poa_native.correct_reads_batch(
                    buffers, work, align_lists, params, min_identity,
                    min_overlap_length, band, max(n_threads, 1))
            s_correct.add("reads", len(work))
            for read_index, mins in zip(work, outs):
                checksum = _write_read(writer, read_index, mins, params,
                                       checksum)
    # determinism oracle: the reference logs the same per-stage checksum
    # (ReadCorrection.hpp:1982-1986 area)
    log.info("Correction checksum: %d", checksum)
    pack = s_correct.counts.get("pack.correction", 0.0)
    poa = s_correct.counts.get("poa_s", 0.0)
    log.info("correction timing: map %.1fs partition %.1fs sketch %.1fs "
             "pack %.1fs poa %.1fs write %.1fs (%d reads, %d alignments, "
             "%d threads)",
             s_map.seconds, s_part.seconds, s_sketch.seconds, pack,
             poa - pack, s_correct.seconds - poa, len(reads), n_alignments,
             max(n_threads, 1))
    return checksum


def partition_reads(align_lists, max_memory: int, memory_per_read: int):
    """Jaccard-priority BFS partitioning (ReadCorrection.hpp:4519-4713).

    Returns (list of (reads_to_load, reads_to_correct), nb_reads_written).
    """
    n = len(align_lists)
    is_corrected = [False] * n
    is_visited = [False] * n
    partitions = []
    cur_load: list[int] = []
    cur_correct: list[int] = []
    nb_written = 0

    for read_index in range(n):
        if is_corrected[read_index]:
            continue
        cur_load.append(read_index)
        is_visited[read_index] = True
        heap = [(0.0, 0, read_index)]
        tick = 1
        while heap:
            _, _, cur = heapq.heappop(heap)
            if is_corrected[cur]:
                continue
            cur_correct.append(cur)
            is_corrected[cur] = True
            for nb in align_lists[cur]:
                if is_visited[nb]:
                    continue
                cur_load.append(nb)
                is_visited[nb] = True
                dist = _jaccard_distance(align_lists[cur], align_lists[nb])
                heapq.heappush(heap, (dist, tick, nb))
                tick += 1
            if len(cur_load) * memory_per_read > max_memory:
                break
        if len(cur_load) * memory_per_read > max_memory:
            nb_written += len(cur_load)
            partitions.append((cur_load, cur_correct))
            cur_load = []
            cur_correct = []
            is_visited = [False] * n

    if cur_load:
        nb_written += len(cur_load)
        partitions.append((cur_load, cur_correct))
    return partitions, nb_written


def _jaccard_distance(v1, v2):
    """computeJaccardDistance (ReadCorrection.hpp:4462-4496): sorted-list
    merge counting shared/total elements."""
    i = j = 0
    shared = 0
    elements = 0
    while i < len(v1) and j < len(v2):
        if v1[i] == v2[j]:
            shared += 1
            i += 1
            j += 1
        elif v1[i] < v2[j]:
            i += 1
        else:
            j += 1
        elements += 1
    if elements == 0:
        return 1.0
    return float(np.float32(1.0) - np.float32(shared) / np.float32(elements))


def _write_read(writer, read_index: int, minimizers, params, checksum: int):
    """writeRead (ReadCorrection.hpp:6367-6484): density filter ->
    palindrome purge -> {n, linear, minimizers} record + checksum."""
    minimizers = np.asarray(minimizers, np.uint32)
    if minimizers.shape[0] < params.kminmer_size_first:
        return checksum
    # Utils::applyDensityThreshold (src/Commons.hpp:2507-2545)
    keep = minimizer_is_selected(
        torch.from_numpy(minimizers.astype(np.int64)),
        params.density_assembly).numpy()
    minimizers = minimizers[keep]
    if minimizers.shape[0] < params.kminmer_size_first:
        return checksum
    minimizers = purge_palindrome(minimizers, params.kminmer_size_first,
                                  params.kminmer_size_last)
    n = int(minimizers.shape[0])
    for m in minimizers.tolist():
        checksum = (checksum + read_index * m * n) & 0xFFFFFFFFFFFFFFFF
    writer.write(records.MinimizerRead(read_index, minimizers, None, None,
                                       None, is_circular=bool(CONTIG_LINEAR)))
    return checksum
