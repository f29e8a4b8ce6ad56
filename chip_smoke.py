"""Drive the PyTorch/CUDA port (metamdbg_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Kernel times are device times: CUDA events around 20 back-to-back launches
on outputs allocated once, divided by 20, the median of 3 such runs after
a warm-up (`_time_ms`); beside them, the host clock per call of the
wrapper a caller uses (`_host_ms`). tools/kernel_ab.py times a parent
commit's K1, KW, K3 and K4 beside these on the same inputs, and the
device's idle share over the HiFi asm.

Phases, each of which exits non-zero when it fails:
1. device: a CUDA GPU must be visible; prints its nvidia-smi name and
   power limit;
2. build: compiles the sketch kernel (csrc/sketch.cu), the window hash
   kernel (csrc/window_hash.cu), the chain kernel (csrc/chain_contig.cu) and
   the chain DP kernel (csrc/chain_dp.cu) with nvcc for sm_90a, one nvcc per
   source, started together, and prints the build seconds. The two inputs
   of phases 4 and 8 are generated meanwhile, each in a subprocess started
   before the build;
3. kernel: the sketch kernel against its plain torch version on the card at
   the main path's shape, (512, 16384) u8 tiles at l=15 and the main path's
   three densities, 0.005 (read selection), 0.025 (the correction
   re-sketch) and 0.1 (toBasespace's overlaps), with bad bases,
   separators, a row of separators only and one overflow row; the results
   must be bit-identical (tolerance 0: all outputs are integers). Prints
   the kernel, plain and host-per-call times and the bound per density;
3b. window hash kernel: KW against its plain torch version on the card, on
   a stream of 4,194,304 u32 minimizers (values < 2^30, with palindromic
   windows and values near 2^32 - 1 planted): one start per full window at
   w in {4, 5, 6, 7, 16, 61, 123}; row slices of a (2^20, 24) table as
   hash_rows makes them; every window in a shuffled order; per-window
   widths 1..16, and 4,000 whole unitigs back to back of up to 20,000
   words; normalize on and off: bit-identical (tolerance 0). Then KW's
   segmented mode (every window of each sequence of a stream, segments of
   several widths in one launch) on ~105k reads-like sequences of 0-80
   minimizers (KW_STREAM words kept on the card, a quarter of them past
   2^31, palindromic windows planted) and host sequences uploaded with
   the request: one request of segments at every width above, normalize
   on and off, an empty segment and one whose sequences are all shorter
   than its width, and one laid out as a ladder pass (refined nodes,
   reads and contigs at k-1 and k): one launch each, bit-identical to the
   plain version and to the explicit-starts mode on the same windows.
   Prints the kernel's times on each layout with its bound (the stream at
   4 bytes a word for both modes), the segmented and explicit modes'
   times on the reads' windows at w = 16, 40 and 61, and the plain and
   host-per-request times at w = 16 beside the earlier host path (stream
   built and uploaded, starts made, explicit launch);
3c. row counting (K2, torch ops): kernels/count.py on the card against the
   same function on CPU tensors, on a (2^20, 5) table with repeats: the
   unique rows and counts must be identical. Prints its time (CUDA events
   around 20 calls, which wait on the host), its byte bound and the time
   of torch.unique(dim=0, return_counts=True) on the same rows;
3d. chain kernel (K3): the read-vs-contig chain DP against its plain torch
   version on the card, on 16,384 anchor groups of 2-300 anchors and three
   of 5,000-10,000 (both strands, noise anchors, planted equal-score ties),
   at the asm's d_r_max, then on lengths at the kernel's edges (groups of
   0, 1 and 2 anchors, its gap row's, tiles' and spans' lengths) and on
   groups all too long for a span: scores (as f32 bits), parents and best
   indexes identical (tolerance 0). Prints the kernel and plain times;
3e. chain DP kernel (K4): the correction mapper's chain DP against its plain
   torch version on the card, on 500,000 anchor groups of 3-200 anchors and
   three of 5,000-10,000 (both strands, noise anchors, planted equal-score
   ties), at bands 62 (the asm's), 10 and 125, then edge lengths (as for
   3d, at K4's tiles and spans) and all-long groups at bands 62, 32, 33,
   64, 65 and 300: scores (as f32 bits), parents, best indexes, chain
   lengths, chain scores and chain positions identical (tolerance 0).
   Prints the kernel and plain times and the bound at band 62;
4. end to end: a 4 Mb circular genome at 30x HiFi (tests/datagen.py, seed
   1) through `python -m metamdbg_tpu_torch asm --device cuda --threads 1`'s
   entry point, in this process, where a sys.meta_path finder refuses
   every import of the JAX package (`metamdbg_tpu`). The kernels' launch
   counts are set to 0 just before and read just after; the run must have
   launched the sketch kernel once per tile batch (toBasespace's included),
   the window hash kernel in every createGraph pass and the chain kernel
   in toBasespace; every stage, from readSelection to toBasespace, must
   have run as port:cuda, and the output must be one circular contig
   within 2 kb of 4 Mb. K2's calls on the card are counted per stage
   (tmp/device.json) and printed. The sha256 of each pass's graph
   artifacts is recorded as the pass ends. Prints stage walls.
   chip_smoke wraps the sketch and window hash kernels' launches in this
   process (no hook in the package) and keeps a copy of each launch's
   inputs; after the run it
   prints a histogram of the KW launches by size, then launches again,
   against the plain version and timed, every sketch launch, the KW
   launches that hold 90% of the run's windows x width and every KW
   launch with per-window widths (segmented launches as they were made),
   and the K3 call (held bit-identical to the plain version, with the
   host ms per chain_contig call): the main path's own launches, with the
   sum of their times and of their bounds. Prints KW's launches per call
   site (tmp/device.json), and fails unless the multiplex passes' counts
   made at most one launch a pass.
8. ONT end to end (run after the references of phases 5-7 and the one of
   phase 9 have started, beside them): the 3-genome ONT metagenome of
   tests/test_quality_harness.py:103-112 (~86 Mbp) through `asm --in-ont
   --device cuda --threads 1` in this process, the JAX package refused. The
   launch counts are set to 0 just before and read just after: every
   kernel must have launched, K4 and the sketch kernel in readCorrection;
   every stage, readCorrection included, must have run as port:cuda, and
   the contigs' total length must lie within 2% of 2.1 Mb. Prints stage
   walls, the correction checksum, the contigs, and K4's time on the main
   path's own inputs, launched again after the run and held bit-identical
   to the plain version, with the host ms per chain_dp call; those inputs
   are saved to chip_inputs/chain_dp_main.pt for tools/kernel_ab.py and
   tools/kernel_variants.py.
4b. `gfa` and `map` on phase 4's output, through the port's entry point in
   this process, the JAX package refused: `gfa OUT 0` (the listing), `gfa
   OUT K --coverage --readpath` and `map OUT K --references genome.fasta`,
   K the largest saved k, genome.fasta phase 4's genome (seed 1) as
   multi-line FASTA. The launch counts are set to 0 before each run and
   read after it: the sketch kernel (the unitig sketch, trim 0, and the
   tiler's read sketches; the reference sketch) and the window hash kernel
   (the k-min-mer keys) must have launched in both `gfa` and `map`, the
   chain kernels not at all. Their sketch and window hash launches are
   kept and, after the runs, launched again and held bit-identical to the
   plain versions (tolerance 0). Prints each subcommand's wall, the
   unitigs, S and L lines, the coloured unitigs and the launches;
8b. the same on phase 8's output at the smallest saved k (the most
   unitigs), `map` with phase 8's three genomes as two FASTA files, the
   first holding two records.

The references run the JAX package's stages through
tests/jax_reference.py, host-only with jax imports blocked, each in its own
subprocess, all four at once:
5. reference: its read selection on the same reads; read_data_init.txt,
   read_stats.txt and read_data_corrected.txt must be byte-identical;
6. graph reference: its minimizer-space stages pass by pass on a copy of
   the port's read_data_corrected.txt with the port's per-pass parameters,
   in the order of pipeline/asm.py (the assembly-graph exports are left
   out). Every pass's kminmerData_abundance.txt, kminmerData_min.txt (first
   two passes), unitigGraph.*.bin, filter/unitigs_*.bin, contigs.nodepath,
   refined abundances, smallContigs_k*.bin and unitig_data.txt
   (contig_data_init.txt at the last pass) must be byte-identical;
7. post-processing and toBasespace reference: its derepSmall,
   removeOverlaps, removeRepeats and toBasespace, on one thread, on a copy
   of the port's tmp as the last pass left it. contig_data_init_small.txt
   {,.nooverlaps,.norepeats}, readsVsContigsAlignments.bin and
   contig_data_final.bin must be byte-identical, and contigs.fasta.gz too
   outside the gzip header's write time (bytes 4-7);
9. correction reference: its ONT read selection and read correction, on one
   thread, on the ONT reads of phase 8: read_data_init.txt, read_stats.txt,
   repetitiveMinimizers.bin, readAlignmentsLowDensity.bin and
   read_data_corrected.txt must be byte-identical, and the logged
   correction checksums equal;
10. gfa and map references: the JAX package's `gfa OUT 0`, `gfa OUT K
   --coverage --readpath` and `map OUT K --references ...` on a copy of
   each output directory's inputs (started as soon as the asm has written
   them, beside the running phases): the listing and every file written
   (assemblyGraph_k<K>.gfa, .noseq.gfa, _contigPath.tsv, _contigNames.csv,
   _readPath.tsv, .contigColor.csv, .contigName.csv) must be
   byte-identical to phases 4b and 8b's. Prints the JAX walls beside the
   port's (host numpy against the port on the card, one thread each).
11. two ranks on the one card (started when phase 8 ends, beside 8b, 11b
   and the references): phase 8's ONT reads, not cut, through `asm
   --in-ont --device cuda --threads 4` in two subprocesses, each with the
   JAX package refused and `os.fork` raising, as ranks 0 and 1 of a
   torch.distributed group over gloo (METAMDBG_TPU_DISTRIBUTED, a
   localhost coordinator, METAMDBG_TPU_DIST_BACKEND=gloo: NCCL puts no two
   ranks of one communicator on one GPU), one torch thread each, an out
   dir each. Every stage of both must have run as port:cuda in a group of
   2 over gloo, every kernel launched, and readCorrection's pair joins
   (K6), the first pass's count (K5) and toBasespace's window POAs sharded
   (tmp/device.json); phase 9's files, post-processing's and
   toBasespace's artifacts, the first pass's kminmerData_abundance_init.txt
   and contigs.fasta.gz (outside bytes 4-7) must be byte-identical on both
   ranks to phase 8's. Prints per rank the stage walls, asm wall, peak
   RSS (its own process's), K5's and K6's shard sizes, the POA windows it
   polished and its correction and polish timing lines;
11b. NCCL on a one-rank group in this process: the sharded count table
   (K5) on phase 8's first-pass reads at k = 4 and on ~50.7M synthetic
   minimizers (the k = 4 table of a 10.14 Gbp HiFi run) in ~845k reads,
   held against the single-device table (every window counted by K2, keys
   by KW); the sharded pair join (K6) on phase 8's first correction chunk
   (its table and query pairs, kept as phase 8 ran) and on a synthetic
   table of 2^25 pairs with as many queries, held against the sorted
   join; tolerance 0 (integers). Each step is timed with CUDA events on a
   second call (hash, route, split exchange, row exchange, local
   sort-count or join, gather, merge or expand) beside its bound, the
   bytes it must move at the memory rate. The group is torn down after.
4t. `--threads 8` with the bounded-memory paths (started when every
   other phase and reference has ended, so that its walls have the host's
   cores): phase 4's reads through `python -m metamdbg_tpu_torch asm
   --in-hifi ... --device cuda --threads 8` in a subprocess, the JAX
   package refused and `os.fork` raising, under BOUND_ENV (below): the
   native engines' batches split over 8 Python threads
   (utils/threadmap.py), the first pass counted in read chunks, the
   polish partitions cut under the bound. Every pass's graph artifact
   digests, read selection's three files, post-processing's and
   toBasespace's files and contigs.fasta.gz (outside bytes 4-7) must be
   byte-identical to phase 4's, and the count must have run in more than
   one chunk. Prints os.cpu_count() and os.getloadavg() at its start, the
   count chunks, correction partitions and polish partitions, its stage
   walls beside phase 4's, both runs' tiling and polish pass timing lines
   (map, cut, index, packing and POA walls), its asm wall and its own
   peak RSS.
12. ONT with the bounded-memory paths (after phase 4t): phase 8's reads
   through `asm --in-ont --device cuda --threads 8` in a subprocess, the
   JAX package refused and `os.fork` raising, under BOUND_ENV. The count
   chunks, correction partitions and polish partitions must each be more
   than one. Correction partitions write the corrected reads partition by
   partition, in the JAX package as in the port, so read_data_corrected.txt
   holds phase 8's records in another order (and every later artifact
   follows that order), and polish partitions polish each contig with
   the reads of its partition only: neither is phase 8's file. So
   read_data_init.txt, read_stats.txt, repetitiveMinimizers.bin and
   readAlignmentsLowDensity.bin (made before the partitions) must be
   phase 8's; read_data_corrected.txt must hold phase 8's records, and be
   byte-identical, with the same correction checksum, to the JAX
   package's read selection and correction under BOUND_ENV (phase 9's
   reference again, started beside it); the contigs must pass phase 8's
   length check. Prints the bounded paths' evidence, the stage walls, the
   asm wall and its own peak RSS.
BOUND_ENV is tools/scale_run.py's (count table 0.02 GB, correction memory
0.1 GB, polish partition 0.5 GB), scaled to these inputs (120 and 86 Mbp
against its 1.1 and 0.55 Gbp): 0.002, 0.01 and 0.05 GB.

The line before the last four is a JSON object with phase 4t's and phase
12's results ("threads", "bounded_ont"); the line before the last three
one with phases 11 and 11b's results ("sharded"). The line before the
last two is a JSON object describing each kernel: its launches in phase
4 (K4's in phase 8), its largest difference from the plain version, its time and the plain version's (phase 3 at density
0.005, 3b's segmented mode on the reads at w = 16, 3d, 3e), `bound_ms`,
the least time the card could
take for the same work on those inputs (the larger of bytes over the
memory rate and operations over the peak rates), with what bounds it, and
the main path's own launches timed again: `main_path_ms` and
`main_path_bound_ms` summed over `main_path_launches_timed` of them; the
sketch and window hash kernels' entries add `gfa_map_launches`, their
launches in each `gfa` and `map` run of phases 4b and 8b and the largest
difference from the plain version on their replay; the window hash
kernel's adds its phase 4 launches by call site and the explicit-starts
mode's time and bound on the same windows and on the dense stream at
w = 16. The line before the
last is the card's nvidia-smi name and power limit; the last is
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import contextlib
import glob
import gzip
import hashlib
import importlib.abc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
L_MIN, DENSITIES = 15, (0.005, 0.025, 0.1)
GENOME_LEN = 4_000_000
KW_STREAM, KW_WIDTHS, KW_TIMED = 4_194_304, (4, 5, 6, 7, 16, 61, 123), 16
# phase 3b's other start layouts: hash_rows-style row slices of a (2^20, 24)
# table, and whole unitigs back to back (per-window widths up to 20,000,
# 24 distinct ones)
KW_ROWS, KW_ROW_K, KW_UNITIGS, KW_UNITIG_MAX = 1 << 20, 24, 4_000, 20_000
# phase 3b's segmented mode: reads of 0..KW_READ_MAX minimizers (~105k of
# them in KW_STREAM words, as a 1.1 Gbp HiFi run's 110,526 reads hold 4.3M)
KW_READ_MAX = 80
# kernel times: CUDA events around this many back-to-back launches on
# outputs allocated once, divided by the count; the median of 3 such runs
TIME_REPS, TIME_TRIALS = 20, 3
# the replay keeps the KW launches that together hold this share of the
# main path's windows x width, and every per-window-width launch
KW_REPLAY_SHARE = 0.9
FIRST_K = 4

JAX_REFERENCE = os.path.join(REPO, "tests", "jax_reference.py")
BASESPACE_OUTPUTS = ("contig_data_init_small.txt",
                     "contig_data_init_small.txt.nooverlaps",
                     "contig_data_init_small.txt.norepeats",
                     "readsVsContigsAlignments.bin", "contig_data_final.bin")
CHAIN_GROUPS, CHAIN_MAX_LEN, CHAIN_LONG = 16_384, 300, (5_000, 7_500, 10_000)
CHAIN_DP_GROUPS, CHAIN_DP_MAX_LEN = 500_000, 200
CHAIN_DP_BANDS, CHAIN_DP_TIMED = (62, 10, 125), 62
# lengths at the kernels' edges (empty groups and groups of 1 and 2
# anchors; K3's band of 10 and 16-byte gap rows, tiles of 1,024 anchors and
# spans of 2,048; K4's warps of 32, tiles of 256 and spans of 384), sets of
# groups that all run from device memory, and K4's bands at the edges of
# its 32-lane team's two register slots and one far past them
CHAIN_EDGES = (0, 1, 2, 0, 9, 10, 11, 15, 16, 17, 1023, 1024, 1025, 2047,
               2048, 2049)
CHAIN_ALL_LONG = (2049, 2100, 3000, 4000)
CHAIN_DP_EDGES = (0, 1, 2, 0, 31, 32, 33, 63, 64, 65, 255, 256, 257, 383,
                  384, 385)
CHAIN_DP_ALL_LONG = (385, 386, 1000, 4000)
CHAIN_DP_EDGE_BANDS = (32, 33, 64, 65, 300)
# the ONT asm's K4 call, kept by phase 8 (a directory .gitignore lists)
CHAIN_DP_SAVED = os.path.join(REPO, "chip_inputs", "chain_dp_main.pt")
# the ONT metagenome of tests/test_quality_harness.py:103-112 (~86 Mbp)
ONT_SIZES, ONT_COVERAGES = (500_000, 700_000, 900_000), (15, 35, 60)
ONT_TOTAL_LEN, ONT_LEN_TOLERANCE = 2_100_000, 0.02
CORRECTION_OUTPUTS = ("read_data_init.txt", "read_stats.txt",
                      "repetitiveMinimizers.bin",
                      "readAlignmentsLowDensity.bin",
                      "read_data_corrected.txt")
# what `gfa` and `map` read from an output's tmp/ (and its pass_k*/), and
# the files they write in it (assemblyGraph_k<K> + suffix)
GFA_INPUTS = ("parameters.gz", "input.txt", "read_data_init.txt",
              "repetitiveMinimizers.bin", "kminmerData_abundance_init.txt",
              "contig_data_final.bin")
GFA_OUTPUTS = (".gfa", ".noseq.gfa", "_contigPath.tsv", "_contigNames.csv",
               "_readPath.tsv", ".contigColor.csv", ".contigName.csv")

# The least time for a kernel's work: one H100 SXM at its full 700 W
# (NVIDIA's H100 data sheet). 32-bit integer work (the CUDA programming
# guide's throughput table for compute capability 9.0; 132 SMs at 1.98
# GHz): multiply-adds (IMAD) run on the FMA pipe and logic operations,
# funnel shifts, right shifts and compares on the INT32 pipe, 64 lanes per
# SM each; adds and left shifts run on either pipe (as IMAD or as IADD3 /
# SHF), and an SM issues at most 128 lanes a cycle (4 schedulers x 32). So
# the least time is the largest of the INT32-only operations on one pipe,
# the multiply-adds (with any f32 work) on the other, and all integer
# operations on both. The one-pipe yardstick below puts all integer work on
# one 64-lane pipe, with the earlier per-item estimates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
IMAD_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations per item, counted from the algorithm, not from either
# kernel's code: a 64-bit multiply is 4 32-bit multiply-adds (3 when one
# factor is below 2^32), a 64-bit rotate 2 funnel shifts, a 64-bit add, xor
# or compare 2 operations, a 64-bit shift-and-xor by 33 2.
# Each count is (multiply-adds, adds and left shifts, INT32-only).
# K1 per window: murmur64 of a key below 2^32 (k1 = key * C1: 3
# multiply-adds, rotate 2, * C2: 4, the seed and length folded into one
# xor: 1, h1 += h2 and h2 += h1: 4 adds, two fmix64 of 3 shift-xors (6) and
# 2 multiplies (8): 28, h1 + h2: 2 adds), the roll of fwd (left shift, or,
# mask: 3) and rev (xor, left shift, right shift, or: 4), the bad-base test
# (3), the canonical pick and direction (2), the cut (2) and the validity
# test (2): (23, 8, 29), 60 in all (the earlier estimate: 80).
# KW per window of width w: per 16-byte block, mix_k1 and mix_k2 (2
# multiplies and a rotate each: 8 + 2 apiece), 2 xors, 2 rotates, 2 adds
# (12, the adds 4) and h * 5 + c twice (3 each: the multiplier is below
# 2^32): (22, 4, 12), w // 4 of them; the tail mixes 1 or 2 leftover words
# (8, 0, 4) or 3 (16, 0, 8); the finalizer (16, 8, 16): 4 xors and adds of
# the length (4 + 4), two fmix64 (16 multiply-adds, 12), 2 adds (4); the
# direction scan (0, 0, 2), one compared pair: the first pair differs in all
# but the rare palindromic prefixes, so this stays a least count. The
# earlier estimate was 150 at every w.
# K3 and K4 per (anchor, predecessor) test: 15 integer operations and 2
# f32 operations.
K1_OPS, K1_OPS_ONE_PIPE, KW_OPS_ONE_PIPE = (23, 8, 29), 80, 150
K3_INT_OPS, K3_F32_OPS = 15, 2
K4_INT_OPS, K4_F32_OPS = 15, 2


def kw_ops(w, normalize):
    """(multiply-adds, adds, INT32-only operations) of one KW window of
    width w (see above)."""
    nb, halves = w // 4, (0, 1, 1, 2)[w % 4]
    return (22 * nb + 8 * halves + 16, 4 * nb + 8,
            12 * nb + 4 * halves + 16 + (2 if normalize else 0))


class _RefuseJaxPackage(importlib.abc.MetaPathFinder):
    """Refuses `metamdbg_tpu`, the JAX package: the port's main path runs
    without it."""

    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "metamdbg_tpu":
            raise ImportError(f"{name}: the JAX package is refused in "
                              f"chip_smoke.py's process")
        return None


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def device_phase():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no usable NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return smi


def build_phase():
    from metamdbg_tpu_torch.kernels import build, chain as kchain
    from metamdbg_tpu_torch.kernels import chain_dp as kchain_dp
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw

    def timed(name, sources):
        t0 = time.perf_counter()
        path = build.build(name, sources)
        return path, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(timed, "sketch", ksketch._SOURCES),
                pool.submit(timed, "window_hash", kw._SOURCES),
                pool.submit(timed, "chain_contig", kchain._SOURCES),
                pool.submit(timed, "chain_dp", kchain_dp._SOURCES)]
        for job in jobs:
            path, dt = job.result()
            print(f"build: {os.path.relpath(path, REPO)} in {dt:.2f} s")


def _tiles(n, L, l, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[rng.random((n, L)) < 0.003] = 4
    for r in range(n):
        for s in rng.integers(0, L - l, size=6):
            codes[r, s:s + l - 1] = 4
    return codes


def _tandem_row(L, l, density, cap, seed, device):
    """One 6-base period repeated: when a window of it is selected, the
    row selects ~L/6 windows, more than the cap."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch

    rng = np.random.default_rng(seed)
    while True:
        row = np.resize(rng.integers(0, 4, size=6, dtype=np.uint8), L)
        t = torch.from_numpy(row[None]).to(device)
        if int(ksketch.sketch_tiles_reference(t, l, density, 1)[3][0]) > cap:
            return row


def bound(nbytes, int_ops, f32_ops=0, mul_ops=0, either_ops=0):
    """(bound_ms, bound_by): the larger of the bytes' time at the memory
    rate and the operations' time at the peak rates: the INT32 pipe's
    (INT32-only int_ops), the FMA pipe's (integer multiply-adds mul_ops,
    then f32 operations), and both pipes' for all integer operations
    (either_ops, adds and left shifts, go to whichever is free)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S,
                mul_ops / IMAD_OPS_PER_S + f32_ops / F32_OPS_PER_S,
                (int_ops + mul_ops + either_ops)
                / (INT32_OPS_PER_S + IMAD_OPS_PER_S)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_one_pipe(nbytes, int_ops, f32_ops=0):
    """bound() with all integer work on one pipe, the earlier yardstick."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT32_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, reps=TIME_REPS, trials=TIME_TRIALS, graph=True):
    """Device ms per call of `fn`, which enqueues work on the current
    stream and does not wait: after a warm-up, CUDA events around `reps`
    back-to-back calls, divided by `reps`; the median of `trials` runs.
    graph: `fn` launches kernels on outputs allocated once and waits for
    nothing, so its `reps` calls are captured once into a CUDA graph and
    the events enclose replays of the graph; no host time of the Python
    and ctypes launch path reaches the card's timeline, which matters for
    launches of a few microseconds. graph=False (the plain versions, which
    allocate and may wait): the calls run as they are."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    run = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run = g.replay
        run()
        torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if run is not None:
            run()
        else:
            for _ in range(reps):
                fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(fn, reps=TIME_REPS):
    """Host clock per call of a wrapper that returns its result (and may
    wait for the card), after a warm-up; the card is idle at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def k1_bound(n, L, l, cap, one_pipe=False):
    """bound() of one K1 launch on (n, L) tiles: the codes in, the (n, cap)
    positions, values and directions and the counts out. one_pipe: the
    earlier estimate and yardstick."""
    nbytes, nk = n * L + n * cap * (4 + 4 + 1) + n * 4, n * (L - l + 1)
    if one_pipe:
        return bound_one_pipe(nbytes, K1_OPS_ONE_PIPE * nk)
    mul, either, other = (nk * x for x in K1_OPS)
    return bound(nbytes, other, mul_ops=mul, either_ops=either)


def k1_case(i, dev):
    """Phase 3's inputs at DENSITIES[i]: (512, 16384) u8 tiles with bad
    bases and separators, an overflow row (7) and a row of separators only
    (11), on `dev`; returns (codes, density, cap)."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.sketch.batch import TILE_LEN, TILE_ROWS

    density = DENSITIES[i]
    cap = ksketch.compact_cap(TILE_LEN - L_MIN + 1, density)
    codes = _tiles(TILE_ROWS, TILE_LEN, L_MIN, seed=100 + i)
    codes[7] = _tandem_row(TILE_LEN, L_MIN, density, cap, 200 + i, dev)
    codes[11] = 4  # a row of separators only
    return torch.from_numpy(codes).to(dev), density, cap


def kernel_phase(dev):
    """Kernel against plain version at (512, 16384) at the main path's three
    densities; returns per density a dict of max_abs_err, kernel ms, plain
    ms, host ms per sketch_tiles call and the bound."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.sketch.batch import TILE_LEN, TILE_ROWS

    out = {}
    l = L_MIN
    nk = TILE_LEN - l + 1
    for i in range(len(DENSITIES)):
        codes, density, cap = k1_case(i, dev)
        res = ksketch.sketch_tiles(codes, l, density, cap)
        torch.cuda.synchronize()
        ref = ksketch.sketch_tiles_reference(codes, l, density, cap)
        over = torch.nonzero(ref[3] > cap).flatten()
        ref_over = ksketch.sketch_tiles_reference(
            codes.index_select(0, over).contiguous(), l, density, nk)
        if over.tolist() != [7] or res.overflow_rows.tolist() != [7]:
            fail(f"density {density}: overflow rows kernel "
                 f"{res.overflow_rows.tolist()} plain {over.tolist()}")

        counts = ref[3].to(torch.int64)
        err = int((res.counts.to(torch.int64) - counts).abs().max())
        col = torch.arange(cap, device=dev)[None, :]
        live = col < counts.clamp(max=cap)[:, None]
        for g, w in zip((res.positions, res.values, res.directions), ref[:3]):
            d = (g.to(torch.int64) - w.to(torch.int64)).abs()
            err = max(err, int(d[live].max()))
        m = int(counts[7])
        for g, w in zip(res.overflow, ref_over[:3]):
            d = (g[0, :m].to(torch.int64) - w[0, :m].to(torch.int64)).abs()
            err = max(err, int(d.max()))
        if err != 0 or int(counts[11]) != 0:
            fail(f"density {density}: kernel differs from the plain version "
                 f"(max abs err {err}, separator row count "
                 f"{int(counts[11])})")

        buf = ksketch._launch(codes, l, density, cap)
        k_ms = _time_ms(lambda: ksketch._enqueue(codes, l, density, cap, buf))
        p_ms = _time_ms(lambda: ksketch.sketch_tiles_reference(
            codes, l, density, cap), reps=2, graph=False)
        host_ms = _host_ms(lambda: ksketch.sketch_tiles(codes, l, density,
                                                        cap))
        n = TILE_ROWS
        b_ms, b_by = k1_bound(n, TILE_LEN, l, cap)
        old_b = k1_bound(n, TILE_LEN, l, cap, one_pipe=True)[0]
        sel = int(counts.sum())
        print(f"kernel sketch_tiles (512, 16384) l={l} density={density} "
              f"cap={cap}: bit-identical to plain ({sel} selected, overflow "
              f"row count {m}, separator row 0); kernel {k_ms:.4f} ms, "
              f"plain torch {p_ms:.4f} ms per batch; sketch_tiles "
              f"{host_ms:.4f} ms host clock per call; bound {b_ms:.4f} ms "
              f"({b_by}; {old_b:.4f} ms on one pipe at the earlier count)")
        out[density] = dict(err=err, ms=k_ms, plain_ms=p_ms, host_ms=host_ms,
                            bound=(b_ms, b_by))
    return out


def _kw_stream(n, seed):
    """u32 minimizers < 2^30 with values near 2^32 - 1 and palindromic
    windows of every tested width planted."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 1 << 30, size=n, dtype=np.int64)
    near = rng.integers(0, n, size=n // 100)
    cat[near] = (1 << 32) - 1 - rng.integers(0, 3, size=near.shape[0])
    for w in KW_WIDTHS:
        for s in rng.integers(0, n - w, size=2000):
            h = w // 2
            cat[s + w - h:s + w] = cat[s:s + h][::-1].copy()
    return cat


def kw_launch_bound(cat_numel, starts, w, normalize, one_pipe=False):
    """bound() of one KW launch with explicit starts: the stream words its
    windows touch (at most the whole stream) counted as u32 words, 4 bytes
    each, as the segmented mode reads them, so that the bound reads the
    same work whichever kernel does it; the starts (and widths) in, two
    int64 hash words out per window; kw_ops per window. one_pipe: the
    earlier count, the whole stream at 8 bytes a word and 150 operations
    per window at every width."""
    n = starts.numel()
    if one_pipe:
        return bound_one_pipe(cat_numel * 8 + n * 8 + n * 16,
                              KW_OPS_ONE_PIPE * n)
    if isinstance(w, int):
        words, extra = n * w, 0
        mul, either, other = (n * x for x in kw_ops(w, normalize))
    else:
        words, extra = int(w.sum()), n * 8
        nb = int((w // 4).sum())
        halves = int(torch.tensor([0, 1, 1, 2], device=w.device)[w % 4]
                     .sum())
        mul = 22 * nb + 8 * halves + 16 * n
        either = 4 * nb + 8 * n
        other = 12 * nb + 4 * halves + n * (16 + 2 * normalize)
    return bound(min(cat_numel, words) * 4 + n * 8 + extra + n * 16, other,
                 mul_ops=mul, either_ops=either)


def kw_segments_bound(segs):
    """bound() of one segmented KW launch: every word of each sequence that
    has a window (4 bytes), those sequences' two table entries (first
    window, start word), the warps' first sequences and the descriptors
    in, two int64 hash words out per window; kw_ops per window. No start
    array: the mode has none."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    nbytes = mul = either = other = 0
    for s in segs:
        if not s.n_win:
            continue
        # a listed sequence of n_k windows holds n_k + w - 1 words
        words = s.n_win + (s.w - 1) * s.live_base.numel()
        nbytes += (4 * words + 16 * s.live_base.numel() + 8
                   + 8 * s.warp_seq.numel() + 8 * kw._SEG_WORDS
                   + 16 * s.n_win)
        m, e, o = kw_ops(s.w, s.normalize)
        mul, either, other = (mul + m * s.n_win, either + e * s.n_win,
                              other + o * s.n_win)
    return bound(nbytes, other, mul_ops=mul, either_ops=either)


def _kw_check(what, cat, starts, w, normalize):
    """KW through hash_windows against its plain version: bit-identical, or
    fail. Returns the max abs difference (0)."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    got = kw.hash_windows(cat, starts, w, normalize)
    torch.cuda.synchronize()
    want = kw.hash_windows_reference(cat, starts, w, normalize)
    diff = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
    err = int(torch.stack([got[0] - want[0], got[1] - want[1]]).abs().max())
    if diff or err:
        fail(f"window hash {what} normalize={normalize}: {diff} windows "
             f"differ from the plain version")
    return err


def _kw_time(what, cat, starts, w, normalize):
    """Times KW on one launch's inputs; returns (ms, bound)."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    n = starts.numel()
    out = torch.empty(2 * n + 1, dtype=torch.int64, device=cat.device)
    ms = _time_ms(lambda: kw._enqueue(cat, starts, w, normalize, out))
    b = kw_launch_bound(cat.numel(), starts, w, normalize)
    print(f"kernel window_hash {what}: {n} windows, kernel {ms:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]})")
    return ms, b


def kw_phase(dev):
    """KW against its plain version on every start layout the main path
    gives it: dense starts at seven widths, hash_rows-style row slices,
    shuffled starts, per-window widths from 1 word to a whole unitig.
    Returns a dict of max_abs_err, the kernel's ms, plain ms, host ms per
    hash_windows call and the bound at w = KW_TIMED, normalize on (the
    ladder's mode), with the earlier bound."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    rng = np.random.default_rng(302)
    cat = torch.from_numpy(_kw_stream(KW_STREAM, seed=300)).to(dev)
    err, result = 0, None
    for w in KW_WIDTHS:
        starts = torch.arange(KW_STREAM - w + 1, device=dev)
        win = cat[starts[:, None] + torch.arange(w, device=dev)]
        n_pal = int((win == win.flip(1)).all(dim=1).sum())
        del win
        for normalize in (True, False):
            err = max(err, _kw_check(f"w={w}", cat, starts, w, normalize))
        print(f"kernel window_hash w={w}: {starts.numel()} windows "
              f"({n_pal} palindromes), both modes bit-identical to plain")
        if w in (KW_TIMED, 61, 123):
            ms, b = _kw_time(f"dense w={w} normalize", cat, starts, w,
                             True)
        if w == KW_TIMED:
            p_ms = _time_ms(lambda: kw.hash_windows_reference(
                cat, starts, w, True), reps=2, graph=False)
            host_ms = _host_ms(lambda: kw.hash_windows(cat, starts, w, True))
            old_b = kw_launch_bound(KW_STREAM, starts, w, True,
                                    one_pipe=True)
            print(f"kernel window_hash w={w} normalize: plain torch "
                  f"{p_ms:.4f} ms per {starts.numel()} windows; hash_windows "
                  f"{host_ms:.4f} ms host clock per call; bound on one pipe "
                  f"at the earlier count {old_b[0]:.4f} ms ({old_b[1]})")
            result = dict(ms=ms, plain_ms=p_ms, host_ms=host_ms, bound=b,
                          bound_one_pipe=old_b)

    # hash_rows' layout: row slices of an (N, k) table, starts i*k + first
    rows = torch.from_numpy(rng.integers(0, 1 << 32, size=(KW_ROWS, KW_ROW_K),
                                         dtype=np.int64)).to(dev).view(-1)
    k = KW_ROW_K
    for first, width in ((1, k - 1), (0, k - 1), (0, k)):
        starts = torch.arange(KW_ROWS, device=dev) * k + first
        for normalize in (False, True):
            err = max(err, _kw_check(f"rows first={first} w={width}", rows,
                                     starts, width, normalize))
    _kw_time(f"rows ({KW_ROWS}, {k}) first=1 w={k - 1} raw", rows,
             torch.arange(KW_ROWS, device=dev) * k + 1, k - 1, False)
    # every window of the stream in a shuffled order
    starts = torch.from_numpy(rng.permutation(KW_STREAM - KW_TIMED + 1)).to(
        dev)
    for normalize in (True, False):
        err = max(err, _kw_check("shuffled starts", cat, starts, KW_TIMED,
                                 normalize))
    _kw_time(f"shuffled starts w={KW_TIMED} normalize", cat, starts,
             KW_TIMED, True)
    # per-window widths: narrow windows over the stream, and whole unitigs
    # back to back up to KW_UNITIG_MAX words
    narrow = torch.from_numpy(rng.integers(1, 17, KW_STREAM - 16)).to(dev)
    starts = torch.arange(KW_STREAM - 16, device=dev)
    # 24 distinct widths: the plain version runs once per distinct width
    widths = torch.from_numpy(rng.choice(np.unique(np.geomspace(
        1, KW_UNITIG_MAX, 24).astype(np.int64)), KW_UNITIGS)).to(dev)
    useq = torch.cumsum(widths, 0) - widths
    ucat = torch.from_numpy(_kw_stream(int(widths.sum()), seed=303)).to(dev)
    for normalize in (False, True):
        err = max(err, _kw_check("per-window widths 1..16", cat, starts,
                                 narrow, normalize))
        err = max(err, _kw_check(f"unitigs up to {KW_UNITIG_MAX} words",
                                 ucat, useq, widths, normalize))
    _kw_time("per-window widths 1..16 normalize", cat, starts, narrow, True)
    _kw_time(f"{KW_UNITIGS} unitigs up to {KW_UNITIG_MAX} words raw", ucat,
             useq, widths, False)
    print("kernel window_hash: dense starts at every width, row slices, "
          "shuffled starts and per-window widths bit-identical to plain")
    result["err"] = err
    return result


def _kw_segments_check(what, segs, n_total):
    """One segmented KW launch against its plain version: bit-identical,
    or fail. Returns (the kernel's output, the max abs difference (0))."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    got = kw._launch_segments(segs, n_total)
    torch.cuda.synchronize()
    want = kw.hash_segments_reference(segs, n_total)
    diff = int((got != want).sum())
    err = int((got - want).abs().max()) if n_total else 0
    if diff or err:
        fail(f"window hash segments {what}: {diff} hash words differ from "
             f"the plain version")
    return got, err


def _kw_segments_timer(segs, n_total):
    """A launch of the segmented kernel on `segs` that does not wait, into
    an output and a descriptor table made once."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    dev = segs[0].words.device
    table = torch.from_numpy(kw._descriptors(segs)).to(dev)
    live = sum(1 for s in segs if s.n_win)
    tiles = kw._n_tiles(segs)
    out = torch.empty(2 * n_total, dtype=torch.int64, device=dev)
    return lambda: kw._enqueue_segments(table, live, tiles, out)


def _kw_reads(n_words, seed):
    """Reads-like host sequences of u32 minimizers, KW_READ_MAX words at
    most (empty ones and ones shorter than every width among them), cut
    from phase 3b's stream with a quarter of the words past 2^31 (the
    int32 carriage's sign bit) and palindromic windows of every tested
    width at the starts of some."""
    rng = np.random.default_rng(seed)
    cat = _kw_stream(n_words, seed).astype(np.uint32)
    cat[rng.random(n_words) < 0.25] |= np.uint32(1 << 31)
    lens = rng.integers(0, KW_READ_MAX + 1, size=2 * n_words // KW_READ_MAX)
    lens = lens[np.cumsum(lens) <= n_words]
    seqs = np.split(cat[:lens.sum()], np.cumsum(lens)[:-1])
    for i, s in enumerate(seqs[::7]):
        w = KW_WIDTHS[i % len(KW_WIDTHS)]
        if s.shape[0] >= w:
            s[w - w // 2:w] = s[:w // 2][::-1].copy()
    return seqs


def kw_segments_phase(dev):
    """KW's segmented mode against its plain version on the card, on a
    reads-like stream of KW_STREAM words kept on the card and host
    sequences uploaded with the request: one request of segments at every
    width of KW_WIDTHS, normalize on and off, an empty segment and one
    whose sequences are all shorter than its width, the ladder's pass
    layout (refined nodes, reads and contigs at k-1 and k), and the same
    windows through the explicit-starts mode (int64 stream, one start per
    window): bit-identical (tolerance 0). Times the segmented mode at
    w = KW_TIMED, 40 and 61 beside the explicit mode on the same windows,
    the plain version and the host clock per request; returns a dict of
    max_abs_err, ms, plain_ms, host_ms, bound and the explicit mode's ms
    and bound at w = KW_TIMED."""
    from metamdbg_tpu_torch.count import kminmers
    from metamdbg_tpu_torch.kernels import window_hash as kw

    reads_host = _kw_reads(KW_STREAM, seed=310)
    reads = kw.Stream(reads_host).to(dev)
    rng = np.random.default_rng(311)
    short = [s[:int(rng.integers(0, KW_TIMED))] for s in reads_host[:2000]]
    contigs = [np.resize(s, int(rng.integers(KW_TIMED, 401)))
               for s in reads_host[2000:6000] if s.shape[0]]
    host = kw.Stream(short + contigs)
    n_short = len(short)
    requests = {
        "every width": [kw.Segment(reads, w, i % 2 == 0)
                        for i, w in enumerate(KW_WIDTHS)]
        + [kw.Segment(host, KW_TIMED, True, 0, n_short),
           kw.Segment(reads, 5, True, 7, 7),
           kw.Segment(host, 123, True, n_short),
           kw.Segment(host, 4, False)],
        "a ladder pass at k=16": [
            kw.Segment(host, 15, True, n_short, n_short + 300),
            kw.Segment(reads, 15), kw.Segment(host, 15, True, n_short),
            kw.Segment(reads, 16), kw.Segment(host, 16, True, n_short)]}
    err = 0
    for what, segments in requests.items():
        segs, n_total, table = kw._prepare(segments, dev)
        before = kw.launches
        got = kw.hash_segments(segments, dev)
        if kw.launches != before + 1:
            fail(f"window hash segments {what}: {kw.launches - before} "
                 f"launches for one request")
        out, e = _kw_segments_check(what, segs, n_total)
        err = max(err, e)
        if not (torch.equal(torch.cat([g[0] for g in got]), out[:n_total])
                and torch.equal(torch.cat([g[1] for g in got]),
                                out[n_total:])):
            fail(f"window hash segments {what}: hash_segments differs from "
                 f"the launch on its own request")
        # the same windows through the explicit-starts mode
        for s, (h1, h2, _) in zip(segs, got):
            if not s.n_win:
                continue
            cat = s.words.to(torch.int64) & 0xFFFFFFFF
            e1, e2 = kw.hash_windows(cat, kw.segment_starts(s), s.w,
                                     s.normalize)
            if not (torch.equal(e1, h1) and torch.equal(e2, h2)):
                fail(f"window hash segments {what} w={s.w}: the explicit "
                     f"mode differs")
        print(f"kernel window_hash segments {what}: {len(segs)} segments, "
              f"{n_total} windows, "
              f"{sum(1 for s in segs if not s.n_win)} without windows; one "
              f"launch, bit-identical to plain and to the explicit mode")
    result = None
    for w in (KW_TIMED, 40, 61):  # reads hold up to KW_READ_MAX words
        segs, n_total, _ = kw._prepare([kw.Segment(reads, w)], dev)
        ms = _time_ms(_kw_segments_timer(segs, n_total))
        b = kw_segments_bound(segs)
        cat = segs[0].words.to(torch.int64) & 0xFFFFFFFF
        e_ms, e_b = _kw_time(f"reads' windows w={w} normalize, explicit "
                             f"starts", cat, kw.segment_starts(segs[0]), w,
                             True)
        print(f"kernel window_hash segments reads w={w} normalize: "
              f"{len(reads)} sequences, {reads.words.numel()} words, "
              f"{n_total} windows: kernel {ms:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]}), {b[0] / ms:.1%} of the bound; explicit starts "
              f"{e_ms:.4f} ms (bound {e_b[0]:.4f} ms)")
        if w == KW_TIMED:
            p_ms = _time_ms(lambda: kw.hash_segments_reference(
                segs, n_total), reps=2, graph=False)
            host_ms = _host_ms(lambda: kw.hash_segments(
                [kw.Segment(reads, w)], dev))
            def earlier():
                """The host stream, starts and explicit launch of the
                earlier flat_window_hashes."""
                cat, lens = kminmers.stream(reads_host, dev)
                starts, _ = kminmers.window_starts(lens, w)
                return kw.hash_windows(cat, starts, w, True)

            old_ms = _host_ms(earlier, reps=3)
            print(f"kernel window_hash segments reads w={w}: plain torch "
                  f"{p_ms:.4f} ms; hash_segments {host_ms:.4f} ms host "
                  f"clock per request on the resident stream; the host "
                  f"stream, starts and explicit launch of the earlier "
                  f"flat_window_hashes {old_ms:.4f} ms")
            result = dict(ms=ms, plain_ms=p_ms, host_ms=host_ms, bound=b,
                          explicit_ms=e_ms, explicit_bound=e_b,
                          earlier_host_ms=old_ms)
    result["err"] = err
    return result


def count_phase(dev):
    from metamdbg_tpu_torch.kernels import count as kcount

    rng = np.random.default_rng(301)
    rows = rng.integers(0, 1 << 32, size=(1 << 20, 5), dtype=np.int64)
    rows[1::3] = rows[::3][:rows[1::3].shape[0]]
    rows[rng.random(rows.shape) < 0.1] = (1 << 32) - 1
    cpu = torch.from_numpy(rows)
    want = kcount.count_unique_rows(cpu)
    t0 = time.perf_counter()
    got = kcount.count_unique_rows(cpu.to(dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not (torch.equal(got[0].cpu(), want[0])
            and torch.equal(got[1].cpu(), want[1])):
        fail("row counting on the card differs from the CPU")
    rows_d = cpu.to(dev)
    ms = _time_ms(lambda: kcount.count_unique_rows(rows_d), graph=False)
    lib_ms = _time_ms(lambda: torch.unique(rows_d, dim=0,
                                           return_counts=True), graph=False)
    # int64 rows read once; unique rows and their int64 counts written once
    n_uniq = want[0].shape[0]
    b_ms, b_by = bound(rows.nbytes + n_uniq * (rows.shape[1] + 1) * 8, 0)
    print(f"row counting (2^20, 5): {n_uniq} unique rows, identical on the "
          f"card and the CPU ({dt * 1e3:.1f} ms on the card, first call); "
          f"{ms:.4f} ms a call after a warm-up, bound {b_ms:.4f} ms "
          f"({b_by}); torch.unique(dim=0, return_counts=True) {lib_ms:.4f} "
          f"ms")


def chain_groups(lengths, seed):
    """Anchor groups for the chain DP, made with numpy from a seed: per
    group (ref_pos, q_pos, q_bp, is_rev) sorted by (ref, query), a noisy
    collinear run on one strand (a few anchors on the other), noise
    anchors, base-space gaps of 50-700 bp between the read's minimizers,
    and an equal-score tie planted at the end of every third group (two
    predecessors with equal score and equal gap). Returns the flat arrays
    (int32, int32, int32, bool) and the int64 group offsets."""
    rng = np.random.default_rng(seed)
    parts = []
    for gi, n in enumerate(lengths):
        n = int(n)
        rev = bool(rng.random() < 0.5)
        span = 2 * n + 10
        ref = np.sort(rng.integers(0, span, n))
        q = ref + rng.integers(-3, 4, n)
        if rev:
            q = span - q
        noise = rng.random(n) < 0.15
        q[noise] = rng.integers(0, span, int(noise.sum()))
        q = np.clip(q, 0, None)
        is_rev = np.full(n, rev)
        is_rev[rng.random(n) < 0.05] ^= True
        if gi % 3 == 0:
            # A(r, Q), B(r+2, Q), C(r+4, Q+-3), 30 refs past the rest (out
            # of reach at d_r_max 25): C's candidates from A and from B are
            # equal; B, the nearer, must win
            r0 = int(ref.max(initial=0)) + 30
            q0 = 3 + (0 if rev else int(q.max(initial=0)) + 20)
            ref = np.concatenate([ref, [r0, r0 + 2, r0 + 4]])
            q = np.concatenate([q, [q0, q0, q0 - 3 if rev else q0 + 3]])
            is_rev = np.concatenate([is_rev, [rev] * 3])
        order = np.lexsort((q, ref))
        ref, q, is_rev = ref[order], q[order], is_rev[order]
        bp = np.cumsum(rng.integers(50, 700, int(q.max(initial=0)) + 1))
        parts.append((ref, q, bp[q], is_rev))
    offsets = np.zeros(len(parts) + 1, np.int64)
    offsets[1:] = np.cumsum([p[0].shape[0] for p in parts])
    flat = [np.concatenate([p[i] for p in parts]) for i in range(4)]
    return (flat[0].astype(np.int32), flat[1].astype(np.int32),
            flat[2].astype(np.int32), flat[3].astype(bool), offsets)


def chain_dp_groups(lengths, seed):
    """Anchor groups for the correction chain DP, made with numpy from a
    seed, all at once: per group a query read of `n` pairs, its pair
    centres ~200 bp apart (q_pos rises with q_idx), matched collinearly on
    one strand with +-40 bp of noise (a few anchors on the other strand),
    15% noise anchors, and in every third group an equal-score tie planted
    5,000+ bp past the rest (two predecessors at one query position, each
    starting a chain, and an anchor that both reach with equal gaps).
    Each group is sorted by (ref, query). Returns ref_pos, q_pos (int64),
    is_rev (bool), q_idx (int32) and the int64 group offsets."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    n_groups = lengths.shape[0]
    gid = np.repeat(np.arange(n_groups), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    k = np.arange(gid.shape[0]) - starts[gid]
    rev_g = rng.random(n_groups) < 0.5
    shift = rng.integers(0, 20_000, n_groups)
    span = 200 * lengths + 100
    noise = rng.random(k.shape[0]) < 0.15
    q_idx = np.where(noise, rng.integers(0, np.maximum(lengths[gid], 1)), k)
    q_pos = 200 * q_idx + (q_idx * 7919) % 97
    ref = np.where(rev_g[gid], span[gid] - q_pos, q_pos) + shift[gid] + \
        rng.integers(-40, 41, k.shape[0])
    ref = np.where(noise, shift[gid] + rng.integers(0, span[gid]), ref)
    is_rev = rev_g[gid] ^ (rng.random(k.shape[0]) < 0.05)
    # A (r, Q), B (r + 2, Q) and C (r + 4, Q +- 3) on the group's strand:
    # C's candidates from A and from B are equal; B, the nearer, must win
    tie = np.flatnonzero(np.arange(n_groups) % 3 == 0)
    r0 = shift[tie] + span[tie] + 6_000
    q0 = 200 * lengths[tie] + 50
    qc = np.where(rev_g[tie], q0 - 3, q0 + 3)
    gid = np.concatenate([gid, np.repeat(tie, 3)])
    ref = np.concatenate([ref, np.stack([r0, r0 + 2, r0 + 4], 1).ravel()])
    q_pos = np.concatenate([q_pos, np.stack([q0, q0, qc], 1).ravel()])
    q_idx = np.concatenate([q_idx, np.stack(
        [lengths[tie], lengths[tie], lengths[tie] + 1], 1).ravel()])
    is_rev = np.concatenate([is_rev, np.repeat(rev_g[tie], 3)])
    ref = np.clip(ref, 0, None)
    # one sort: group, then ref, then query (each below 2^21)
    order = np.argsort((gid << 42) | (ref << 21) | q_pos, kind="stable")
    offsets = np.zeros(n_groups + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(gid, minlength=n_groups))
    return (ref[order].astype(np.int64), q_pos[order].astype(np.int64),
            is_rev[order], q_idx[order].astype(np.int32), offsets)


def chain_contig_bound(sizes):
    """bound() of one K3 call on groups of `sizes` anchors."""
    from metamdbg_tpu_torch.kernels.chain import BAND

    n = int(sizes.sum())
    # (anchor, predecessor) tests: min(i, 10) for anchor i of its group
    tests = sum(m * (m - 1) // 2 if m <= BAND else
                BAND * (BAND - 1) // 2 + (m - BAND) * BAND
                for m in sizes.tolist())
    # in: ref, q, q_bp (int32), is_rev (u8), offsets (int64); out: scores,
    # parents (4 bytes each), best_index (int32)
    return bound(n * 13 + (sizes.size + 1) * 8 + n * 8 + sizes.size * 4,
                 K3_INT_OPS * tests, f32_ops=K3_F32_OPS * tests)


def _k3_check(what, inputs, d_r_max):
    """K3 against its plain version on `inputs`, or fail; returns (the
    kernel's outputs, max_abs_err)."""
    from metamdbg_tpu_torch.kernels import chain as kchain

    got = kchain.chain_contig(*inputs, d_r_max)
    torch.cuda.synchronize()
    want = kchain.chain_contig_reference(*inputs, d_r_max)
    same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))
    err = 0.0
    if inputs[0].numel():
        err = max(float((got[0] - want[0]).abs().max()),
                  int((got[1].to(torch.int64)
                       - want[1].to(torch.int64)).abs().max()))
    if want[2].numel():
        err = max(err, int((got[2].to(torch.int64)
                            - want[2].to(torch.int64)).abs().max()))
    if not same:
        fail(f"chain kernel on {what} differs from the plain version (max "
             f"abs err {err})")
    return got, err


def _edge_lengths(edges, n, hi, seed):
    """Group lengths: `edges` between n random ones in [2, hi) before and
    after, each at an index that is not a multiple of 3 (chain_groups and
    chain_dp_groups plant a tie of 3 anchors in those), with a group of 3
    at each multiple. A group at least a tile long straddles a tile."""
    rng = np.random.default_rng(seed)
    cells = []
    for k in range(0, len(edges), 2):
        cells += [3, *edges[k:k + 2]]
    return np.concatenate([rng.integers(2, hi, 3 * (n // 3)), cells,
                           rng.integers(2, hi, n)]).astype(np.int64)


def chain_phase(dev):
    """K3 against its plain version; returns (max_abs_err, kernel ms, plain
    ms, bound)."""
    from metamdbg_tpu_torch.basespace.contig_mapper import _d_r_max
    from metamdbg_tpu_torch.kernels import chain as kchain

    rng = np.random.default_rng(400)
    lengths = np.concatenate([rng.integers(2, CHAIN_MAX_LEN + 1,
                                           CHAIN_GROUPS), CHAIN_LONG])
    rng.shuffle(lengths)
    t0 = time.perf_counter()
    arrays = chain_groups(lengths, seed=401)
    gen_s = time.perf_counter() - t0
    inputs = [torch.from_numpy(a).to(dev) for a in arrays]
    # the asm's: avg_dist = 1 / f32(density 0.005)
    d_r_max = _d_r_max(float(1.0 / np.float32(0.005)))

    got, err = _k3_check("phase 3d's groups", inputs, d_r_max)
    buf = kchain._launch(*inputs, d_r_max)
    k_ms = _time_ms(lambda: kchain._enqueue(*inputs, d_r_max, buf))
    p_ms = _time_ms(lambda: kchain.chain_contig_reference(*inputs, d_r_max),
                    reps=1, trials=2, graph=False)
    sizes = np.diff(arrays[4])  # chain_groups adds the planted ties
    n = int(sizes.sum())
    chain_bound = chain_contig_bound(sizes)
    chains = int((got[2] >= 0).sum())
    print(f"kernel chain_contig: {lengths.size} groups, {n} anchors (longest "
          f"{int(sizes.max())}, made in {gen_s:.1f} s), d_r_max {d_r_max}: "
          f"scores' f32 bits, parents and best indexes identical to plain "
          f"({chains} groups chained); kernel {k_ms:.4f} ms, plain torch "
          f"{p_ms:.4f} ms, bound {chain_bound[0]:.4f} ms ({chain_bound[1]})")
    for what, lengths in (
            ("edge lengths", _edge_lengths(CHAIN_EDGES, 2000, 80, 402)),
            ("groups all past the span", np.array(CHAIN_ALL_LONG))):
        arrays = chain_groups(lengths, seed=403)
        _, e = _k3_check(what, [torch.from_numpy(a).to(dev) for a in arrays],
                         d_r_max)
        err = max(err, e)
        print(f"kernel chain_contig on {what} ({lengths.size} groups, "
              f"{arrays[0].shape[0]} anchors, longest "
              f"{int(np.diff(arrays[4]).max())}): identical to plain")
    return err, k_ms, p_ms, chain_bound


def chain_dp_bound(sizes, band):
    """bound() of one K4 call on groups of `sizes` anchors at `band`."""
    m = np.asarray(sizes, np.int64)
    # (anchor, predecessor) tests: min(i, band) for anchor i of its group
    tests = int(np.where(m <= band + 1, m * (m - 1) // 2,
                         band * (band + 1) // 2 + (m - 1 - band) * band)
                .sum())
    n = int(m.sum())
    # in: ref, q, q_idx (int32), is_rev (u8), offsets (int64); out: scores,
    # parents, chain_pos (4 bytes each), best_index, chain_len, chain_score
    return bound(n * 13 + (m.size + 1) * 8 + n * 12 + m.size * 12,
                 K4_INT_OPS * tests, f32_ops=K4_F32_OPS * tests)


def _k4_inputs(arrays):
    """chain_dp's arguments as the kernel takes them: int32 positions."""
    ref, q, rev, q_idx, offsets = arrays
    return ref.to(torch.int32), q.to(torch.int32), rev, q_idx, offsets


K4_FIELDS = ("scores", "parents", "best_index", "chain_len", "chain_score",
             "chain_pos")


def _k4_check(what, kin, band, got=None):
    """K4's outputs `got` (else a launch through the wrapper's _launch)
    against the plain version on `kin` at `band`, or fail; returns (the
    kernel's outputs, max_abs_err)."""
    from metamdbg_tpu_torch.kernels import chain_dp as k4

    if got is None:
        got = k4._launch(*kin, band)
    torch.cuda.synchronize()
    want = k4.chain_dp_reference(*kin, band)
    same = torch.equal(got.scores.view(torch.int32),
                       want.scores.view(torch.int32)) and all(
        torch.equal(getattr(got, f), getattr(want, f)) for f in K4_FIELDS[1:])
    err = max([0.0] + [
        float((getattr(got, f).to(torch.float64)
               - getattr(want, f).to(torch.float64)).abs().max())
        for f in K4_FIELDS if getattr(want, f).numel()])
    if not same:
        fail(f"chain_dp kernel on {what} at band {band} differs from the "
             f"plain version (max abs err {err})")
    return got, err


def chain_dp_phase(dev):
    """K4 against its plain version at three bands, and on edge lengths at
    the bands of the kernel's edges; returns (max_abs_err, kernel ms, plain
    ms, bound) at the asm's band."""
    from metamdbg_tpu_torch.kernels import chain_dp as k4

    rng = np.random.default_rng(500)
    lengths = np.concatenate([rng.integers(3, CHAIN_DP_MAX_LEN + 1,
                                           CHAIN_DP_GROUPS), CHAIN_LONG])
    rng.shuffle(lengths)
    t0 = time.perf_counter()
    arrays = chain_dp_groups(lengths, seed=501)
    gen_s = time.perf_counter() - t0
    inputs = [torch.from_numpy(a).to(dev) for a in arrays]
    kin = _k4_inputs(inputs)
    sizes = np.diff(arrays[4])  # chain_dp_groups adds the planted ties
    err, result = 0, None
    for band in CHAIN_DP_BANDS:
        got, band_err = _k4_check("phase 3e's groups", kin, band,
                                  k4.chain_dp(*inputs, band))
        err = max(err, band_err)
        chains = int((got.chain_score != k4.INT32_MIN).sum())
        print(f"kernel chain_dp band {band}: {sizes.size} groups, "
              f"{int(sizes.sum())} anchors (longest {int(sizes.max())}, made "
              f"in {gen_s:.1f} s): scores' f32 bits, parents, best indexes, "
              f"chain lengths, chain scores and positions identical to plain "
              f"({chains} chains of >= 3 anchors, longest "
              f"{int(got.chain_len.max())})")
        if band == CHAIN_DP_TIMED:
            buf = k4._launch(*kin, band)
            k_ms = _time_ms(lambda: k4._enqueue(*kin, band, buf), reps=5)
            p_ms = _time_ms(lambda: k4.chain_dp_reference(*kin, band),
                            reps=1, trials=1, graph=False)
            b_ms, b_by = chain_dp_bound(sizes, band)
            print(f"kernel chain_dp band {band}: kernel {k_ms:.4f} ms, plain "
                  f"torch {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            result = (k_ms, p_ms, (b_ms, b_by))
        del got
    for what, lengths in (
            ("edge lengths", _edge_lengths(CHAIN_DP_EDGES, 2000, 40, 502)),
            ("groups all past the span", np.array(CHAIN_DP_ALL_LONG))):
        arrays = chain_dp_groups(lengths, seed=503)
        edge_kin = _k4_inputs([torch.from_numpy(a).to(dev) for a in arrays])
        for band in (CHAIN_DP_TIMED, *CHAIN_DP_EDGE_BANDS):
            err = max(err, _k4_check(what, edge_kin, band)[1])
        print(f"kernel chain_dp on {what} ({lengths.size} groups, "
              f"{arrays[0].shape[0]} anchors, longest "
              f"{int(np.diff(arrays[4]).max())}) at bands "
              f"{(CHAIN_DP_TIMED, *CHAIN_DP_EDGE_BANDS)}: identical to plain")
    return (err, *result)


GRAPH_ARTIFACTS = ("kminmerData_abundance.txt", "unitigGraph.nodes.bin",
                   "unitigGraph.edges.successors.bin",
                   "unitigGraph.nodes.abundances.bin",
                   "unitigGraph.stats.bin", "contigs.nodepath",
                   "unitigGraph.nodes.refined_abundances.bin")


def pass_digests(d, k, first_k, final):
    """sha256 of the graph artifacts a pass leaves in tmp dir `d`."""
    names = list(GRAPH_ARTIFACTS)
    names.append("contig_data_init.txt" if final else "unitig_data.txt")
    names.append(os.path.join("smallContigs", f"smallContigs_k{k}.bin"))
    if k <= first_k + 1:
        names.append("kminmerData_min.txt")
    names += sorted(os.path.relpath(p, d) for p in
                    glob.glob(os.path.join(d, "filter", "unitigs_*.bin")))
    out = {}
    for name in names:
        with open(os.path.join(d, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def write_reads(path, kind, genome_len=GENOME_LEN):
    """The inputs, made with tests/datagen.py from fixed seeds: `hifi`, a
    circular genome of `genome_len` bp at 30x HiFi; `ont`, the 3-genome ONT
    metagenome of tests/test_quality_harness.py:103-112 (~86 Mbp)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import datagen

    if kind == "hifi":
        datagen.make_test_fastq(path, genome_len=int(genome_len),
                                coverage=30, mean_length=12000,
                                error_rate=0.002, seed=1)
        return
    genomes = datagen.make_metagenome(n_genomes=3, sizes=list(ONT_SIZES),
                                      seed=40)
    datagen.write_fastq(path, datagen.metagenome_reads(
        genomes, list(ONT_COVERAGES), error_rate=0.01, ins_rate=0.004,
        del_rate=0.004, mean_quality=20, seed=41))


def reads_start(work, kind, genome_len=GENOME_LEN):
    """Starts write_reads in a subprocess; returns (path, process, start
    time)."""
    path = os.path.join(work, f"{kind}.fastq.gz")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.write_reads(*sys.argv[1:])", path, kind,
         str(genome_len)], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    return path, proc, time.perf_counter()


def reads_wait(job, what):
    path, proc, t0 = job
    if proc.wait() != 0:
        fail(f"generating the {what} reads exited {proc.returncode}")
    print(f"{what}: reads ready {time.perf_counter() - t0:.1f} s after "
          f"their generation started ({os.path.getsize(path) / 1e6:.1f} MB "
          f"gz)")
    return path


def _stage_walls(out):
    """Stage walls from tmp/memoryTrack.txt, the multi-k stages summed;
    and the peak RSS."""
    walls, rss = {}, ""
    for line in open(os.path.join(out, "tmp", "memoryTrack.txt")):
        name, dt, rss = line.split()
        name = re.sub(r"^k\d+_", "k*_", name)  # one line per multi-k stage
        walls[name] = walls.get(name, 0.0) + float(dt.rstrip("s"))
    return walls, rss


def _rss_rises(out):
    """[(stage, peak RSS after it)] for each stage that raised the peak."""
    rises, last = [], ""
    for line in open(os.path.join(out, "tmp", "memoryTrack.txt")):
        name, _, rss = line.split()
        if rss != last:
            rises.append((name, rss))
            last = rss
    return rises


TIMING_LINES = ("polish pass timing", " tiling: ", "correction timing")


def _timing_lines(out):
    """The stage timing lines of the asm's metaMDBG.log: each partition's
    tiling, each polish pass's and the correction's."""
    return [line.split(" INFO ", 1)[-1].strip()
            for line in open(os.path.join(out, "metaMDBG.log"))
            if any(key in line for key in TIMING_LINES)]


def _contigs(out):
    headers, lengths = [], []
    with gzip.open(os.path.join(out, "contigs.fasta.gz"), "rt") as f:
        for line in f:
            if line.startswith(">"):
                headers.append(line.strip())
                lengths.append(0)
            else:
                lengths[-1] += len(line.strip())
    return headers, lengths


def _same_contigs(a_path, b_path):
    a, b = open(a_path, "rb").read(), open(b_path, "rb").read()
    # bytes 4-7 of a gzip header hold the write time
    return gzip.decompress(a) == gzip.decompress(b) and \
        a[:4] + a[8:] == b[:4] + b[8:]


class LaunchRecorder:
    """Wraps a kernel module's `_launch` in this process, not in the
    package: keeps a copy of every launch's device inputs and the host
    clock of the call (allocation, launch and, for KW, the read of its
    flag), for replay after the run."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, module._launch, []

    def __enter__(self):
        def record(*args):
            t0 = time.perf_counter()
            out = self.real(*args)
            host_s = time.perf_counter() - t0
            self.calls.append((tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), host_s))
            return out

        self.module._launch = record
        return self

    def __exit__(self, *exc):
        self.module._launch = self.real


class KWRecorder:
    """LaunchRecorder for KW's two wrappers: `_launch` (explicit starts,
    inputs copied) and `_launch_segments` (the segmented mode), in launch
    order, each call ((mode, args), host seconds). A segmented launch keeps
    its Seg tuples as they are, not copies: nothing writes their tensors
    after the launch (a stream's words and offsets, a request's copy), and
    holding them keeps their memory from reuse."""

    def __init__(self, module):
        self.module, self.calls = module, []
        self.real = module._launch, module._launch_segments

    def __enter__(self):
        real_launch, real_segments = self.real

        def launch(*args):
            t0 = time.perf_counter()
            out = real_launch(*args)
            host_s = time.perf_counter() - t0
            self.calls.append((("starts", tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args)), host_s))
            return out

        def segments(segs, n_total, table=None):
            t0 = time.perf_counter()
            out = real_segments(segs, n_total, table)
            self.calls.append((("segments", (list(segs), n_total)),
                               time.perf_counter() - t0))
            return out

        self.module._launch, self.module._launch_segments = launch, segments
        return self

    def __exit__(self, *exc):
        self.module._launch, self.module._launch_segments = self.real


def _kw_pattern(call):
    """How a KW launch names its windows: segmented (how many segments),
    per-window widths, dense (most neighbours one word apart: a stream's
    every window), disjoint rows (no two windows overlap) or other."""
    mode, args = call
    if mode == "segments":
        return f"segmented, {sum(1 for s in args[0] if s.n_win)} segments"
    _, starts, w, _ = args
    if not isinstance(w, int):
        return "per-window widths"
    if starts.numel() < 2:
        return "dense"
    d = starts[1:] - starts[:-1]
    if float((d == 1).float().mean()) >= 0.5:
        return "dense"
    return "disjoint rows" if bool((d >= w).all()) else "other"


def kw_call_size(call):
    """(windows, window words) of a recorded KW launch."""
    mode, args = call
    if mode == "segments":
        segs, n_total = args
        return n_total, sum(s.n_win * s.w for s in segs)
    _, starts, w, _ = args
    n = starts.numel()
    return n, n * w if isinstance(w, int) else int(w.sum())


def kw_call_check(what, call):
    """A recorded KW launch again, against its plain version: bit-identical
    or fail; returns the max abs difference (0)."""
    mode, args = call
    if mode == "segments":
        return _kw_segments_check(what, *args)[1]
    return _kw_check(what, *args)


def kw_call_bound(call):
    """bound() of a recorded KW launch."""
    mode, args = call
    if mode == "segments":
        return kw_segments_bound(args[0])
    cat, starts, w, normalize = args
    return kw_launch_bound(cat.numel(), starts, w, normalize)


def kw_call_timer(call):
    """(a launch of a recorded KW call that does not wait, into outputs
    made once; its bound)."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    mode, args = call
    if mode == "segments":
        return _kw_segments_timer(*args), kw_call_bound(call)
    cat, starts, w, normalize = args
    out = torch.empty(2 * starts.numel() + 1, dtype=torch.int64,
                      device=cat.device)
    return ((lambda: kw._enqueue(cat, starts, w, normalize, out)),
            kw_call_bound(call))


KW_BINS = (1, 16, 256, 4096, 65536, 1 << 20)


def kw_replay_set(calls):
    """The recorded KW launches the replay times: those that hold
    KW_REPLAY_SHARE of the run's windows x width, largest first, and every
    per-window-width launch. Returns (their indexes in launch order, their
    share of the window words, per launch (windows, window words, host
    seconds))."""
    info = [(*kw_call_size(call), host_s) for call, host_s in calls]
    total_w = sum(x[1] for x in info)
    keep, acc = [], 0
    for i in sorted(range(len(calls)), key=lambda i: -info[i][1]):
        if acc < KW_REPLAY_SHARE * total_w or \
                _kw_pattern(calls[i][0]) == "per-window widths":
            keep.append(i)
            acc += info[i][1]
    return sorted(keep), acc / total_w, info


def kw_replay(calls):
    """Phase 4's KW launches: a histogram by size; then kw_replay_set's
    launches, checked against the plain version and timed again. Returns
    (sum of ms, sum of bound ms, launches timed)."""
    keep, share, info = kw_replay_set(calls)
    total_w = sum(x[1] for x in info)
    print(f"e2e kw launches: {len(calls)}, {sum(x[0] for x in info)} "
          f"windows, {total_w} window words, host clock "
          f"{sum(x[2] for x in info) * 1e3:.1f} ms in all")
    for lo, hi in zip(KW_BINS, KW_BINS[1:] + (1 << 62,)):
        sel = [x for x in info if lo <= x[0] < hi]
        if sel:
            print(f"e2e kw histogram [{lo}, {hi}) windows: {len(sel)} "
                  f"launches, {sum(x[0] for x in sel)} windows, "
                  f"{sum(x[1] for x in sel) / total_w:.2%} of window words, "
                  f"host {sum(x[2] for x in sel) * 1e3 / len(sel):.4f} ms "
                  f"per call")
    smallest = set(sorted(keep, key=lambda i: info[i][1])[:3])
    by_pattern = {}
    sums = [0.0, 0.0]
    for i in keep:
        call = calls[i][0]
        pattern = _kw_pattern(call)
        kw_call_check(f"main-path launch {i}", call)
        fn, (b_ms, b_by) = kw_call_timer(call)
        ms = _time_ms(fn)
        if pattern == "per-window widths" or i in smallest:
            print(f"e2e kw replay launch {i}: {pattern}, {info[i][0]} "
                  f"windows: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        p = by_pattern.setdefault(pattern.split(",")[0], [0, 0.0, 0.0, 0])
        p[0] += 1
        p[1] += ms
        p[2] += b_ms
        p[3] += b_by == "operations"
        sums[0] += ms
        sums[1] += b_ms
    for pattern, (c, ms, b_ms, n_ops) in by_pattern.items():
        print(f"e2e kw replay {pattern}: {c} launches, kernel {ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({n_ops} of {c} bound by operations)")
    # the small launches: what one costs the card, against its host call
    small = [i for i in range(len(calls)) if info[i][0] < KW_BINS[2]][:20]
    if small:
        dev_ms = [_time_ms(kw_call_timer(calls[i][0])[0]) for i in small]
        print(f"e2e kw small launches (< {KW_BINS[2]} windows): "
              f"{len(small)} replayed, {statistics.mean(dev_ms):.4f} ms per "
              f"launch back to back on the card; "
              f"{statistics.mean(info[i][2] for i in small) * 1e3:.4f} ms "
              f"host clock per launch in the run")
    print(f"e2e kw replay: {len(keep)} of {len(calls)} launches "
          f"({share:.2%} of window words): kernel {sums[0]:.4f} ms, bound "
          f"{sums[1]:.4f} ms; all bit-identical to plain")
    return sums[0], sums[1], len(keep)


def _k1_check(what, codes, l, density, cap):
    """One recorded K1 launch again, against its plain version:
    bit-identical, or fail. Returns the kernel's outputs."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch

    got = ksketch._launch(codes, l, density, cap)
    ref = ksketch.sketch_tiles_reference(codes, l, density, cap)
    if not torch.equal(got[3], ref[3]):
        fail(f"{what}: counts differ from plain")
    live = (torch.arange(cap, device=codes.device)[None, :]
            < ref[3].to(torch.int64).clamp(max=cap)[:, None])
    for g, w in zip(got[:3], ref[:3]):
        if not torch.equal(g.to(torch.int64)[live], w.to(torch.int64)[live]):
            fail(f"{what} differs from plain")
    return got


def k1_replay(calls):
    """Phase 4's K1 launches, checked against the plain version and timed
    again. Returns (sum of ms, sum of bound ms, launches)."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch

    sums = [0.0, 0.0]
    by_density = {}
    for (codes, l, density, cap), _ in calls:
        got = _k1_check("main-path sketch launch", codes, l, density, cap)
        ms = _time_ms(lambda: ksketch._enqueue(codes, l, density, cap, got))
        b_ms = k1_bound(codes.shape[0], codes.shape[1], l, cap)[0]
        d = by_density.setdefault(density, [0, 0.0, 0.0])
        for j, v in enumerate((1, ms, b_ms)):
            d[j] += v
        sums[0] += ms
        sums[1] += b_ms
    for density, (c, ms, b_ms) in by_density.items():
        print(f"e2e sketch replay density {density}: {c} launches, kernel "
              f"{ms:.4f} ms, bound {b_ms:.4f} ms")
    print(f"e2e sketch replay: {len(calls)} launches, kernel {sums[0]:.4f} "
          f"ms, bound {sums[1]:.4f} ms; all bit-identical to plain")
    return sums[0], sums[1], len(calls)


def e2e_phase(work, dev, fq, genome_len=GENOME_LEN):
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import chain as kchain
    from metamdbg_tpu_torch.kernels import count as kcount
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw
    from metamdbg_tpu_torch.pipeline import asm
    from metamdbg_tpu_torch.sketch import batch

    out = os.path.join(work, "port")
    params_dir = os.path.join(work, "params")
    os.makedirs(params_dir)
    digests = {}
    snapshot = asm.Pipeline._save_pass_snapshot

    def record_pass(self, k):
        """Each pass's parameters and artifact digests, as it ends."""
        shutil.copyfile(os.path.join(self.tmp_dir, "parameters.gz"),
                        os.path.join(params_dir, f"k{k}.gz"))
        digests[str(k)] = pass_digests(self.tmp_dir, k, self.first_k,
                                       k == self.last_k)
        snapshot(self, k)

    chain_calls = []
    chain_contig = kchain.chain_contig

    def record_chain(*args):
        """Keeps the inputs of each K3 call of the main path."""
        chain_calls.append(args)
        return chain_contig(*args)

    asm.Pipeline._save_pass_snapshot = record_pass
    kchain.chain_contig = record_chain
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    ksketch.reset_counts()
    kw.reset_counts()
    kchain.reset_counts()
    kcount.reset_counts()
    batch.tile_batches = 0
    try:
        with KWRecorder(kw) as kw_rec, LaunchRecorder(ksketch) as k1_rec:
            t0 = time.perf_counter()
            rc = main(["asm", "--out-dir", out, "--in-hifi", fq, "--device",
                       dev.type, "--threads", "1"])
            wall = time.perf_counter() - t0
    finally:
        asm.Pipeline._save_pass_snapshot = snapshot
        kchain.chain_contig = chain_contig
    launches = ksketch.launches
    relaunches = ksketch.overflow_launches
    tile_batches = batch.tile_batches
    kw_launches = kw.launches
    k3_launches = kchain.launches
    k2_calls = kcount.launches
    if rc != 0:
        fail(f"asm returned {rc}")

    walls, rss = _stage_walls(out)
    for name, dt in walls.items():
        print(f"e2e stage {name}: {dt:.2f} s")
    print(f"e2e peak RSS {rss} (chip_smoke.py's process, phases 1-4)")
    # read now: the later runs of this process log into the same file
    timing = _timing_lines(out)
    for line in timing:
        print(f"e2e log: {line}")
    print(f"e2e: asm wall {wall:.1f} s; sketch kernel launches {launches} "
          f"({relaunches} overflow relaunches) over {tile_batches} tile "
          f"batches")
    if (launches == 0) != (dev.type == "cpu") or \
            launches - relaunches != tile_batches * (dev.type == "cuda"):
        fail(f"sketch kernel launched {launches} times ({relaunches} "
             f"relaunches) for {tile_batches} tile batches")
    prov = json.load(open(os.path.join(out, "tmp", "device.json")))
    port = f"port:{dev.type}"
    stages = prov["stages"]
    bad = {n: r for n, r in stages.items() if r != port}
    final = ("readSelection", "derepSmallContigs", "removeOverlaps",
             "removeRepeats", "toBasespace")
    if bad or any(n not in stages for n in final):
        fail(f"stages not run as {port}: {bad}; stages {list(stages)}")
    passes = [n for n in stages if n.endswith("_createGraph")]
    if len(passes) != len(digests):
        fail(f"{len(passes)} createGraph stages, {len(digests)} passes")
    k2 = prov["row_count_k2"]["by_stage"]
    if sum(k2.values()) != k2_calls or \
            (dev.type == "cuda") != (k2_calls > 0):
        fail(f"K2: {k2_calls} calls, per stage {k2}")
    print(f"e2e: K2 (row counting) calls {k2_calls}: "
          f"{sum(k2.get(n, 0) for n in passes)} in the {len(passes)} "
          f"createGraph passes, per other stage "
          f"{ {n: c for n, c in k2.items() if n not in passes} }")
    by_kernel = {name: prov[name]["by_stage"] for name in
                 ("sketch_kernel", "window_hash_kernel", "chain_kernel")}
    for name, total in (("sketch_kernel", launches),
                        ("window_hash_kernel", kw_launches),
                        ("chain_kernel", k3_launches)):
        if sum(by_kernel[name].values()) != total:
            fail(f"{name}: {total} launches, per stage {by_kernel[name]}")
    kw_sites = prov["window_hash_kernel"]["by_site"]
    print(f"e2e: window hash kernel launches per call site {kw_sites}")
    if sum(kw_sites.values()) != kw_launches:
        fail(f"window hash kernel: {kw_launches} launches, per call site "
             f"{kw_sites}")
    if dev.type == "cuda":
        kw_passes = [by_kernel["window_hash_kernel"].get(n, 0)
                     for n in passes]
        if min(kw_passes) < 1:
            fail(f"window hash kernel: per stage "
                 f"{by_kernel['window_hash_kernel']}")
        # the multiplex passes' counts: one launch each
        count_launches = kw_sites.get("graph/multiplex.py:_hash_planes", 0)
        if not 0 < count_launches <= len(passes) - 2:
            fail(f"{count_launches} count launches in "
                 f"{len(passes) - 2} multiplex passes")
        print(f"e2e: the multiplex passes' counts made {count_launches} "
              f"window hash launches in {len(passes) - 2} passes")
        for name in ("sketch_kernel", "chain_kernel"):
            if by_kernel[name].get("toBasespace", 0) < 1:
                fail(f"{name} did not launch in toBasespace: "
                     f"{by_kernel[name]}")
        stage_of = [n for n, c in by_kernel["chain_kernel"].items()
                    for _ in range(c)]
        k3_main = [0.0, 0.0]
        for stage, args in zip(stage_of, chain_calls):
            sizes = np.diff(args[4].cpu().numpy())
            buf, _ = _k3_check(f"the main path's call in {stage}", args[:5],
                               args[5])
            ms = _time_ms(lambda: kchain._enqueue(*args, buf))
            host_ms = _host_ms(lambda: kchain.chain_contig(*args))
            b_ms, b_by = chain_contig_bound(sizes)
            k3_main[0] += ms
            k3_main[1] += b_ms
            print(f"e2e chain kernel in {stage}: {sizes.size} groups, "
                  f"{int(sizes.sum())} anchors, longest {int(sizes.max())}, "
                  f"d_r_max {args[5]}; again after the run: identical to "
                  f"plain, {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"chain_contig {host_ms:.4f} ms host clock per call")
        print(f"e2e: {len(passes)} passes; every stage {port}; window hash "
              f"kernel launches {kw_launches} ({min(kw_passes)}-"
              f"{max(kw_passes)} per pass); sketch kernel launches per "
              f"stage {by_kernel['sketch_kernel']}; chain kernel launches "
              f"{k3_launches}, per stage {by_kernel['chain_kernel']}")
        if len(kw_rec.calls) != kw_launches or \
                len(k1_rec.calls) != launches:
            fail(f"recorded {len(kw_rec.calls)} KW and {len(k1_rec.calls)} "
                 f"sketch launches, counted {kw_launches} and {launches}")
        main_path = {"window_hash": kw_replay(kw_rec.calls),
                     "window_hash_sites": kw_sites,
                     "sketch_tiles": k1_replay(k1_rec.calls),
                     "chain_contig": (*k3_main, len(chain_calls))}
    else:
        main_path = {}

    headers, lengths = _contigs(out)
    print(f"e2e: {len(lengths)} contig(s), lengths {lengths}, "
          f"headers {headers[:3]}")
    if len(lengths) != 1 or "circular=yes" not in headers[0] or \
            abs(lengths[0] - genome_len) > 2000:
        fail(f"expected one circular contig within 2 kb of {genome_len}")
    return out, (launches, kw_launches, k3_launches), (wall, timing), \
        params_dir, digests, main_path


THREADS_4T = 8
# tools/scale_run.py's BOUND_ENV scaled to phases 4t and 12's inputs (see
# the top)
BOUND_ENV = {"METAMDBG_TPU_COUNT_TABLE_GB": "0.002",
             "METAMDBG_TPU_CORRECTION_MEMORY_GB": "0.01",
             "METAMDBG_TPU_MAX_PARTITION_GB": "0.05"}
# phase 4t's process: the JAX package refused, os.fork raising, and each
# pass's graph artifact digests recorded as phase 4 records them
_THREADS_LAUNCHER = """
import json, os, sys
import chip_smoke
sys.meta_path.insert(0, chip_smoke._RefuseJaxPackage())
def _no_fork():
    raise RuntimeError("the port forked")
os.fork = _no_fork
from metamdbg_tpu_torch.pipeline import asm
digests_path = sys.argv.pop(1)
digests, snapshot = {}, asm.Pipeline._save_pass_snapshot
def record_pass(self, k):
    digests[str(k)] = chip_smoke.pass_digests(self.tmp_dir, k, self.first_k,
                                              k == self.last_k)
    snapshot(self, k)
asm.Pipeline._save_pass_snapshot = record_pass
from metamdbg_tpu_torch.__main__ import main
rc = main(sys.argv[1:])
with open(digests_path, "w") as f:
    json.dump(digests, f)
sys.exit(rc)
"""


def bounded_evidence(out):
    """Which bounded paths fired in the asm of `out`: count chunks,
    correction partitions, polish partitions (tools/scale_torch.py)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import scale_torch

    with open(os.path.join(out, "metaMDBG.log")) as f:
        ev = scale_torch.bounded_evidence(f.read())
    return {"count_chunks": (ev["count_chunks"] or [1])[0],
            "correction_partitions": ev["correction_partitions"],
            "polish_partitions": ev["polish_partitions"]}


def _bounded_run(work, tag, fq, flag, dev):
    """`asm FLAG fq --device cuda --threads 8` under BOUND_ENV in a
    subprocess (_THREADS_LAUNCHER); returns (out dir, each pass's graph
    digests, asm wall)."""
    out = os.path.join(work, tag)
    digests_path = os.path.join(work, f"{tag}_digests.json")
    log_path = os.path.join(work, f"{tag}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        rc = subprocess.run(
            [sys.executable, "-c", _THREADS_LAUNCHER, digests_path, "asm",
             "--out-dir", out, flag, fq, "--device", dev.type,
             "--threads", str(THREADS_4T)], cwd=REPO, stdout=logf,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=REPO, METAMDBG_TPU_KEEP_TMP="1",
                     **BOUND_ENV)).returncode
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{tag} exited {rc}:\n{open(log_path).read()[-4000:]}")
    prov = json.load(open(os.path.join(out, "tmp", "device.json")))
    if any(r != f"port:{dev.type}" for r in prov["stages"].values()):
        fail(f"{tag} stages {prov['stages']}")
    return out, json.load(open(digests_path)), wall


def threads_phase(work, dev, fq, e2e_out, e2e_digests, e2e_run):
    """Phase 4t: phase 4's reads through `python -m metamdbg_tpu_torch asm
    --device cuda --threads 8` under BOUND_ENV in a subprocess, started
    when every other phase has ended. Its files must be phase 4's and its
    count chunked; prints the bounded paths' evidence, its walls and
    timing lines beside phase 4's (`e2e_run`: its wall and timing lines)
    and its own peak RSS."""
    e2e_wall, e2e_timing = e2e_run
    print(f"threads: cpu_count {os.cpu_count()}, loadavg "
          f"{os.getloadavg()} at the start", flush=True)
    out, digests, wall = _bounded_run(work, "port_threads", fq, "--in-hifi",
                                      dev)
    evidence = bounded_evidence(out)
    print(f"threads: bounded paths {evidence} under {BOUND_ENV}")
    if evidence["count_chunks"] < 2:
        fail(f"phase 4t: the bounded count did not fire: {evidence}")
    if digests != e2e_digests:
        diff = [k for k in sorted(set(digests) | set(e2e_digests), key=int)
                if digests.get(k) != e2e_digests.get(k)]
        fail(f"phase 4t: graph artifacts differ from phase 4's at k {diff}")
    names = ("read_data_init.txt", "read_stats.txt",
             "read_data_corrected.txt", *BASESPACE_OUTPUTS)
    for name in names:
        a = open(os.path.join(e2e_out, "tmp", name), "rb").read()
        b = open(os.path.join(out, "tmp", name), "rb").read()
        if a != b:
            fail(f"phase 4t: {name} differs from phase 4's")
    if not _same_contigs(os.path.join(e2e_out, "contigs.fasta.gz"),
                         os.path.join(out, "contigs.fasta.gz")):
        fail("phase 4t: contigs.fasta.gz differs from phase 4's")
    walls, rss = _stage_walls(out)
    walls_4, rss_4 = _stage_walls(e2e_out)
    for name, dt in walls.items():
        print(f"threads stage {name}: {dt:.2f} s at --threads "
              f"{THREADS_4T}, {walls_4.get(name, 0.0):.2f} s at --threads 1 "
              f"(phase 4)")
    for line in e2e_timing:
        print(f"threads log, --threads 1 (phase 4): {line}")
    for line in _timing_lines(out):
        print(f"threads log, --threads {THREADS_4T}: {line}")
    print(f"threads: asm wall {wall:.1f} s at --threads {THREADS_4T} (its "
          f"process from start to exit), {e2e_wall:.1f} s at --threads 1 "
          f"(phase 4); peak RSS {rss} (its own process, rose at "
          f"{_rss_rises(out)}; phase 4's {rss_4} is chip_smoke.py's); "
          f"loadavg {os.getloadavg()} at the end; "
          f"{len(digests)} passes' graph artifacts, {len(names)} files and "
          f"contigs.fasta.gz identical to phase 4's")
    return {"threads": THREADS_4T, "asm_wall_s": wall, "peak_rss": rss,
            "bounded": evidence,
            "stage_walls_s": walls, "timing": _timing_lines(out),
            "phase4": {"asm_wall_s": e2e_wall, "stage_walls_s": walls_4,
                       "timing": e2e_timing},
            "cpu_count": os.cpu_count()}


def _records(path):
    """The minimizer lists of a read_data*.txt file, sorted."""
    from metamdbg_tpu_torch.io import records

    return sorted(r.minimizers.tolist()
                  for r in records.read_read_data(path, with_quality=False))


def bounded_ont_phase(work, dev, fq, ont_out, ref, job):
    """Phase 12: phase 8's ONT reads under BOUND_ENV at --threads 8 in a
    subprocess, after phase 4t. Every bounded path must cut more than one
    piece; the files made before the partitions must be phase 8's, the
    corrected reads phase 8's records and the JAX package's file under
    the same bounds (`ref`, `job`: its reference)."""
    out, _, wall = _bounded_run(work, "ont_bounded", fq, "--in-ont", dev)
    evidence = bounded_evidence(out)
    print(f"bounded ont: bounded paths {evidence} under {BOUND_ENV}")
    if any((n or 0) < 2 for n in evidence.values()):
        fail(f"phase 12: a bounded path did not fire: {evidence}")
    for name in CORRECTION_OUTPUTS[:-1]:
        a = open(os.path.join(ont_out, "tmp", name), "rb").read()
        b = open(os.path.join(out, "tmp", name), "rb").read()
        if a != b:
            fail(f"phase 12: {name} differs from phase 8's")
    corrected = os.path.join(out, "tmp", "read_data_corrected.txt")
    if _records(corrected) != _records(
            os.path.join(ont_out, "tmp", "read_data_corrected.txt")):
        fail("phase 12: read_data_corrected.txt holds other records than "
             "phase 8's")
    stdout, dt = _wait(job, "JAX package ONT correction under BOUND_ENV")
    want = json.loads(stdout.strip().splitlines()[-1])["checksum"]
    if open(os.path.join(ref, "read_data_corrected.txt"), "rb").read() != \
            open(corrected, "rb").read():
        fail("phase 12: read_data_corrected.txt differs from the JAX "
             "package's under the same bounds")
    sums = [[int(line.rsplit(" ", 1)[-1]) for line in
             open(os.path.join(d, "metaMDBG.log"))
             if "Correction checksum: " in line] for d in (ont_out, out)]
    if sums[1] != [want] or sums[0] != [want]:
        fail(f"phase 12: correction checksum {sums[1]}, the JAX package's "
             f"under the same bounds {want}, phase 8's {sums[0]}")
    headers, lengths = _contigs(out)
    if abs(sum(lengths) - ONT_TOTAL_LEN) > ONT_LEN_TOLERANCE * ONT_TOTAL_LEN:
        fail(f"phase 12: contigs total {sum(lengths)} bp, not within "
             f"{ONT_LEN_TOLERANCE:.0%} of {ONT_TOTAL_LEN}")
    same = _same_contigs(os.path.join(ont_out, "contigs.fasta.gz"),
                         os.path.join(out, "contigs.fasta.gz"))
    print(f"bounded ont: the files made before the partitions identical to "
          f"phase 8's; read_data_corrected.txt phase 8's records, and "
          f"identical to the JAX package's under the same bounds (its "
          f"reference {dt:.1f} s), checksum {want} equal; {len(lengths)} "
          f"contigs, {sum(lengths)} bp, contigs.fasta.gz "
          f"{'identical to' if same else 'not'} phase 8's")
    walls, rss = _stage_walls(out)
    for name, dt in walls.items():
        print(f"bounded ont stage {name}: {dt:.2f} s")
    for line in _timing_lines(out):
        print(f"bounded ont log: {line}")
    print(f"bounded ont: asm wall {wall:.1f} s at --threads {THREADS_4T}; "
          f"peak RSS {rss} (its own process)")
    return {"threads": THREADS_4T, "asm_wall_s": wall, "peak_rss": rss,
            "bounded": evidence, "stage_walls_s": walls,
            "contigs_as_phase8": same}


def ont_phase(work, dev, fq):
    """Phase 8: the ONT metagenome through `asm --in-ont --device cuda
    --threads 1` in this process; returns (out dir, K4 launches, K4's
    main-path times, the first correction chunk's (table pairs, query
    pairs) as u64 bits for phase 11b)."""
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.correction import mapper
    from metamdbg_tpu_torch.kernels import chain as kchain
    from metamdbg_tpu_torch.kernels import chain_dp as k4
    from metamdbg_tpu_torch.kernels import count as kcount
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw
    from metamdbg_tpu_torch.sketch import batch

    out = os.path.join(work, "ont_port")
    calls = []
    chain_dp = k4.chain_dp

    def record_chain_dp(*args):
        """Keeps the inputs of each K4 call of the main path."""
        calls.append(args)
        return chain_dp(*args)

    joins = []
    join = mapper._join

    def record_join(pairs, query, t_lo, t_hi, group):
        """Keeps the first chunk's table and query pairs (u64 bits)."""
        if not joins:
            joins.append((pairs["key"][t_lo:t_hi] ^ mapper._SIGN,
                          query["key"] ^ mapper._SIGN))
        return join(pairs, query, t_lo, t_hi, group)

    k4.chain_dp = record_chain_dp
    mapper._join = record_join
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    kernels = {"sketch_kernel": ksketch, "window_hash_kernel": kw,
               "chain_kernel": kchain, "chain_dp_kernel": k4,
               "row_count_k2": kcount}
    for k in kernels.values():
        k.reset_counts()
    batch.tile_batches = 0
    try:
        t0 = time.perf_counter()
        rc = main(["asm", "--out-dir", out, "--in-ont", fq, "--device",
                   dev.type, "--threads", "1"])
        wall = time.perf_counter() - t0
    finally:
        k4.chain_dp = chain_dp
        mapper._join = join
    launches = {name: k.launches for name, k in kernels.items()}
    if rc != 0:
        fail(f"ONT asm returned {rc}")

    walls, rss = _stage_walls(out)
    for name, dt in walls.items():
        print(f"ont stage {name}: {dt:.2f} s")
    print(f"ont peak RSS {rss} (chip_smoke.py's process, phases 1-8)")
    for line in open(os.path.join(out, "metaMDBG.log")):
        if "orrection checksum" in line or "correction partitions" in line \
                or "correction timing" in line:
            print(f"ont log: {line.split(' INFO ', 1)[-1].strip()}")
    prov = json.load(open(os.path.join(out, "tmp", "device.json")))
    port = f"port:{dev.type}"
    stages = prov["stages"]
    bad = {n: r for n, r in stages.items() if r != port}
    final = ("readSelection", "readCorrection", "derepSmallContigs",
             "removeOverlaps", "removeRepeats", "toBasespace")
    if bad or any(n not in stages for n in final):
        fail(f"ONT stages not run as {port}: {bad}; stages {list(stages)}")
    for name, total in launches.items():
        by_stage = prov[name]["by_stage"]
        if sum(by_stage.values()) != total or prov[name]["launches"] != total:
            fail(f"ONT {name}: {total} launches, per stage {by_stage}")
        if dev.type == "cuda" and total < 1:
            fail(f"ONT: {name} launched no time")
    correction = {name: prov[name]["by_stage"].get("readCorrection", 0)
                  for name in kernels}
    if dev.type == "cuda" and (correction["chain_dp_kernel"] < 1
                               or correction["sketch_kernel"] < 1):
        fail(f"ONT readCorrection launched {correction}")
    print(f"ont: asm wall {wall:.1f} s; every stage {port}; launches "
          f"{launches}; in readCorrection {correction}")
    k4_main = [0.0, 0.0, len(calls)]
    if dev.type == "cuda":
        for k, args in enumerate(calls):
            kin = _k4_inputs(args[:5])
            sizes = np.diff(args[4].cpu().numpy())
            buf, _ = _k4_check("the main path's call", kin, args[5])
            ms = _time_ms(lambda: k4._enqueue(*kin, args[5], buf))
            host_ms = _host_ms(lambda: k4.chain_dp(*args))
            b = chain_dp_bound(sizes, args[5])
            k4_main[0] += ms
            k4_main[1] += b[0]
            print(f"ont chain_dp kernel in readCorrection: {sizes.size} "
                  f"groups, {int(sizes.sum())} anchors, longest "
                  f"{int(sizes.max())}, band {args[5]}; again after the "
                  f"run: identical to plain, {ms:.4f} ms, bound {b[0]:.4f} "
                  f"ms ({b[1]}); chain_dp {host_ms:.4f} ms host clock per "
                  f"call")
            if k == 0:
                # for tools/kernel_ab.py and tools/kernel_variants.py
                os.makedirs(os.path.dirname(CHAIN_DP_SAVED), exist_ok=True)
                torch.save({"inputs": [t.cpu() for t in kin],
                            "band": args[5]}, CHAIN_DP_SAVED)

    headers, lengths = _contigs(out)
    total = sum(lengths)
    print(f"ont: {len(lengths)} contig(s), total {total} bp, lengths "
          f"{sorted(lengths, reverse=True)[:12]}, "
          f"{sum('circular=yes' in h for h in headers)} circular")
    if abs(total - ONT_TOTAL_LEN) > ONT_LEN_TOLERANCE * ONT_TOTAL_LEN:
        fail(f"ONT contigs total {total} bp, not within "
             f"{ONT_LEN_TOLERANCE:.0%} of {ONT_TOTAL_LEN}")
    return out, launches["chain_dp_kernel"], k4_main, joins[0]


def correction_reference_start(work, fq, tag="correction", env=None):
    ref = os.path.join(work, f"jax_{tag}")
    os.makedirs(ref)
    return ref, _jax_reference(work, "correction", fq, ref, tag=tag,
                               env=env)


def correction_reference_phase(ref, job, out):
    stdout, dt = _wait(job, "JAX package ONT read selection and correction")
    want = json.loads(stdout.strip().splitlines()[-1])["checksum"]
    print(f"correction reference: JAX package ONT read selection and read "
          f"correction (host-only, jax blocked, one thread) in {dt:.1f} s")
    for name in CORRECTION_OUTPUTS:
        a = open(os.path.join(ref, name), "rb").read()
        b = open(os.path.join(out, "tmp", name), "rb").read()
        if a != b:
            fail(f"ONT {name} differs from the JAX package's")
        print(f"correction reference: {name} byte-identical ({len(a)} "
              f"bytes)")
    got = [int(line.rsplit(" ", 1)[-1]) for line in
           open(os.path.join(out, "metaMDBG.log"))
           if "Correction checksum: " in line]
    if got != [want]:
        fail(f"correction checksum {got}, the JAX package's {want}")
    print(f"correction reference: checksum {want} equal")


def _jax_reference(work, phase, *args, tag=None, env=None):
    """Starts tests/jax_reference.py PHASE ARGS, with `env` added to the
    environment; its output goes to files in `work` named after `tag`
    (default PHASE). Returns (process, stdout path, stderr path, start
    time)."""
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    paths = [os.path.join(work, f"jax_{tag or phase}.{s}")
             for s in ("out", "err")]
    with open(paths[0], "w") as out, open(paths[1], "w") as err:
        proc = subprocess.Popen([sys.executable, JAX_REFERENCE, phase,
                                 *args], cwd=REPO, env=env, stdout=out,
                                stderr=err)
    return proc, paths[0], paths[1], time.perf_counter()


def _wait(job, what):
    """Waits for a reference job; returns (its stdout, seconds)."""
    proc, out, err, t0 = job
    rc = proc.wait()
    dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"{what} exited {rc} after {dt:.1f} s:\n"
             f"{open(err).read()[-4000:]}")
    return open(out).read(), dt


def read_selection_reference_start(work, fq):
    ref = os.path.join(work, "jax_read_selection")
    os.makedirs(ref)
    return ref, _jax_reference(work, "read_selection", fq, ref)


def reference_phase(ref, job, out):
    _, dt = _wait(job, "JAX package read selection")
    print(f"reference: JAX package read selection (host-only, jax blocked) "
          f"in {dt:.1f} s")
    for name in ("read_data_init.txt", "read_stats.txt",
                 "read_data_corrected.txt"):
        a = open(os.path.join(ref, name), "rb").read()
        b = open(os.path.join(out, "tmp", name), "rb").read()
        if a != b:
            fail(f"{name} differs from the JAX package's")
        print(f"reference: {name} byte-identical ({len(a)} bytes)")


def graph_reference_start(work, out, params_dir, digests):
    ref = os.path.join(work, "jax_graph")
    for sub in ("filter", "smallContigs"):
        os.makedirs(os.path.join(ref, sub))
    shutil.copyfile(os.path.join(out, "tmp", "read_data_corrected.txt"),
                    os.path.join(ref, "read_data_corrected.txt"))
    ks = sorted(int(k) for k in digests)
    return _jax_reference(work, "graph", ref, params_dir, str(ks[0]),
                          str(ks[-1]))


def graph_reference_phase(job, digests):
    stdout, dt = _wait(job, "JAX package graph stages")
    want = json.loads(stdout.strip().splitlines()[-1])
    ks = sorted(int(k) for k in digests)
    print(f"graph reference: JAX package k={ks[0]}..{ks[-1]} (host-only, "
          f"jax blocked) in {dt:.1f} s")
    if sorted(want) != sorted(digests):
        fail(f"graph reference ran passes {sorted(want)}")
    n = 0
    for k in map(str, ks):
        if want[k] != digests[k]:
            diff = sorted(set(want[k].items()) ^ set(digests[k].items()))
            fail(f"pass k={k}: artifacts differ from the JAX package's: "
                 f"{[name for name, _ in diff]}")
        n += len(want[k])
    print(f"graph reference: {n} artifacts over {len(ks)} passes "
          f"byte-identical (sha256), first pass, second pass and final "
          f"pass included")


def basespace_reference_start(work, fq, out):
    """A copy of the port's tmp as the last pass left it: the outputs of
    post-processing and toBasespace are left out."""
    ref = os.path.join(work, "jax_basespace")
    shutil.copytree(os.path.join(out, "tmp"), ref,
                    ignore=shutil.ignore_patterns(
                        "pass_k*", "filter", "_polish_readPartitions",
                        *BASESPACE_OUTPUTS))
    return ref, _jax_reference(work, "basespace", ref, fq,
                               os.path.join(ref, "contigs.fasta.gz"))


def basespace_reference_phase(ref, job, out):
    _, dt = _wait(job, "JAX package post-processing and toBasespace")
    print(f"basespace reference: JAX package derepSmall, removeOverlaps, "
          f"removeRepeats and toBasespace (host-only, jax blocked, one "
          f"thread) in {dt:.1f} s")
    for name in BASESPACE_OUTPUTS:
        a = open(os.path.join(ref, name), "rb").read()
        b = open(os.path.join(out, "tmp", name), "rb").read()
        if a != b:
            fail(f"{name} differs from the JAX package's")
        print(f"basespace reference: {name} byte-identical ({len(a)} "
              f"bytes)")
    if not _same_contigs(os.path.join(ref, "contigs.fasta.gz"),
                         os.path.join(out, "contigs.fasta.gz")):
        fail("contigs.fasta.gz differs from the JAX package's")
    print(f"basespace reference: contigs.fasta.gz identical (decompressed, "
          f"and {os.path.getsize(os.path.join(out, 'contigs.fasta.gz'))} "
          f"gzip bytes outside the write time)")


def _write_fasta(path, records, width=80):
    with open(path, "w") as f:
        for name, seq in records:
            text = seq.tobytes().decode()
            f.write(f">{name}\n" + "".join(
                text[i:i + width] + "\n"
                for i in range(0, len(text), width)))
    return path


def write_references(work, kind, genome_len=GENOME_LEN):
    """The `map` references, made with tests/datagen.py from the inputs'
    seeds: `hifi`, phase 4's genome as one multi-line FASTA; `ont`, phase
    8's three genomes as two FASTA files, the first holding two records."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import datagen

    if kind == "hifi":
        return [_write_fasta(os.path.join(work, "genome.fasta"), [
            ("genome", datagen.random_genome(int(genome_len), seed=1))])]
    g = datagen.make_metagenome(n_genomes=3, sizes=list(ONT_SIZES), seed=40)
    return [_write_fasta(os.path.join(work, "ont_genomes_a.fasta"),
                         [("g0", g[0]), ("g1", g[1])]),
            _write_fasta(os.path.join(work, "ont_genomes_b.fasta"),
                         [("g2", g[2])])]


def saved_ks(out):
    from metamdbg_tpu_torch.pipeline.gfa import available_ks

    ks = available_ks(os.path.join(out, "tmp"))
    if not ks:
        fail(f"no assembly graph saved in {out}")
    return ks


def gfa_map_phase(tag, dev, out, k, refs):
    """Phases 4b and 8b: `gfa OUT 0`, `gfa OUT K --coverage --readpath` and
    `map OUT K --references REFS` through the port's entry point in this
    process. Returns (the listing, walls, launches per run, max abs
    difference of the replayed launches from plain)."""
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import chain as kchain
    from metamdbg_tpu_torch.kernels import chain_dp as k4
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw

    kernels = {"sketch_kernel": ksketch, "window_hash_kernel": kw,
               "chain_kernel": kchain, "chain_dp_kernel": k4}
    runs = (("gfa0", ["gfa", out, "0"]),
            ("gfa", ["gfa", out, str(k), "--coverage", "--readpath"]),
            ("map", ["map", out, str(k), "--references", *refs]))
    listing = io.StringIO()
    walls, launches = {}, {}
    with KWRecorder(kw) as kw_rec, LaunchRecorder(ksketch) as k1_rec:
        for name, args in runs:
            for m in kernels.values():
                m.reset_counts()
            t0 = time.perf_counter()
            with (contextlib.redirect_stdout(listing) if name == "gfa0"
                  else contextlib.nullcontext()):
                rc = main([*args, "--device", dev.type])
            walls[name] = time.perf_counter() - t0
            launches[name] = {n: m.launches for n, m in kernels.items()}
            if rc != 0:
                fail(f"{tag} {name} returned {rc}")
    for name in ("gfa", "map"):
        n = launches[name]
        if n["chain_kernel"] or n["chain_dp_kernel"]:
            fail(f"{tag} {name} launched a chain kernel: {n}")
        if dev.type == "cuda" and (n["sketch_kernel"] < 1 or
                                   n["window_hash_kernel"] < 1):
            fail(f"{tag} {name} did not launch both the sketch and the "
                 f"window hash kernels: {n}")
    prefix = os.path.join(out, f"assemblyGraph_k{k}")
    lines = open(prefix + ".gfa").read().splitlines()
    with open(os.path.join(out, "tmp", f"pass_k{k}",
                           "assembly_graph.gfa")) as f:
        n_unitigs = sum(line.startswith("S\t") for line in f)
    with open(prefix + ".contigColor.csv") as f:
        coloured = len(f.readlines()) - 1
    print(f"{tag} gfa/map: k={k}; walls gfa 0 {walls['gfa0']:.2f} s, gfa "
          f"--coverage --readpath {walls['gfa']:.2f} s, map "
          f"{walls['map']:.2f} s; {n_unitigs} unitigs, "
          f"{sum(x.startswith('S') for x in lines)} S lines, "
          f"{sum(x.startswith('L') for x in lines)} L lines; {coloured} "
          f"unitigs coloured by {len(refs)} reference file(s); launches "
          f"{launches}")
    total = sum(launches[n]["sketch_kernel"] for n in launches), \
        sum(launches[n]["window_hash_kernel"] for n in launches)
    if (len(k1_rec.calls), len(kw_rec.calls)) != total:
        fail(f"{tag}: recorded {len(k1_rec.calls)} sketch and "
             f"{len(kw_rec.calls)} KW launches, counted {total}")
    err = 0
    if dev.type == "cuda":
        for i, ((codes, l, density, cap), _) in enumerate(k1_rec.calls):
            _k1_check(f"{tag} gfa/map sketch launch {i}", codes, l, density,
                      cap)
        for i, (call, _) in enumerate(kw_rec.calls):
            err = max(err, kw_call_check(f"{tag} gfa/map launch {i}", call))
        print(f"{tag} gfa/map: {total[0]} sketch and {total[1]} window hash "
              f"launches again after the runs: bit-identical to plain")
    return listing.getvalue(), walls, launches, err


def gfa_reference_start(work, tag, out, k, refs):
    """A copy of what `gfa` and `map` read from `out`; the JAX package's
    gfa and map on it."""
    ref = os.path.join(work, f"jax_gfa_{tag}")
    os.makedirs(os.path.join(ref, "tmp"))
    for name in GFA_INPUTS:
        src = os.path.join(out, "tmp", name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(ref, "tmp", name))
    for d in glob.glob(os.path.join(out, "tmp", "pass_k*")):
        shutil.copytree(d, os.path.join(ref, "tmp", os.path.basename(d)))
    return ref, _jax_reference(work, "gfa", ref, str(k), *refs,
                               tag=f"gfa_{tag}")


def gfa_reference_phase(tag, ref, job, out, k, port):
    """Phase 10: the JAX package's listing and files against the port's
    (phases 4b and 8b)."""
    listing, walls = port[:2]
    stdout, _ = _wait(job, f"JAX package gfa and map ({tag})")
    lines = stdout.splitlines(keepends=True)
    want = json.loads(lines[-1])
    if "".join(lines[:-1]) != listing:
        fail(f"{tag} gfa 0: the listing differs from the JAX package's")
    for suffix in GFA_OUTPUTS:
        name = f"assemblyGraph_k{k}{suffix}"
        a = open(os.path.join(ref, name), "rb").read()
        b = open(os.path.join(out, name), "rb").read()
        if a != b:
            fail(f"{tag} {name} differs from the JAX package's")
        print(f"gfa reference {tag}: {name} byte-identical ({len(a)} bytes)")
    print(f"gfa reference {tag}: JAX package (host-only, jax blocked, one "
          f"thread): listing identical; walls JAX / port: "
          + ", ".join(f"{n} {want[n]:.2f} / {walls[n]:.2f} s"
                      for n in ("gfa0", "gfa", "map")))


# phase 11: each rank is a subprocess with the JAX package and jax refused
# and os.fork raising (tests/test_torch_e2e.py:_BLOCKED_LAUNCHER's manner)
_RANK_LAUNCHER = """
import importlib.abc, os, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "metamdbg_tpu"):
            raise ImportError(name + " is refused in a rank")
        return None
sys.meta_path.insert(0, _Block())
def _no_fork():
    raise RuntimeError("the port forked")
os.fork = _no_fork
from metamdbg_tpu_torch.__main__ import main
sys.exit(main(sys.argv[1:]))
"""
SHARDED_WORLD = 2
SHARDED_THREADS = 4   # host threads a rank (--threads)
SHARDED_STAGES = {"readCorrection": "pair_join",
                  "k4_createGraph": "count_table", "toBasespace": "polish"}
# phase 11b's synthetic inputs: the k = 4 table of the 10.14 Gbp HiFi run
# (SCALE_r05.json hifi_10gbp: 10.14 Gbp x density 0.005 ~ 50.7M
# minimizers) in reads of ~60 minimizers (12 kb HiFi reads at density
# 0.005), sampled at 20x from minimizer "genomes", 1% of minimizers
# replaced by errors; and a table of 2^25 u64 pairs with as many queries
K5_SYNTH_MINIMIZERS, K5_SYNTH_MEAN, K5_SYNTH_COVERAGE = 50_700_000, 60, 20
K6_SYNTH_PAIRS = 1 << 25


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_start(work, fq, dev):
    """Phase 11: starts `asm --in-ont --device cuda --threads 4` on the ONT
    reads as SHARDED_WORLD ranks of one group over gloo, all on this card,
    each with its own out dir and one torch thread (as torchrun gives each
    of several ranks on a host). Returns the ranks' (process, out dir,
    log path, start time)."""
    port = _free_port()
    ranks = []
    for rank in range(SHARDED_WORLD):
        out = os.path.join(work, f"ont_rank{rank}")
        log_path = os.path.join(work, f"ont_rank{rank}.log")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   METAMDBG_TPU_KEEP_TMP="1", METAMDBG_TPU_DISTRIBUTED="1",
                   METAMDBG_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   METAMDBG_TPU_NUM_PROCESSES=str(SHARDED_WORLD),
                   METAMDBG_TPU_PROCESS_ID=str(rank),
                   METAMDBG_TPU_DIST_BACKEND="gloo")
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-c", _RANK_LAUNCHER, "asm", "--out-dir",
                 out, "--in-ont", fq, "--device", dev.type, "--threads",
                 str(SHARDED_THREADS)],
                cwd=REPO, env=env, stdout=logf, stderr=subprocess.STDOUT)
        ranks.append((proc, out, log_path, time.perf_counter()))
    return ranks


def sharded_phase(ranks, ont_out, dev):
    """Phase 11's checks: every rank exited 0, ran every stage as
    port:cuda in a group of SHARDED_WORLD over gloo, launched every
    kernel, ran the three sharded stages, and wrote phase 8's files."""
    port = f"port:{dev.type}"
    result = {}
    for rank, (proc, out, log_path, t0) in enumerate(ranks):
        rc = proc.wait()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"phase 11 rank {rank} exited {rc}:\n"
                 f"{open(log_path).read()[-4000:]}")
        prov = json.load(open(os.path.join(out, "tmp", "device.json")))
        dist_info = prov["distributed"]
        if (dist_info["rank"], dist_info["world_size"],
                dist_info["transport"]) != (rank, SHARDED_WORLD, "gloo"):
            fail(f"phase 11 rank {rank}: group {dist_info}")
        bad = {n: r for n, r in prov["stages"].items() if r != port}
        if bad or "readCorrection" not in prov["stages"]:
            fail(f"phase 11 rank {rank}: stages {prov['stages']}")
        launches = {name: prov[name]["launches"] for name in (
            "sketch_kernel", "window_hash_kernel", "chain_kernel",
            "chain_dp_kernel")}
        if dev.type == "cuda" and min(launches.values()) < 1:
            fail(f"phase 11 rank {rank}: a kernel launched no time: "
                 f"{launches}")
        sharded = dist_info["sharded"]
        for stage_name, fn in SHARDED_STAGES.items():
            if sharded.get(stage_name, {}).get(fn, {}).get("calls", 0) < 1:
                fail(f"phase 11 rank {rank}: {stage_name} did not run "
                     f"{fn} sharded: {sharded}")
        for name in (*CORRECTION_OUTPUTS, *BASESPACE_OUTPUTS,
                     "kminmerData_abundance_init.txt"):
            a = open(os.path.join(ont_out, "tmp", name), "rb").read()
            b = open(os.path.join(out, "tmp", name), "rb").read()
            if a != b:
                fail(f"phase 11 rank {rank}: {name} differs from phase 8's")
        if not _same_contigs(os.path.join(ont_out, "contigs.fasta.gz"),
                             os.path.join(out, "contigs.fasta.gz")):
            fail(f"phase 11 rank {rank}: contigs.fasta.gz differs from "
                 f"phase 8's")
        walls, rss = _stage_walls(out)
        for name, dt in walls.items():
            print(f"sharded rank {rank} stage {name}: {dt:.2f} s")
        for line in _timing_lines(out):
            print(f"sharded rank {rank} log: {line}")
        k5 = sharded["k4_createGraph"]["count_table"]
        k6 = sharded["readCorrection"]["pair_join"]
        poa = sharded["toBasespace"]["polish"]
        print(f"sharded rank {rank}: asm wall {wall:.1f} s, peak RSS {rss}; "
              f"K5 windows {k5['windows']}, received {k5['received']}, "
              f"shard keys {k5['shard_keys']} of {k5['keys']}; K6 in "
              f"{k6['calls']} chunk(s): table {k6['table']} and queries "
              f"{k6['queries']} sent, shard table {k6['shard_table']}, "
              f"shard queries {k6['shard_queries']}, matches "
              f"{k6['matches']}; POA windows {poa['windows']} of "
              f"{poa['batch']} in {poa['calls']} batches; launches "
              f"{launches}; every compared file identical to phase 8's")
        result[f"rank{rank}"] = {
            "asm_wall_s": wall, "peak_rss": rss, "stage_walls_s": walls,
            "k5": k5, "k6": k6, "poa": poa, "launches": launches}
    return result


class StepTimer:
    """multihost.steps' timer: CUDA events around each step of a sharded
    function on the current stream; `ms()` sums them per step name."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.events.append((name, a, b))

    def ms(self):
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def _synthetic_reads(seed):
    """Phase 11b's K5 input (see K5_SYNTH_*): host u32 minimizer reads."""
    rng = np.random.default_rng(seed)
    n_genome = K5_SYNTH_MINIMIZERS // K5_SYNTH_COVERAGE
    genome = rng.integers(1, 1 << 32, n_genome, dtype=np.uint32)
    n_reads = K5_SYNTH_MINIMIZERS // K5_SYNTH_MEAN
    lens = np.clip(rng.gamma(4.0, K5_SYNTH_MEAN / 4.0, n_reads), 4,
                   4 * K5_SYNTH_MEAN).astype(np.int64)
    starts = rng.integers(0, n_genome - lens.max(), n_reads)
    offs = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    cat = genome[offs + np.arange(int(lens.sum()))]
    errors = rng.random(cat.shape[0]) < 0.01
    cat[errors] = rng.integers(1, 1 << 32, int(errors.sum()),
                               dtype=np.uint32)
    return np.split(cat, np.cumsum(lens)[:-1])


def _single_device_table(reads, k, dev):
    """The one-device route: every window extracted and counted (K2), keys
    hashed from the unique rows (KW), in unsigned key order."""
    from metamdbg_tpu_torch.count import kminmers
    from metamdbg_tpu_torch.kernels import window_hash as kw

    rows, _, _, _ = kminmers.batch_extract_kminmers(reads, k, dev)
    uniq, counts = kminmers.count_unique_rows(rows)
    h1, h2 = kw.hash_rows(uniq)
    order = kminmers.sort_pairs(h1, h2)
    return h1[order], h2[order], counts[order]


def _k5_bounds(n_min, n_win, n_keys):
    """Least bytes of each count_table step at one rank (inputs read
    once, outputs written once), as ms at the memory rate."""
    b = {"hash": 8 * n_min + 8 * n_win + 16 * n_win,
         "route": 16 * n_win + 16 * n_win, "split exchange": 16,
         "row exchange": 32 * n_win, "local sort-count": 16 * n_win
         + 24 * n_keys, "gather": 48 * n_keys, "merge": 48 * n_keys}
    return {name: v / HBM_BYTES_PER_S * 1e3 for name, v in b.items()}


def _k6_bounds(nt, nq, n_match):
    b = {"route": 8 * (nt + nq) + 24 * (nt + nq), "split exchange": 16,
         "row exchange": 48 * (nt + nq),
         "local join": 24 * (nt + nq) + 8 * nt + 24 * nq,
         "gather": 2 * (8 * nt + 24 * nq),
         "expand": 8 * nt + 24 * nq + 8 * nq + 8 * n_match}
    return {name: v / HBM_BYTES_PER_S * 1e3 for name, v in b.items()}


def _timed_call(fn):
    """(result, per-step device ms, host ms) of fn(timer), after an
    untimed call that brings the communicator and caches up."""
    fn(None)
    torch.cuda.synchronize()
    timer = StepTimer()
    t0 = time.perf_counter()
    res = fn(timer)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return res, timer.ms(), host


def nccl_phase(dev, ont_out, join_inputs):
    """Phase 11b: count_table (K5) and pair_join (K6) on a one-rank NCCL
    group in this process, on the card, each at two sizes, held against
    the single-device route (tolerance 0) and timed step by step."""
    from metamdbg_tpu_torch import parallel
    from metamdbg_tpu_torch.correction import mapper
    from metamdbg_tpu_torch.graph import stage
    from metamdbg_tpu_torch.parallel import count_table, pair_join

    names = ("METAMDBG_TPU_DISTRIBUTED", "METAMDBG_TPU_COORDINATOR",
             "METAMDBG_TPU_NUM_PROCESSES", "METAMDBG_TPU_PROCESS_ID",
             "METAMDBG_TPU_DIST_BACKEND")
    saved = {n: os.environ.pop(n, None) for n in names}
    os.environ.update(METAMDBG_TPU_DISTRIBUTED="1",
                      METAMDBG_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
                      METAMDBG_TPU_NUM_PROCESSES="1",
                      METAMDBG_TPU_PROCESS_ID="0")
    try:
        rank_dev = parallel.ensure_distributed(dev)
    finally:
        for n, v in saved.items():
            os.environ.pop(n, None)
            if v is not None:
                os.environ[n] = v
    result = {}
    try:
        import torch.distributed as dist
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"phase 11b: group {parallel.describe()}")
        group = dist.group.WORLD
        k5_inputs = {
            "ont_first_pass_k4": stage.load_minimizer_reads(
                os.path.join(ont_out, "tmp", "read_data_corrected.txt")),
            "synthetic_50M": _synthetic_reads(11)}
        for name in list(k5_inputs):
            reads = k5_inputs.pop(name)  # freed before the next input
            (h1, h2, counts), steps, host = _timed_call(
                lambda timer: count_table.count_table(reads, FIRST_K,
                                                      rank_dev, group, timer))
            w1, w2, wc = _single_device_table(reads, FIRST_K, rank_dev)
            if not (torch.equal(h1, w1) and torch.equal(h2, w2)
                    and torch.equal(counts, wc)):
                fail(f"phase 11b: K5 on {name} differs from the single-"
                     f"device table")
            n_min = sum(r.shape[0] for r in reads)
            n_win = int(counts.sum())
            bounds = _k5_bounds(n_min, n_win, h1.shape[0])
            result[f"k5_{name}"] = {
                "reads": len(reads), "minimizers": n_min, "windows": n_win,
                "keys": h1.shape[0], "max_abs_err": 0, "steps_ms": steps,
                "bound_ms": bounds, "host_ms": host}
            print(f"nccl K5 {name}: {len(reads)} reads, {n_min} minimizers, "
                  f"{n_win} windows, {h1.shape[0]} keys, identical to the "
                  f"single-device table; steps (ms) "
                  + ", ".join(f"{k} {v:.3f} (bound {bounds[k]:.3f})"
                              for k, v in steps.items())
                  + f"; host {host:.1f} ms")
        synth = torch.arange(K6_SYNTH_PAIRS, device=rank_dev)
        gen = torch.Generator(device=rank_dev).manual_seed(12)
        k6_inputs = {
            "ont_first_chunk": join_inputs,
            "synthetic_2^25": tuple(
                torch.randint(0, K6_SYNTH_PAIRS, synth.shape, device=rank_dev,
                              generator=gen) * -7046029254386353131
                for _ in range(2))}
        for name, (tbl, queries) in k6_inputs.items():
            tbl, queries = tbl.to(rank_dev), queries.to(rank_dev)
            (counts, matches), steps, host = _timed_call(
                lambda timer: pair_join.pair_join(tbl, queries, group, timer))
            want_counts, want = mapper._join(
                {"key": tbl ^ mapper._SIGN}, {"key": queries ^ mapper._SIGN},
                0, tbl.shape[0], None)
            if not (torch.equal(counts, want_counts)
                    and torch.equal(matches, want)):
                fail(f"phase 11b: K6 on {name} differs from the sorted join")
            bounds = _k6_bounds(tbl.shape[0], queries.shape[0],
                                matches.shape[0])
            result[f"k6_{name}"] = {
                "table": tbl.shape[0], "queries": queries.shape[0],
                "matches": matches.shape[0], "max_abs_err": 0,
                "steps_ms": steps, "bound_ms": bounds, "host_ms": host}
            print(f"nccl K6 {name}: table {tbl.shape[0]}, queries "
                  f"{queries.shape[0]}, matches {matches.shape[0]}, identical "
                  f"to the sorted join; steps (ms) "
                  + ", ".join(f"{k} {v:.3f} (bound {bounds[k]:.3f})"
                              for k, v in steps.items())
                  + f"; host {host:.1f} ms")
    finally:
        parallel.shutdown()
    return result


def _kernel_line(name, source, replaces, launches, result, main_path,
                 **extra):
    """One kernel's entry of the kernels line. `result`: max_abs_err,
    kernel ms, plain ms and bound on phase 3's inputs; `main_path`: the sum
    of the kernel's ms and of its bounds over the main path's launches
    timed again after the run, and how many were timed; `extra`: more
    keys."""
    err, ms, plain_ms, (bound_ms, bound_by) = result
    main_ms, main_bound_ms, main_timed = main_path[:3]
    # no single PyTorch call computes any of these functions
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "main_path_ms": main_ms, "main_path_bound_ms": main_bound_ms,
            "main_path_launches_timed": main_timed, **extra}


def main():
    smi = device_phase()
    sys.meta_path.insert(0, _RefuseJaxPackage())
    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    jobs = []
    try:
        hifi_job = reads_start(work, "hifi")
        ont_job = reads_start(work, "ont")
        jobs += [hifi_job[1:], ont_job[1:]]
        build_phase()
        kern = kernel_phase(dev)
        kw_result = kw_phase(dev)
        kw_segments = kw_segments_phase(dev)
        count_phase(dev)
        chain_result = chain_phase(dev)
        chain_dp_result = chain_dp_phase(dev)
        fq = reads_wait(hifi_job, "e2e")
        out, launches, e2e_run, params_dir, digests, main_path = \
            e2e_phase(work, dev, fq)
        rs_ref, rs_job = read_selection_reference_start(work, fq)
        graph_job = graph_reference_start(work, out, params_dir, digests)
        bs_ref, bs_job = basespace_reference_start(work, fq, out)
        hifi_k, hifi_refs = saved_ks(out)[-1], write_references(work, "hifi")
        hifi_gfa_ref, hifi_gfa_job = gfa_reference_start(
            work, "hifi", out, hifi_k, hifi_refs)
        jobs += [rs_job, graph_job, bs_job, hifi_gfa_job]
        ont_fq = reads_wait(ont_job, "ont")
        corr_ref, corr_job = correction_reference_start(work, ont_fq)
        bcorr_ref, bcorr_job = correction_reference_start(
            work, ont_fq, "correction_bounded", BOUND_ENV)
        jobs += [corr_job, bcorr_job]
        hifi_gfa = gfa_map_phase("hifi", dev, out, hifi_k, hifi_refs)
        ont_out, k4_launches, k4_main, join_inputs = ont_phase(work, dev,
                                                               ont_fq)
        ranks = sharded_start(work, ont_fq, dev)
        jobs += [r[:1] for r in ranks]
        ont_k, ont_refs = saved_ks(ont_out)[0], write_references(work, "ont")
        ont_gfa_ref, ont_gfa_job = gfa_reference_start(
            work, "ont", ont_out, ont_k, ont_refs)
        jobs.append(ont_gfa_job)
        ont_gfa = gfa_map_phase("ont", dev, ont_out, ont_k, ont_refs)
        nccl = nccl_phase(dev, ont_out, join_inputs)
        del join_inputs
        reference_phase(rs_ref, rs_job, out)
        graph_reference_phase(graph_job, digests)
        basespace_reference_phase(bs_ref, bs_job, out)
        correction_reference_phase(corr_ref, corr_job, ont_out)
        gfa_reference_phase("hifi", hifi_gfa_ref, hifi_gfa_job, out, hifi_k,
                            hifi_gfa)
        gfa_reference_phase("ont", ont_gfa_ref, ont_gfa_job, ont_out, ont_k,
                            ont_gfa)
        two_ranks = sharded_phase(ranks, ont_out, dev)
        threads = threads_phase(work, dev, fq, out, digests, e2e_run)
        bounded_ont = bounded_ont_phase(work, dev, ont_fq, ont_out,
                                        bcorr_ref, bcorr_job)
    finally:
        for proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    k1 = kern[DENSITIES[0]]
    k1_err = max(r["err"] for r in kern.values())
    kw_main, k1_main = main_path["window_hash"], main_path["sketch_tiles"]

    def gfa_map_launches(kernel):
        """The kernel's launches in phases 4b and 8b, and the largest
        difference from plain on their replay."""
        runs = {tag: {name: r[2][name][kernel] for name in ("gfa", "map")}
                for tag, r in (("hifi", hifi_gfa), ("ont", ont_gfa))}
        return {**runs, "max_abs_err": max(hifi_gfa[3], ont_gfa[3])}

    print(json.dumps({"threads": threads, "bounded_ont": bounded_ont}))
    print(json.dumps({"sharded": {"two_ranks_gloo_one_card": two_ranks,
                                  "one_rank_nccl": nccl}}))
    print(json.dumps({"kernels": [
        _kernel_line("sketch_tiles", "metamdbg_tpu_torch/csrc/sketch.cu",
                     "metamdbg_tpu/kernels/sketch_pallas.py:49",
                     launches[0], (k1_err, k1["ms"], k1["plain_ms"],
                                   k1["bound"]), k1_main,
                     gfa_map_launches=gfa_map_launches("sketch_kernel")),
        _kernel_line("window_hash", "metamdbg_tpu_torch/csrc/window_hash.cu",
                     "metamdbg_tpu/parallel/count_table.py:29 + "
                     "native/sketch.cpp:523", launches[1],
                     (max(kw_result["err"], kw_segments["err"]),
                      kw_segments["ms"], kw_segments["plain_ms"],
                      kw_segments["bound"]), kw_main,
                     gfa_map_launches=gfa_map_launches("window_hash_kernel"),
                     launches_by_site=main_path["window_hash_sites"],
                     explicit_starts_ms=kw_segments["explicit_ms"],
                     explicit_starts_bound_ms=kw_segments[
                         "explicit_bound"][0],
                     dense_explicit_ms=kw_result["ms"],
                     dense_explicit_bound_ms=kw_result["bound"][0]),
        _kernel_line("chain_contig",
                     "metamdbg_tpu_torch/csrc/chain_contig.cu",
                     "metamdbg_tpu/kernels/chain_jax.py:131",
                     launches[2], chain_result, main_path["chain_contig"]),
        _kernel_line("chain_dp", "metamdbg_tpu_torch/csrc/chain_dp.cu",
                     "metamdbg_tpu/kernels/chain_jax.py:29",
                     k4_launches, chain_dp_result, k4_main)]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
