"""Drive the PyTorch/CUDA port (metamdbg_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

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
   the main path's shape, (512, 16384) u8 tiles at l=15 and densities
   0.005 and 0.025, with bad bases, separators and one overflow row; the
   results must be bit-identical (tolerance 0: all outputs are integers).
   Prints the median kernel and plain times (CUDA events, after a warm-up);
3b. window hash kernel: KW against its plain torch version on the card, on
   a stream of 4,194,304 u32 minimizers (values < 2^30, with palindromic
   windows and values near 2^32 - 1 planted), one start per full window,
   w in {4, 5, 6, 7, 16, 61}, normalize on and off: bit-identical
   (tolerance 0). Prints the median kernel and plain times at w = 16;
3c. row counting (K2, torch ops): kernels/count.py on the card against the
   same function on CPU tensors, on a (2^20, 5) table with repeats: the
   unique rows and counts must be identical;
3d. chain kernel (K3): the read-vs-contig chain DP against its plain torch
   version on the card, on 16,384 anchor groups of 2-300 anchors and three
   of 5,000-10,000 (both strands, noise anchors, planted equal-score ties),
   at the asm's d_r_max: scores (as f32 bits), parents and best indexes
   identical (tolerance 0). Prints the median kernel and plain times;
3e. chain DP kernel (K4): the correction mapper's chain DP against its plain
   torch version on the card, on 500,000 anchor groups of 3-200 anchors and
   three of 5,000-10,000 (both strands, noise anchors, planted equal-score
   ties), at bands 62 (the asm's), 10 and 125: scores (as f32 bits),
   parents, best indexes, chain lengths, chain scores and chain positions
   identical (tolerance 0). Prints the median kernel and plain times and
   the bound at band 62;
4. end to end: a 4 Mb circular genome at 30x HiFi (tests/datagen.py, seed
   1) through `python -m metamdbg_tpu_torch asm --device cuda --threads 1`'s
   entry point, in this process, where a sys.meta_path finder refuses
   every import of the JAX package (`metamdbg_tpu`). The kernels' launch
   counts are set to 0 just before and read just after; the run must have
   launched the sketch kernel once per tile batch (toBasespace's included),
   the window hash kernel in every createGraph pass and the chain kernel
   in toBasespace; every stage, from readSelection to toBasespace, must
   have run as port:cuda, and the output must be one circular contig
   within 2 kb of 4 Mb. The sha256 of each pass's graph artifacts is
   recorded as the pass ends. Prints stage walls.
8. ONT end to end (run after the references of phases 5-7 and the one of
   phase 9 have started, beside them): the 3-genome ONT metagenome of
   tests/test_quality_harness.py:103-112 (~86 Mbp) through `asm --in-ont
   --device cuda --threads 1` in this process, the JAX package refused. The
   launch counts are set to 0 just before and read just after: every
   kernel must have launched, K4 and the sketch kernel in readCorrection;
   every stage, readCorrection included, must have run as port:cuda, and
   the contigs' total length must lie within 2% of 2.1 Mb. Prints stage
   walls, the correction checksum, the contigs, and K4's time on the main
   path's own inputs, launched again after the run.

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
   correction checksums equal.

The line before the last two is a JSON object describing each kernel: its
launches in phase 4 (K4's in phase 8), its largest difference from the
plain version, its time and the plain version's (phase 3, 3b, 3d, 3e), and
`bound_ms`, the least
time the card could take for the same work on those inputs (the larger of
bytes over the memory rate and operations over the peak rate), with what
bounds it. The line before the last is the card's nvidia-smi name and
power limit; the last is {"ok": true, "device": {...}}.
"""

import concurrent.futures
import glob
import gzip
import hashlib
import importlib.abc
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
L_MIN, DENSITIES = 15, (0.005, 0.025)
GENOME_LEN = 4_000_000
KW_STREAM, KW_WIDTHS, KW_TIMED = 4_194_304, (4, 5, 6, 7, 16, 61), 16
FIRST_K = 4

JAX_REFERENCE = os.path.join(REPO, "tests", "jax_reference.py")
BASESPACE_OUTPUTS = ("contig_data_init_small.txt",
                     "contig_data_init_small.txt.nooverlaps",
                     "contig_data_init_small.txt.norepeats",
                     "readsVsContigsAlignments.bin", "contig_data_final.bin")
CHAIN_GROUPS, CHAIN_MAX_LEN, CHAIN_LONG = 16_384, 300, (5_000, 7_500, 10_000)
CHAIN_DP_GROUPS, CHAIN_DP_MAX_LEN = 500_000, 200
CHAIN_DP_BANDS, CHAIN_DP_TIMED = (62, 10, 125), 62
# the ONT metagenome of tests/test_quality_harness.py:103-112 (~86 Mbp)
ONT_SIZES, ONT_COVERAGES = (500_000, 700_000, 900_000), (15, 35, 60)
ONT_TOTAL_LEN, ONT_LEN_TOLERANCE = 2_100_000, 0.02
CORRECTION_OUTPUTS = ("read_data_init.txt", "read_stats.txt",
                      "repetitiveMinimizers.bin",
                      "readAlignmentsLowDensity.bin",
                      "read_data_corrected.txt")

# The least time for a kernel's work: one H100 SXM at its full 700 W
# (NVIDIA's H100 data sheet), and 64 INT32 lanes per
# SM x 132 SMs x 1.98 GHz for 32-bit integer work (Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations per item, estimated from each kernel's source: K1 per
# window (roll, canonical pick, murmur64 finalizer, cut), KW per window
# at w = 16 (normalization and murmur128 over 16 words), K3 and K4 per
# (anchor, predecessor) test, which also takes 2 f32 operations.
K1_INT_OPS, KW_INT_OPS, K3_INT_OPS, K3_F32_OPS = 80, 150, 15, 2
K4_INT_OPS, K4_F32_OPS = 15, 2


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


def bound(nbytes, int_ops, f32_ops=0):
    """(bound_ms, bound_by): the larger of the bytes' time at the memory
    rate and the operations' time at the peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT32_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(dev):
    """Kernel against plain version at (512, 16384); returns per-density
    (max_abs_err, kernel ms, plain ms, bound)."""
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.sketch.batch import TILE_LEN, TILE_ROWS

    out = {}
    l = L_MIN
    nk = TILE_LEN - l + 1
    for i, density in enumerate(DENSITIES):
        cap = ksketch.compact_cap(nk, density)
        codes = _tiles(TILE_ROWS, TILE_LEN, l, seed=100 + i)
        codes[7] = _tandem_row(TILE_LEN, l, density, cap, 200 + i, dev)
        codes = torch.from_numpy(codes).to(dev)

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
        if err != 0:
            fail(f"density {density}: kernel differs from the plain version "
                 f"(max abs err {err})")

        k_ms = _time_ms(lambda: ksketch._launch(codes, l, density, cap), 20)
        p_ms = _time_ms(lambda: ksketch.sketch_tiles_reference(
            codes, l, density, cap), 5)
        sel = int(counts.sum())
        print(f"kernel sketch_tiles (512, 16384) l={l} density={density} "
              f"cap={cap}: bit-identical to plain ({sel} selected, overflow "
              f"row count {m}); kernel {k_ms:.4f} ms, plain torch "
              f"{p_ms:.4f} ms per batch")
        n = TILE_ROWS
        out[density] = (err, k_ms, p_ms, bound(
            n * TILE_LEN + n * cap * (4 + 4 + 1) + n * 4,
            K1_INT_OPS * n * nk))
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


def kw_phase(dev):
    """KW against its plain version; returns (max_abs_err, kernel ms,
    plain ms, bound) at w = KW_TIMED, normalize on (the ladder's mode)."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    cat = torch.from_numpy(_kw_stream(KW_STREAM, seed=300)).to(dev)
    err, times = 0, None
    for w in KW_WIDTHS:
        starts = torch.arange(KW_STREAM - w + 1, device=dev)
        win = cat[starts[:, None] + torch.arange(w, device=dev)]
        n_pal = int((win == win.flip(1)).all(dim=1).sum())
        del win
        for normalize in (True, False):
            got = kw.hash_windows(cat, starts, w, normalize)
            torch.cuda.synchronize()
            want = kw.hash_windows_reference(cat, starts, w, normalize)
            diff = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
            err = max(err, int(torch.stack([got[0] - want[0],
                                            got[1] - want[1]]).abs().max()))
            if diff or err:
                fail(f"window hash w={w} normalize={normalize}: {diff} "
                     f"windows differ from the plain version")
        if w == KW_TIMED:
            times = (_time_ms(lambda: kw._launch(cat, starts, w, True), 20),
                     _time_ms(lambda: kw.hash_windows_reference(
                         cat, starts, w, True), 5))
            nw = starts.numel()
            # the stream, the starts, two int64 hash words per window
            kw_bound = bound(KW_STREAM * 8 + nw * 8 + nw * 16,
                             KW_INT_OPS * nw)
        print(f"kernel window_hash w={w}: {starts.numel()} windows "
              f"({n_pal} palindromes), both modes bit-identical to plain")
    print(f"kernel window_hash w={KW_TIMED} normalize: kernel "
          f"{times[0]:.4f} ms, plain torch {times[1]:.4f} ms per "
          f"{KW_STREAM} windows")
    return err, times[0], times[1], kw_bound


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
    print(f"row counting (2^20, 5): {want[0].shape[0]} unique rows, "
          f"identical on the card and the CPU ({dt * 1e3:.1f} ms on the "
          f"card, first call)")


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
            r0 = int(ref.max()) + 30
            q0 = 3 + (0 if rev else int(q.max()) + 20)
            ref = np.concatenate([ref, [r0, r0 + 2, r0 + 4]])
            q = np.concatenate([q, [q0, q0, q0 - 3 if rev else q0 + 3]])
            is_rev = np.concatenate([is_rev, [rev] * 3])
        order = np.lexsort((q, ref))
        ref, q, is_rev = ref[order], q[order], is_rev[order]
        bp = np.cumsum(rng.integers(50, 700, int(q.max()) + 1))
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
                 K3_INT_OPS * tests, K3_F32_OPS * tests)


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

    got = kchain.chain_contig(*inputs, d_r_max)
    torch.cuda.synchronize()
    want = kchain.chain_contig_reference(*inputs, d_r_max)
    same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))
    err = max(float((got[0] - want[0]).abs().max()),
              *(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got[1:], want[1:])))
    if not same:
        fail(f"chain kernel differs from the plain version (max abs err "
             f"{err})")
    k_ms = _time_ms(lambda: kchain._launch(*inputs, d_r_max), 20)
    p_ms = _time_ms(lambda: kchain.chain_contig_reference(*inputs, d_r_max),
                    2)
    sizes = np.diff(arrays[4])  # chain_groups adds the planted ties
    n = int(sizes.sum())
    chain_bound = chain_contig_bound(sizes)
    chains = int((got[2] >= 0).sum())
    print(f"kernel chain_contig: {lengths.size} groups, {n} anchors (longest "
          f"{int(sizes.max())}, made in {gen_s:.1f} s), d_r_max {d_r_max}: "
          f"scores' f32 bits, parents and best indexes identical to plain "
          f"({chains} groups chained); kernel {k_ms:.4f} ms, plain torch "
          f"{p_ms:.4f} ms")
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
                 K4_INT_OPS * tests, K4_F32_OPS * tests)


def _k4_inputs(arrays):
    """chain_dp's arguments as the kernel takes them: int32 positions."""
    ref, q, rev, q_idx, offsets = arrays
    return ref.to(torch.int32), q.to(torch.int32), rev, q_idx, offsets


def chain_dp_phase(dev):
    """K4 against its plain version at three bands; returns (max_abs_err,
    kernel ms, plain ms, bound) at the asm's band."""
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
    fields = ("scores", "parents", "best_index", "chain_len", "chain_score",
              "chain_pos")
    err, result = 0, None
    for band in CHAIN_DP_BANDS:
        got = k4.chain_dp(*inputs, band)
        torch.cuda.synchronize()
        want = k4.chain_dp_reference(*kin, band)
        same = torch.equal(got.scores.view(torch.int32),
                           want.scores.view(torch.int32)) and all(
            torch.equal(getattr(got, f), getattr(want, f))
            for f in fields[1:])
        band_err = max(float((got.scores - want.scores).abs().max()), *(
            int((getattr(got, f).to(torch.int64)
                 - getattr(want, f).to(torch.int64)).abs().max())
            for f in fields[1:]))
        if not same:
            fail(f"chain_dp kernel at band {band} differs from the plain "
                 f"version (max abs err {band_err})")
        err = max(err, band_err)
        chains = int((got.chain_score != k4.INT32_MIN).sum())
        print(f"kernel chain_dp band {band}: {sizes.size} groups, "
              f"{int(sizes.sum())} anchors (longest {int(sizes.max())}, made "
              f"in {gen_s:.1f} s): scores' f32 bits, parents, best indexes, "
              f"chain lengths, chain scores and positions identical to plain "
              f"({chains} chains of >= 3 anchors, longest "
              f"{int(got.chain_len.max())})")
        if band == CHAIN_DP_TIMED:
            k_ms = _time_ms(lambda: k4._launch(*kin, band), 20)
            p_ms = _time_ms(lambda: k4.chain_dp_reference(*kin, band), 1)
            b_ms, b_by = chain_dp_bound(sizes, band)
            print(f"kernel chain_dp band {band}: kernel {k_ms:.4f} ms, plain "
                  f"torch {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            result = (k_ms, p_ms, (b_ms, b_by))
        del got, want
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


def e2e_phase(work, dev, fq, genome_len=GENOME_LEN):
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import chain as kchain
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
    batch.tile_batches = 0
    try:
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
    if rc != 0:
        fail(f"asm returned {rc}")

    walls, rss = _stage_walls(out)
    for name, dt in walls.items():
        print(f"e2e stage {name}: {dt:.2f} s")
    print(f"e2e peak RSS {rss}")
    for line in open(os.path.join(out, "metaMDBG.log")):
        if "polish pass timing" in line or " tiling: " in line:
            print(f"e2e log: {line.split(' INFO ', 1)[-1].strip()}")
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
    by_kernel = {name: prov[name]["by_stage"] for name in
                 ("sketch_kernel", "window_hash_kernel", "chain_kernel")}
    for name, total in (("sketch_kernel", launches),
                        ("window_hash_kernel", kw_launches),
                        ("chain_kernel", k3_launches)):
        if sum(by_kernel[name].values()) != total:
            fail(f"{name}: {total} launches, per stage {by_kernel[name]}")
    if dev.type == "cuda":
        kw_passes = [by_kernel["window_hash_kernel"].get(n, 0)
                     for n in passes]
        if min(kw_passes) < 1:
            fail(f"window hash kernel: per stage "
                 f"{by_kernel['window_hash_kernel']}")
        for name in ("sketch_kernel", "chain_kernel"):
            if by_kernel[name].get("toBasespace", 0) < 1:
                fail(f"{name} did not launch in toBasespace: "
                     f"{by_kernel[name]}")
        stage_of = [n for n, c in by_kernel["chain_kernel"].items()
                    for _ in range(c)]
        for stage, args in zip(stage_of, chain_calls):
            sizes = np.diff(args[4].cpu().numpy())
            ms = _time_ms(lambda: kchain._launch(*args), 20)
            b_ms, b_by = chain_contig_bound(sizes)
            print(f"e2e chain kernel in {stage}: {sizes.size} groups, "
                  f"{int(sizes.sum())} anchors, longest {int(sizes.max())}, "
                  f"d_r_max {args[5]}; again after the run: {ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
        print(f"e2e: {len(passes)} passes; every stage {port}; window hash "
              f"kernel launches {kw_launches} ({min(kw_passes)}-"
              f"{max(kw_passes)} per pass); sketch kernel launches per "
              f"stage {by_kernel['sketch_kernel']}; chain kernel launches "
              f"{k3_launches}, per stage {by_kernel['chain_kernel']}")

    headers, lengths = _contigs(out)
    print(f"e2e: {len(lengths)} contig(s), lengths {lengths}, "
          f"headers {headers[:3]}")
    if len(lengths) != 1 or "circular=yes" not in headers[0] or \
            abs(lengths[0] - genome_len) > 2000:
        fail(f"expected one circular contig within 2 kb of {genome_len}")
    return out, (launches, kw_launches, k3_launches), wall, params_dir, \
        digests


def ont_phase(work, dev, fq):
    """Phase 8: the ONT metagenome through `asm --in-ont --device cuda
    --threads 1` in this process; returns (out dir, K4 launches)."""
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import chain as kchain
    from metamdbg_tpu_torch.kernels import chain_dp as k4
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

    k4.chain_dp = record_chain_dp
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    kernels = {"sketch_kernel": ksketch, "window_hash_kernel": kw,
               "chain_kernel": kchain, "chain_dp_kernel": k4}
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
    launches = {name: k.launches for name, k in kernels.items()}
    if rc != 0:
        fail(f"ONT asm returned {rc}")

    walls, rss = _stage_walls(out)
    for name, dt in walls.items():
        print(f"ont stage {name}: {dt:.2f} s")
    print(f"ont peak RSS {rss}")
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
    if dev.type == "cuda":
        for args in calls:
            kin = _k4_inputs(args[:5])
            sizes = np.diff(args[4].cpu().numpy())
            ms = _time_ms(lambda: k4._launch(*kin, args[5]), 20)
            b = chain_dp_bound(sizes, args[5])
            print(f"ont chain_dp kernel in readCorrection: {sizes.size} "
                  f"groups, {int(sizes.sum())} anchors, longest "
                  f"{int(sizes.max())}, band {args[5]}; again after the "
                  f"run: {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")

    headers, lengths = _contigs(out)
    total = sum(lengths)
    print(f"ont: {len(lengths)} contig(s), total {total} bp, lengths "
          f"{sorted(lengths, reverse=True)[:12]}, "
          f"{sum('circular=yes' in h for h in headers)} circular")
    if abs(total - ONT_TOTAL_LEN) > ONT_LEN_TOLERANCE * ONT_TOTAL_LEN:
        fail(f"ONT contigs total {total} bp, not within "
             f"{ONT_LEN_TOLERANCE:.0%} of {ONT_TOTAL_LEN}")
    return out, launches["chain_dp_kernel"]


def correction_reference_start(work, fq):
    ref = os.path.join(work, "jax_correction")
    os.makedirs(ref)
    return ref, _jax_reference(work, "correction", fq, ref)


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


def _jax_reference(work, phase, *args):
    """Starts tests/jax_reference.py PHASE ARGS; its output goes to files
    in `work`. Returns (process, stdout path, stderr path, start time)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    paths = [os.path.join(work, f"jax_{phase}.{s}") for s in ("out", "err")]
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
    a = open(os.path.join(ref, "contigs.fasta.gz"), "rb").read()
    b = open(os.path.join(out, "contigs.fasta.gz"), "rb").read()
    # bytes 4-7 of a gzip header hold the write time
    if gzip.decompress(a) != gzip.decompress(b) or \
            a[:4] + a[8:] != b[:4] + b[8:]:
        fail("contigs.fasta.gz differs from the JAX package's")
    print(f"basespace reference: contigs.fasta.gz identical (decompressed, "
          f"and {len(a)} gzip bytes outside the write time)")


def _kernel_line(name, source, replaces, launches, result):
    err, ms, plain_ms, (bound_ms, bound_by) = result
    # no single PyTorch call computes any of these functions
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
        count_phase(dev)
        chain_result = chain_phase(dev)
        chain_dp_result = chain_dp_phase(dev)
        fq = reads_wait(hifi_job, "e2e")
        out, launches, _, params_dir, digests = e2e_phase(work, dev, fq)
        rs_ref, rs_job = read_selection_reference_start(work, fq)
        graph_job = graph_reference_start(work, out, params_dir, digests)
        bs_ref, bs_job = basespace_reference_start(work, fq, out)
        jobs += [rs_job, graph_job, bs_job]
        ont_fq = reads_wait(ont_job, "ont")
        corr_ref, corr_job = correction_reference_start(work, ont_fq)
        jobs.append(corr_job)
        ont_out, k4_launches = ont_phase(work, dev, ont_fq)
        reference_phase(rs_ref, rs_job, out)
        graph_reference_phase(graph_job, digests)
        basespace_reference_phase(bs_ref, bs_job, out)
        correction_reference_phase(corr_ref, corr_job, ont_out)
    finally:
        for proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    k1 = kern[0.005]
    k1 = (max(r[0] for r in kern.values()), *k1[1:])
    print(json.dumps({"kernels": [
        _kernel_line("sketch_tiles", "metamdbg_tpu_torch/csrc/sketch.cu",
                     "metamdbg_tpu/kernels/sketch_pallas.py:49",
                     launches[0], k1),
        _kernel_line("window_hash", "metamdbg_tpu_torch/csrc/window_hash.cu",
                     "metamdbg_tpu/parallel/count_table.py:29 + "
                     "native/sketch.cpp:523", launches[1], kw_result),
        _kernel_line("chain_contig",
                     "metamdbg_tpu_torch/csrc/chain_contig.cu",
                     "metamdbg_tpu/kernels/chain_jax.py:131",
                     launches[2], chain_result),
        _kernel_line("chain_dp", "metamdbg_tpu_torch/csrc/chain_dp.cu",
                     "metamdbg_tpu/kernels/chain_jax.py:29",
                     k4_launches, chain_dp_result)]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
