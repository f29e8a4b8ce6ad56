"""The port's host fan-out (metamdbg_tpu_torch/utils/threadmap.py) and the
four native-engine wrappers split over it, and the port's peak RSS.

Each wrapper packs its batch once and makes one engine call per range of
items on its own thread. On the same inputs, made from a seed with numpy,
its output at 1, 3 and 8 threads must equal the JAX package's wrapper's at
one thread, exactly, on batches with empty items, fewer items than
threads, counts at the ranges' edges and one item far larger than the
rest. With the ctypes function wrapped, every engine call must get one
engine thread, and a split batch must reach the engine from more than one
thread.
"""

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from metamdbg_tpu.basespace import overlap_native as j_overlap
from metamdbg_tpu.basespace import poa_native as j_poa
from metamdbg_tpu.basespace import window_cut_native as j_cut
from metamdbg_tpu.correction import poa_native as j_corr
from metamdbg_tpu_torch.basespace import overlap, overlap_native, polisher
from metamdbg_tpu_torch.basespace import poa_native, window_cut_native
from metamdbg_tpu_torch.correction import poa_native as corr_native
from metamdbg_tpu_torch.utils import spans, threadmap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
THREADS = (1, 3, 8)
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[ACGT] = np.frombuffer(b"TGCA", np.uint8)


# -- threadmap ---------------------------------------------------------------

@pytest.mark.parametrize("n_threads", [1, 3, 8, 32])
def test_thread_map_keeps_order(n_threads):
    rng = np.random.default_rng(n_threads)
    delays = rng.random(300) * 1e-4

    def fn(i):
        time.sleep(delays[i])
        return i * i

    assert threadmap.thread_map(fn, range(300), n_threads) == \
        [i * i for i in range(300)]


def test_thread_map_raises_a_workers_exception_without_a_retry():
    calls = []

    def fn(i):
        calls.append(i)
        if i == 37:
            raise ValueError("item 37")
        time.sleep(1e-4)
        return i

    with pytest.raises(ValueError, match="item 37"):
        threadmap.thread_map(fn, range(400), 4)
    # nothing ran the failed item again, and the workers stopped pulling
    assert calls.count(37) == 1 and len(set(calls)) == len(calls)
    assert len(calls) < 400


def test_thread_map_under_fast_switching():
    """More workers than cores, a switch every microsecond: every item is
    computed once, none lost or repeated (the shared counter and the
    packing clock hold their locks): the workers add to the span that
    started the map, recording under torch.profiler, one count an item
    and their packing seconds, and no update is lost."""
    seen = []
    packed = [0.0] * 20000

    def fn(i):
        t0 = time.time_ns()
        with threadmap.packing("stress"):
            seen.append(i)
        packed[i] = (time.time_ns() - t0) / 1e9
        spans.add("items")
        return i

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                spans.span("stress") as s:
            out = threadmap.thread_map(fn, range(20000),
                                       4 * (os.cpu_count() or 1))
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(interval)
    assert out == list(range(20000))
    assert sorted(seen) == list(range(20000))
    assert s.counts["items"] == 20000
    # each block lies inside the worker's own clock reads around it
    assert 0 < s.counts["pack.stress"] <= sum(packed) + 1e-6


def test_nested_map_runs_inline_in_a_stage_pool():
    """A map inside a worker of the stage's pool runs on that worker (a
    nested submit to the same pool could wait forever)."""
    outer = []

    def inner(i):
        return threading.get_ident()

    def fn(i):
        me = threading.get_ident()
        outer.append(me)
        return all(t == me for t in threadmap.thread_map(inner, range(50),
                                                         4))

    with threadmap.stage_pool(2):
        assert threadmap.thread_map(fn, range(6), 2) == [True] * 6
    assert threading.get_ident() not in outer


@pytest.mark.parametrize("n_items,n_threads,min_size", [
    (0, 4, 1), (1, 8, 1), (5, 1, 1), (24, 3, 1), (25, 3, 1), (17, 3, 16),
    (1000, 8, 4)])
def test_ranges_cover_in_order(n_items, n_threads, min_size):
    rs = threadmap.ranges(n_items, n_threads, min_size)
    assert [i for lo, hi in rs for i in range(lo, hi)] == list(range(n_items))
    assert all(hi - lo >= min(min_size, n_items) for lo, hi in rs[:-1])
    assert len(rs) == (n_items > 0) if n_threads <= 1 else \
        len(rs) <= max(1, n_threads * threadmap.RANGES_PER_THREAD)


# -- inputs ------------------------------------------------------------------

def _mutate(rng, seq, rate):
    """Substitutions, insertions and deletions at `rate` each."""
    out = []
    for b in seq:
        r = rng.random()
        if r < rate:
            out.append(ACGT[rng.integers(4)])
        elif r < 2 * rate:
            out.extend((b, ACGT[rng.integers(4)]))
        elif r >= 3 * rate:
            out.append(b)
    return np.asarray(out, np.uint8)


@pytest.fixture(scope="module")
def genome():
    return ACGT[np.random.default_rng(5).integers(0, 4, 40_000)]


def _window(rng, genome, n_frags, bb_len):
    s = int(rng.integers(0, genome.shape[0] - bb_len))
    backbone = genome[s:s + bb_len]
    frags = []
    for _ in range(n_frags):
        a = int(rng.integers(0, bb_len // 4))
        b = int(rng.integers(3 * bb_len // 4, bb_len))
        seq = _mutate(rng, backbone[a:b], 0.02)
        qual = (rng.integers(33, 75, seq.shape[0]).astype(np.uint8)
                .tobytes() if rng.random() < 0.5 else None)
        frags.append((seq.tobytes(), qual, a, b - 1))
    return backbone.tobytes(), frags


# counts of items at the ranges' edges (8 ranges a thread, at least
# min_size items a range), below the thread count, and none
POA_SIZES = (0, 2, 24, 25, 65)
MAP_SIZES = (0, 2, 16, 17, 33, 130)
CORRECTION_SIZES = (0, 2, 4, 5, 97)


def _poa_batch(genome, n):
    """n windows: every fifth without fragments, the first of 80
    fragments over a full window (the rest 2-8 over 60-300 bp)."""
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        if i == 0:
            out.append(_window(rng, genome, 80, 500))
        elif i % 5 == 0:
            out.append(_window(rng, genome, 0, 100))
        else:
            out.append(_window(rng, genome, int(rng.integers(2, 9)),
                               int(rng.integers(60, 300))))
    return out


@pytest.mark.parametrize("n", POA_SIZES)
def test_polish_windows_split(genome, n):
    batch = _poa_batch(genome, n)
    want = j_poa.polish_windows(batch, n_threads=1)
    assert len(want) == n
    for t in THREADS:
        got = poa_native.polish_windows(batch, n_threads=t)
        assert len(got) == n
        for (gc, gv), (wc, wv) in zip(got, want):
            assert gc == wc and np.array_equal(gv, wv)


@pytest.fixture(scope="module")
def mapping(genome):
    """Two contigs (the genome's halves), their index, and reads: mutated
    substrings, every third reverse-complemented, each fifth an empty
    sketch, every fourth excluding its own contig, a 15 kb one first."""
    rng = np.random.default_rng(11)
    contigs = {0: genome[:20_000].copy(), 1: genome[20_000:].copy()}
    index = overlap.SeqIndex()
    for (cid, seq), sk in zip(contigs.items(), overlap.sketch_many(
            list(contigs.values()), CPU)):
        index.add(cid, seq.shape[0], sk)
    index.build()
    reads, sources = [], []
    for i in range(max(MAP_SIZES)):
        ln = 15_000 if i == 0 else int(rng.integers(600, 3000))
        cid = int(rng.integers(2))
        s = int(rng.integers(0, 20_000 - ln))
        read = _mutate(rng, contigs[cid][s:s + ln], 0.003)
        if i % 3 == 2:
            read = COMPLEMENT[read[::-1]]
        reads.append(read)
        sources.append(cid)
    sketches = overlap.sketch_many(reads, CPU)
    queries = []
    for i, (seq, (v, p, d)) in enumerate(zip(reads, sketches)):
        if i % 5 == 4:
            v, p, d = v[:0], p[:0], d[:0]
        queries.append((v, p, d, seq.shape[0],
                        sources[i] if i % 4 == 3 else -1))
    return contigs, index, reads, queries


def _map(mod, index, queries, n_threads):
    return mod.map_sketched_batch(
        index, queries, index.density, 500, 64, 500, 4, 4, overlap.ALIGN_L,
        n_threads=n_threads)


def _same_chains(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gc, wc in zip(g, w):
            assert gc[:8] == wc[:8]
            assert np.array_equal(gc[8], wc[8]) and \
                np.array_equal(gc[9], wc[9])


@pytest.mark.parametrize("n", MAP_SIZES)
def test_map_sketched_batch_split(mapping, n):
    _, index, _, queries = mapping
    want = _map(j_overlap, index, queries[:n], 1)
    if n > 2:
        assert sum(len(c) for c in want) >= n // 2
    for t in THREADS:
        _same_chains(_map(overlap_native, index, queries[:n], t), want)


def _cut_items(mapping, n):
    """n (read, alignment) items from the reads' maps to the contigs:
    the 15 kb read's first; an empty item, one anchor, every fifth."""
    contigs, _, reads, _ = mapping
    als = polisher.map_reads_to_contigs(
        contigs, [(i, r, None) for i, r in enumerate(reads)], CPU)
    items = []
    for ri in sorted(als):
        for al in als[ri]:
            if len(items) % 5 == 4:
                al = types.SimpleNamespace(
                    contig_index=al.contig_index,
                    contig_start=al.contig_start,
                    contig_end=al.contig_start + 1,
                    anchors=(al.anchors[0][:1], al.anchors[1][:1]))
            items.append((reads[ri], al))
    assert len(items) >= max(MAP_SIZES) // 2
    return items[:n], contigs


@pytest.mark.parametrize("n", MAP_SIZES)
def test_window_cut_batch_split(mapping, n):
    items, contigs = _cut_items(mapping, n)
    args = (items, contigs, polisher.WINDOW_LEN, overlap.ALIGN_L,
            4 * polisher.WINDOW_LEN)
    want = j_cut.window_cut_batch(*args, n_threads=1) if items else []
    for t in THREADS:
        got = window_cut_native.window_cut_batch(*args, n_threads=t)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[4] == w[4]
            for a, b in zip(g[:4], w[:4]):
                assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def read_set():
    """Minimizer reads of a minimizer genome (2% of minimizers replaced,
    1% dropped), each read's align list its true overlappers; read 0 is
    10x longer than the rest, every seventh read has no overlapper."""
    rng = np.random.default_rng(3)
    g_mins = rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)
    g_pos = np.cumsum(rng.integers(10, 70, 20_000)).astype(np.int64)
    spans, reads = [], []
    for i in range(max(CORRECTION_SIZES)):
        n = 2000 if i == 0 else int(rng.integers(60, 200))
        s = int(rng.integers(0, 20_000 - n))
        keep = rng.random(n) >= 0.01
        mins = g_mins[s:s + n][keep].copy()
        sub = rng.random(mins.shape[0]) < 0.02
        mins[sub] = rng.integers(0, 2**32, int(sub.sum()),
                                 dtype=np.uint64).astype(np.uint32)
        pos = (g_pos[s:s + n][keep] - g_pos[s]).astype(np.uint32)
        reads.append(types.SimpleNamespace(
            minimizers=mins, positions=pos,
            directions=rng.integers(0, 2, mins.shape[0]).astype(np.uint8),
            qualities=rng.integers(5, 40, mins.shape[0]).astype(np.uint8),
            read_length=int(pos[-1]) + 500))
        spans.append((s, s + n))
    align_lists = []
    for i, (a, b) in enumerate(spans):
        if i % 7 == 6:
            align_lists.append([])
            continue
        align_lists.append([j for j, (c, d) in enumerate(spans)
                            if j != i and c < b and a < d])
    params = types.SimpleNamespace(density_assembly=0.5, minimizer_size=15)
    return reads, align_lists, params


@pytest.mark.parametrize("n", CORRECTION_SIZES)
def test_correct_reads_batch_split(read_set, n):
    reads, align_lists, params = read_set
    work = list(range(n))
    args = (work, align_lists, params, 0.7, 1000, 62)
    want = j_corr.correct_reads_batch(j_corr.ReadSetBuffers(reads), *args,
                                      n_threads=1)
    if n > 2:
        assert sum(m.shape[0] for m in want) > 0
    buffers = corr_native.ReadSetBuffers(reads)
    for t in THREADS:
        got = corr_native.correct_reads_batch(buffers, *args, n_threads=t)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


# -- every engine call on one thread, a split batch on several ---------------

class _Spy:
    """A library whose `name` function records the calling thread and the
    engine thread count (its last argument), then lets other threads run
    before it calls the real function."""

    def __init__(self, lib, name):
        self._lib, self.calls = lib, []
        real = getattr(lib, name)

        def spy(*args):
            last = args[-1]
            self.calls.append((threading.get_ident(),
                               int(getattr(last, "value", last))))
            time.sleep(0.002)
            return real(*args)

        setattr(self, name, spy)

    def __getattr__(self, attr):
        return getattr(self._lib, attr)


@pytest.mark.parametrize("wrapper", ["poa", "map", "cut", "correction"])
def test_engine_calls_one_thread_each_from_several(
        genome, mapping, read_set, monkeypatch, wrapper):
    _, index, _, queries = mapping
    mod, fn_name, call = {
        "poa": (poa_native, "poa_polish_windows", lambda t: (
            poa_native.polish_windows(_poa_batch(genome, 65), n_threads=t))),
        "map": (overlap_native, "ovl_map_batch", lambda t: (
            _map(overlap_native, index, queries, t))),
        "cut": (window_cut_native, "window_cut_batch", lambda t: (
            window_cut_native.window_cut_batch(
                *_cut_items(mapping, 130), polisher.WINDOW_LEN,
                overlap.ALIGN_L, 4 * polisher.WINDOW_LEN, n_threads=t))),
        "correction": (corr_native, "correct_reads_batch", lambda t: (
            corr_native.correct_reads_batch(
                corr_native.ReadSetBuffers(read_set[0]), list(range(97)),
                read_set[1], read_set[2], 0.7, 1000, 62, n_threads=t))),
    }[wrapper]
    spy = _Spy(mod._load(), fn_name)
    monkeypatch.setattr(mod, "_LIB", spy)
    call(1)
    assert len(spy.calls) == 1 and spy.calls[0][1] == 1
    spy.calls.clear()
    call(4)
    assert len(spy.calls) >= 2
    assert {t for _, t in spy.calls} == {1}
    assert len({ident for ident, _ in spy.calls}) >= 2


# -- peak RSS ----------------------------------------------------------------

_CHILD = """
import sys, time
import numpy as np
from metamdbg_tpu_torch.pipeline import asm
if sys.argv[1] == "sampled":  # as on a /proc without VmHWM (gVisor's)
    status_kb = asm._status_kb
    asm._status_kb = lambda f: None if f == "VmHWM" else status_kb(f)
    asm.start_rss_sampler(0.01)
base = asm.peak_rss_gb()
spike = np.ones(200 << 20, np.uint8)
time.sleep(0.2)
del spike
time.sleep(0.1)
print(base, asm.peak_rss_gb())
"""


@pytest.mark.parametrize("mode", ["vmhwm", "sampled"])
def test_peak_rss_is_the_process_own(mode):
    """A child started by a parent that touched 512 MB more reports its
    own peak (~0.22 GB after importing the port: the interpreter, numpy
    and torch), not the parent's (getrusage's ru_maxrss survives fork and
    exec), and sees its own 200 MB spike after it has gone: from VmHWM,
    or from VmRSS sampled where /proc has no VmHWM."""
    from metamdbg_tpu_torch.pipeline.asm import peak_rss_gb

    ballast = np.ones(512 << 20, np.uint8)
    assert peak_rss_gb() > 0.5
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, mode], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    del ballast
    assert out.returncode == 0, out.stderr
    base, peak = map(float, out.stdout.split())
    assert base < 0.45
    assert 0.15 < peak - base < 0.3
