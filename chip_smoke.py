"""Drive the PyTorch/CUDA port (metamdbg_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
1. device: a CUDA GPU must be visible; prints its nvidia-smi name and
   power limit;
2. build: compiles the sketch kernel (csrc/sketch.cu) and the window hash
   kernel (csrc/window_hash.cu) with nvcc for sm_90a, one nvcc per source,
   started together, and prints the build seconds;
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
4. end to end: a 4 Mb circular genome at 30x HiFi (tests/datagen.py, seed
   1) through `python -m metamdbg_tpu_torch asm --device cuda --threads 1`'s
   entry point. The kernels' launch counts are set to 0 just before and
   read just after; the run must have launched the sketch kernel once per
   tile batch and the window hash kernel in every createGraph pass; read
   selection and every k*_createGraph and k*_generateContigs stage must
   have run as port:cuda, and the output must be one circular contig
   within 2 kb of 4 Mb. The sha256 of each pass's graph artifacts is
   recorded as the pass ends. Prints stage walls;
5. reference: the JAX package's read selection, host-only and with jax
   imports blocked, on the same reads, in a subprocess; read_data_init.txt,
   read_stats.txt and read_data_corrected.txt must be byte-identical;
6. graph reference: the JAX package's minimizer-space stages, host-only,
   jax blocked, in a subprocess, pass by pass on a copy of the port's
   read_data_corrected.txt with the port's per-pass parameters, in the
   order of pipeline/asm.py (the assembly-graph exports are left out).
   Every pass's kminmerData_abundance.txt, kminmerData_min.txt (first two
   passes), unitigGraph.*.bin, filter/unitigs_*.bin, contigs.nodepath,
   refined abundances, smallContigs_k*.bin and unitig_data.txt
   (contig_data_init.txt at the last pass) must be byte-identical.

The line before the last is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}.
"""

import concurrent.futures
import glob
import gzip
import hashlib
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

_BLOCKED_JAX_READ_SELECTION = """
import importlib.abc, sys
class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(name + " is blocked in this process")
        return None
sys.meta_path.insert(0, _BlockJax())
from metamdbg_tpu.io import records
from metamdbg_tpu.sketch import read_selection
fq, out = sys.argv[1:3]
read_selection.run_read_selection(
    [fq], out, records.Parameters(minimizer_size=15, density_assembly=0.005,
                                  density_correction=0.025,
                                  use_homopolymer_compression=True),
    skip_correction=True)
"""

_BLOCKED_JAX_GRAPH = """
import importlib.abc, sys
class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(name + " is blocked in this process")
        return None
sys.meta_path.insert(0, _BlockJax())
import json, os
from metamdbg_tpu.graph import contigs, multiplex, stage
from metamdbg_tpu.io import records
from chip_smoke import pass_digests
work, params_dir = sys.argv[1:3]
first_k, last_k = int(sys.argv[3]), int(sys.argv[4])
out = {}
for k in range(first_k, last_k + 1):
    p = records.Parameters.load(os.path.join(params_dir, f"k{k}.gz"))
    p.save(os.path.join(work, "parameters.gz"))
    if k == first_k:
        stage.run_graph_first_pass(work, k, 0)
    elif k == first_k + 1:
        stage.run_graph_second_pass(work, k, p)
    else:
        multiplex.run_graph_multiplex_pass(work, k, p)
    contigs.run_contig_stage(work, p, 50000, 50000)
    name = "contig_data_init.txt" if k == last_k else "unitig_data.txt"
    contigs.run_to_minspace(work, os.path.join(work, "contigs.nodepath"),
                            os.path.join(work, name),
                            os.path.join(work, "unitigGraph.nodes.bin"), p)
    out[k] = pass_digests(work, k, first_k, k == last_k)
print(json.dumps(out))
"""


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
    from metamdbg_tpu_torch.kernels import build, sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw

    def timed(name, sources):
        t0 = time.perf_counter()
        path = build.build(name, sources)
        return path, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(timed, "sketch", ksketch._SOURCES),
                pool.submit(timed, "window_hash", kw._SOURCES)]
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
    (max_abs_err, kernel ms, plain ms)."""
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
        out[density] = (err, k_ms, p_ms)
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
    plain ms) at w = KW_TIMED, normalize on (the ladder's mode)."""
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
        print(f"kernel window_hash w={w}: {starts.numel()} windows "
              f"({n_pal} palindromes), both modes bit-identical to plain")
    print(f"kernel window_hash w={KW_TIMED} normalize: kernel "
          f"{times[0]:.4f} ms, plain torch {times[1]:.4f} ms per "
          f"{KW_STREAM} windows")
    return err, times[0], times[1]


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


def e2e_phase(work, dev, genome_len=GENOME_LEN, coverage=30):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import datagen
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.kernels import window_hash as kw
    from metamdbg_tpu_torch.pipeline import asm
    from metamdbg_tpu_torch.sketch import batch

    fq = os.path.join(work, "reads.fastq.gz")
    t0 = time.perf_counter()
    datagen.make_test_fastq(fq, genome_len=genome_len, coverage=coverage,
                            mean_length=12000, error_rate=0.002, seed=1)
    print(f"e2e: generated {genome_len} bp x {coverage}x HiFi reads in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(fq) / 1e6:.1f} MB gz)")

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

    asm.Pipeline._save_pass_snapshot = record_pass
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    ksketch.reset_counts()
    kw.reset_counts()
    batch.tile_batches = 0
    try:
        t0 = time.perf_counter()
        rc = main(["asm", "--out-dir", out, "--in-hifi", fq, "--device",
                   dev.type, "--threads", "1"])
        wall = time.perf_counter() - t0
    finally:
        asm.Pipeline._save_pass_snapshot = snapshot
    launches = ksketch.launches
    relaunches = ksketch.overflow_launches
    tile_batches = batch.tile_batches
    kw_launches = kw.launches
    if rc != 0:
        fail(f"asm returned {rc}")

    walls, rss = {}, ""
    for line in open(os.path.join(out, "tmp", "memoryTrack.txt")):
        name, dt, rss = line.split()
        name = re.sub(r"^k\d+_", "k*_", name)  # one line per multi-k stage
        walls[name] = walls.get(name, 0.0) + float(dt.rstrip("s"))
    for name, dt in walls.items():
        print(f"e2e stage {name}: {dt:.2f} s")
    print(f"e2e peak RSS {rss}")
    print(f"e2e: asm wall {wall:.1f} s; sketch kernel launches {launches} "
          f"({relaunches} overflow relaunches) over {tile_batches} tile "
          f"batches")
    if (launches == 0) != (dev.type == "cpu") or \
            launches - relaunches != tile_batches * (dev.type == "cuda"):
        fail(f"sketch kernel launched {launches} times ({relaunches} "
             f"relaunches) for {tile_batches} tile batches")
    prov = json.load(open(os.path.join(out, "tmp", "device.json")))
    port = f"port:{dev.type}"
    if prov["stages"].get("readSelection") != port:
        fail(f"readSelection ran as {prov['stages'].get('readSelection')}")
    graph = {n: r for n, r in prov["stages"].items()
             if n.endswith(("_createGraph", "_generateContigs"))}
    bad = {n: r for n, r in graph.items() if r != port}
    by_pass = prov["window_hash_kernel"]["by_stage"]
    n_pass = sum(n.endswith("_createGraph") for n in graph)
    if bad or n_pass != len(digests):
        fail(f"graph stages not run as {port}: {bad}; {n_pass} passes")
    if sum(by_pass.values()) != kw_launches or dev.type == "cuda" and (
            len(by_pass) != n_pass or min(by_pass.values()) < 1):
        fail(f"window hash kernel: {kw_launches} launches, per pass "
             f"{by_pass}")
    print(f"e2e: {n_pass} passes, k*_createGraph and k*_generateContigs "
          f"all {port}; window hash kernel launches {kw_launches} "
          f"({min(by_pass.values())}-{max(by_pass.values())} per pass)")

    headers, lengths = [], []
    with gzip.open(os.path.join(out, "contigs.fasta.gz"), "rt") as f:
        for line in f:
            if line.startswith(">"):
                headers.append(line.strip())
                lengths.append(0)
            else:
                lengths[-1] += len(line.strip())
    print(f"e2e: {len(lengths)} contig(s), lengths {lengths}, "
          f"headers {headers[:3]}")
    if len(lengths) != 1 or "circular=yes" not in headers[0] or \
            abs(lengths[0] - genome_len) > 2000:
        fail(f"expected one circular contig within 2 kb of {genome_len}")
    return fq, out, (launches, kw_launches), wall, params_dir, digests


def reference_phase(work, fq, out):
    ref = os.path.join(work, "jax_read_selection")
    os.makedirs(ref)
    env = dict(os.environ, METAMDBG_TPU_HOST_ONLY="1", PYTHONPATH=REPO)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", _BLOCKED_JAX_READ_SELECTION, fq,
                    ref], cwd=REPO, env=env, check=True)
    print(f"reference: JAX package read selection (host-only, jax blocked) "
          f"in {time.perf_counter() - t0:.1f} s")
    for name in ("read_data_init.txt", "read_stats.txt",
                 "read_data_corrected.txt"):
        a = open(os.path.join(ref, name), "rb").read()
        b = open(os.path.join(out, "tmp", name), "rb").read()
        if a != b:
            fail(f"{name} differs from the JAX package's")
        print(f"reference: {name} byte-identical ({len(a)} bytes)")


def graph_reference_phase(work, out, params_dir, digests):
    ref = os.path.join(work, "jax_graph")
    for sub in ("filter", "smallContigs"):
        os.makedirs(os.path.join(ref, sub))
    shutil.copyfile(os.path.join(out, "tmp", "read_data_corrected.txt"),
                    os.path.join(ref, "read_data_corrected.txt"))
    ks = sorted(int(k) for k in digests)
    env = dict(os.environ, METAMDBG_TPU_HOST_ONLY="1", PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_JAX_GRAPH, ref,
                           params_dir, str(ks[0]), str(ks[-1])], cwd=REPO,
                          env=env, check=True, capture_output=True,
                          text=True)
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"graph reference: JAX package k={ks[0]}..{ks[-1]} (host-only, "
          f"jax blocked) in {time.perf_counter() - t0:.1f} s")
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


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    kern = kernel_phase(dev)
    kw_err, kw_ms, kw_plain_ms = kw_phase(dev)
    count_phase(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fq, out, launches, _, params_dir, digests = e2e_phase(work, dev)
        reference_phase(work, fq, out)
        graph_reference_phase(work, out, params_dir, digests)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    _, k_ms, p_ms = kern[0.005]
    print(json.dumps({"kernels": [{
        "name": "sketch_tiles", "route": "cuda",
        "source": "metamdbg_tpu_torch/csrc/sketch.cu",
        "replaces": "metamdbg_tpu/kernels/sketch_pallas.py:49",
        "launches": launches[0], "max_abs_err": max(e for e, _, _ in
                                                     kern.values()),
        "ms": k_ms, "plain_ms": p_ms}, {
        "name": "window_hash", "route": "cuda",
        "source": "metamdbg_tpu_torch/csrc/window_hash.cu",
        "replaces": "metamdbg_tpu/parallel/count_table.py:29 + "
                    "native/sketch.cpp:523",
        "launches": launches[1], "max_abs_err": kw_err,
        "ms": kw_ms, "plain_ms": kw_plain_ms}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
