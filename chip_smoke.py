"""Drive the PyTorch/CUDA port (metamdbg_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
1. device: a CUDA GPU must be visible; prints its nvidia-smi name and
   power limit;
2. build: compiles the sketch kernel (csrc/sketch.cu) with nvcc for
   sm_90a and prints the build seconds;
3. kernel: the sketch kernel against its plain torch version on the card at
   the main path's shape, (512, 16384) u8 tiles at l=15 and densities
   0.005 and 0.025, with bad bases, separators and one overflow row; the
   results must be bit-identical (tolerance 0: all outputs are integers).
   Prints the median kernel and plain times (CUDA events, after a warm-up);
4. end to end: a 4 Mb circular genome at 30x HiFi (tests/datagen.py, seed
   1) through `python -m metamdbg_tpu_torch asm --device cuda --threads 1`'s
   entry point. The kernel's launch counts are set to 0 just before and
   read just after; the run must have launched the kernel once per tile
   batch, ported read selection must have run as port:cuda, and the output
   must be one circular contig within 2 kb of 4 Mb. Prints stage walls;
5. reference: the JAX package's read selection, host-only and with jax
   imports blocked, on the same reads, in a subprocess; read_data_init.txt,
   read_stats.txt and read_data_corrected.txt must be byte-identical.

The line before the last is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}.
"""

import gzip
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

    t0 = time.perf_counter()
    path = build.build("sketch", ksketch._SOURCES)
    dt = time.perf_counter() - t0
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


def e2e_phase(work, dev, genome_len=GENOME_LEN, coverage=30):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import datagen
    from metamdbg_tpu_torch.__main__ import main
    from metamdbg_tpu_torch.kernels import sketch as ksketch
    from metamdbg_tpu_torch.sketch import batch

    fq = os.path.join(work, "reads.fastq.gz")
    t0 = time.perf_counter()
    datagen.make_test_fastq(fq, genome_len=genome_len, coverage=coverage,
                            mean_length=12000, error_rate=0.002, seed=1)
    print(f"e2e: generated {genome_len} bp x {coverage}x HiFi reads in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(fq) / 1e6:.1f} MB gz)")

    out = os.path.join(work, "port")
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    ksketch.reset_counts()
    batch.tile_batches = 0
    t0 = time.perf_counter()
    rc = main(["asm", "--out-dir", out, "--in-hifi", fq, "--device",
               dev.type, "--threads", "1"])
    wall = time.perf_counter() - t0
    launches = ksketch.launches
    relaunches = ksketch.overflow_launches
    tile_batches = batch.tile_batches
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
    if prov["stages"].get("readSelection") != f"port:{dev.type}":
        fail(f"readSelection ran as {prov['stages'].get('readSelection')}")

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
    return fq, out, launches, wall


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


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    kern = kernel_phase(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fq, out, launches, _ = e2e_phase(work, dev)
        reference_phase(work, fq, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    _, k_ms, p_ms = kern[0.005]
    print(json.dumps({"kernels": [{
        "name": "sketch_tiles", "route": "cuda",
        "source": "metamdbg_tpu_torch/csrc/sketch.cu",
        "replaces": "metamdbg_tpu/kernels/sketch_pallas.py:49",
        "launches": launches, "max_abs_err": max(e for e, _, _ in
                                                  kern.values()),
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
