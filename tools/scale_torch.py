"""Scale runs of the PyTorch/CUDA port (metamdbg_tpu_torch) beside the JAX
package (metamdbg_tpu), on the synthetic metagenomes of tools/scale_run.py
(~1.0 Gbp HiFi, ~0.5 Gbp ONT) and tools/scale10_run.py (~10.1 Gbp HiFi).

    python3 tools/scale_torch.py gen PRESET [--work DIR]
    python3 tools/scale_torch.py ours PRESET [--bounded] [--threads N]
    python3 tools/scale_torch.py ref PRESET [--bounded] [--threads N]
    python3 tools/scale_torch.py compare
    python3 tools/scale_torch.py report

PRESET is `hifi`, `ont` or `hifi10`; the common options --work (reads and
output dirs, default scratch/scale_torch, which .gitignore lists) and
--results (one JSON per run, default chiprun_out/scale_torch) apply to
every subcommand.

- `gen` writes DIR/PRESET_reads.fastq.gz (tests/datagen.py's
  metagenome_reads, each genome's reads made in a process of its own and
  written in genome order) and DIR/PRESET_genomes.npz, the truth genomes,
  and prints the sha256 of the decompressed reads, which does not depend on
  the zlib build. It does nothing where both exist.
- `ours` runs `python -m metamdbg_tpu_torch asm --device cuda` on them in a
  subprocess (the JAX package refused), `ref` runs `python -m metamdbg_tpu
  asm` host-only (JAX_PLATFORMS=cpu, METAMDBG_TPU_HOST_ONLY=1). `--bounded`
  sets BOUND_ENV, the forced memory bounds of tools/scale_run.py. Both keep
  tmp/ (METAMDBG_TPU_KEEP_TMP=1) and write RESULTS/TAG.json, TAG being
  PRESET[_bounded]_{ours,ref}: the asm wall (its process from start to
  exit), every stage's wall from tmp/memoryTrack.txt with the process's
  VmRSS sampled every 0.1 s by this process (its highest value in the stage
  and its value at the stage's end), the peak RSS, which bounded paths
  fired, the kernels' launches per stage, KW's per call site and the
  multiplex passes' phase walls summed (tmp/device.json), each pass's
  graph artifact digests as the pass ends, the sha256 of every file left in
  tmp/ and of the decompressed contigs.fasta.gz, the reads' sha256,
  os.cpu_count() and the card's nvidia-smi name and power limit. The
  contigs are kept as RESULTS/TAG.contigs.fasta.gz and the output dir is
  removed. `--probe-memory` adds to each stage-end snapshot the bytes
  that live Python objects hold, and samples the largest locals on the
  main thread's stack each time VmRSS grows by a quarter.
- `compare` holds every `ours` run against the `ref` run of the same preset
  and bounds, and each preset's bounded run against its natural one:
  every digest must be equal but tmp/input.txt's, which lists the reads'
  paths. Exits non-zero where one differs.
- `report` writes SCALE_torch.json at the root: every run without its
  per-file digests, the comparisons, and contig metrics against the truth
  genomes (tests/quality.py, as tools/scale_run.py:_metrics).
"""

import argparse
import concurrent.futures
import ctypes
import glob
import gzip
import hashlib
import inspect
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "scratch", "scale_torch")
RESULTS = os.path.join(ROOT, "chiprun_out", "scale_torch")
OUT_JSON = os.path.join(ROOT, "SCALE_torch.json")

# tools/scale_run.py:28-31: every bounded path forced on inputs this size
BOUND_ENV = {
    "METAMDBG_TPU_COUNT_TABLE_GB": "0.02",     # chunked first-pass counting
    "METAMDBG_TPU_CORRECTION_MEMORY_GB": "0.1",  # multi-partition correction
    "METAMDBG_TPU_MAX_PARTITION_GB": "0.5",    # multi-partition polishing
}

PRESETS = {
    # tools/scale_run.py:34-43: ~40 Mb of genomes x ~25x = ~1.0 Gbp HiFi
    "hifi": dict(sizes=[6_000_000, 5_000_000, 4_500_000, 4_000_000,
                        3_500_000, 3_000_000, 2_500_000, 2_500_000,
                        2_000_000, 2_000_000, 1_500_000, 1_500_000,
                        1_000_000, 1_000_000],
                 coverages=[25, 30, 20, 28, 35, 22, 40, 18, 25, 30, 45, 15,
                            50, 20],
                 error_rate=0.001, ins=0.0, dele=0.0, mean_q=30,
                 mean_len=10_000, flag="--in-hifi", seed=101),
    # tools/scale_run.py:44-51: ~20 Mb of genomes x ~25x = ~0.5 Gbp ONT
    "ont": dict(sizes=[5_000_000, 4_000_000, 3_500_000, 3_000_000,
                       2_500_000, 2_000_000],
                coverages=[25, 30, 22, 28, 35, 20],
                error_rate=0.01, ins=0.004, dele=0.004, mean_q=20,
                mean_len=8_000, flag="--in-ont", seed=201),
    # tools/scale10_run.py:33-42: 30 genomes, 361 Mbp, ~10.14 Gbp HiFi
    "hifi10": dict(sizes=[s * 1_000_000 for s in (
                       20, 18, 17, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12,
                       11, 11, 11, 10, 10, 10, 10, 9, 9, 9, 8, 8, 8, 7, 7,
                       6, 6)],
                   coverages=[26, 32, 23, 37, 30, 19, 42, 25, 34, 21, 48, 28,
                              16, 32, 23, 40, 30, 19, 36, 25, 44, 21, 32, 28,
                              38, 17, 47, 25, 34, 30],
                   error_rate=0.001, ins=0.0, dele=0.0, mean_q=30,
                   mean_len=10_000, flag="--in-hifi", seed=501),
}

# what the asm writes into tmp/ besides its artifacts
NOT_ARTIFACTS = ("memoryTrack.txt", "perf.txt", "device.json")
# digested but not compared: the reads' paths, which differ between
# machines
NOT_COMPARED = ("tmp/input.txt",)
# the stage groups of tools/scale_run.py:_stage_split
STAGE_GROUPS = (("readSelection", "readSelection"),
                ("readCorrection", "readCorrection"),
                ("toBasespace", "toBasespace"),
                ("derep", "postprocess"), ("remove", "postprocess"))
# the graph artifacts a pass leaves in tmp/ (chip_smoke.py:pass_digests)
GRAPH_ARTIFACTS = ("kminmerData_abundance.txt", "unitigGraph.nodes.bin",
                   "unitigGraph.edges.successors.bin",
                   "unitigGraph.nodes.abundances.bin",
                   "unitigGraph.stats.bin", "contigs.nodepath",
                   "unitigGraph.nodes.refined_abundances.bin")
KERNELS = ("sketch_kernel", "window_hash_kernel", "chain_kernel",
           "chain_dp_kernel", "row_count_k2")


def sha256_file(path, gunzip=False):
    h = hashlib.sha256()
    with (gzip.open if gunzip else open)(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


# -- gen ----------------------------------------------------------------------

def _paths(work, preset):
    return (os.path.join(work, f"{preset}_reads.fastq.gz"),
            os.path.join(work, f"{preset}_genomes.npz"),
            os.path.join(work, f"{preset}_reads.json"))


def genomes_of(preset):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import datagen

    cfg = PRESETS[preset]
    return datagen.make_metagenome(n_genomes=len(cfg["sizes"]),
                                   sizes=cfg["sizes"], seed=cfg["seed"])


def _sample_genome(cfg, gi, genome, path):
    """Genome gi's reads, as metagenome_reads makes them (seed + 1 + gi),
    into `path`: every read's sequence then its quality; returns the read
    lengths."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import datagen
    import numpy as np

    lengths = []
    with open(path, "wb") as f:
        for _, seq, qual in datagen.sample_reads(
                genome, cfg["coverages"][gi], cfg["mean_len"],
                cfg["error_rate"], seed=cfg["seed"] + 1 + gi,
                circular=True, mean_quality=cfg["mean_q"],
                ins_rate=cfg["ins"], del_rate=cfg["dele"]):
            f.write(seq.tobytes())
            f.write(qual.tobytes())
            lengths.append(seq.shape[0])
    return np.asarray(lengths, np.int64)


def gen(preset, work):
    import numpy as np

    fq, gnp, meta = _paths(work, preset)
    if all(os.path.exists(p) for p in (fq, gnp, meta)):
        doc = json.load(open(meta))
        print(f"[gen] {preset}: exists, reads sha256 {doc['sha256']}")
        return doc
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    genomes = genomes_of(preset)
    parts = [os.path.join(work, f"{preset}_part{gi:02d}.bin")
             for gi in range(len(genomes))]
    with concurrent.futures.ProcessPoolExecutor(
            min(len(genomes), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        lengths = list(pool.map(_sample_genome,
                                [PRESETS[preset]] * len(genomes),
                                range(len(genomes)), genomes, parts))
    t_sample = time.perf_counter() - t0
    h, rid, n_bases = hashlib.sha256(), 0, 0
    with gzip.open(fq + ".tmp", "wb", compresslevel=1) as out:
        for gi, (part, lens) in enumerate(zip(parts, lengths)):
            data = np.memmap(part, np.uint8, "r") if lens.size else b""
            pos = 0
            for n in lens.tolist():
                rec = b"".join((b"@g%d_%d\n" % (gi, rid),
                                data[pos:pos + n].tobytes(), b"\n+\n",
                                data[pos + n:pos + 2 * n].tobytes(), b"\n"))
                h.update(rec)
                out.write(rec)
                pos += 2 * n
                rid += 1
                n_bases += n
            del data
            os.remove(part)
    os.rename(fq + ".tmp", fq)
    np.savez_compressed(gnp, **{f"g{i:02d}": g for i, g in
                                enumerate(genomes)})
    doc = {"preset": preset, "sha256": h.hexdigest(), "reads": rid,
           "bases": n_bases, "gen_s": time.perf_counter() - t0,
           "sample_s": t_sample}
    with open(meta, "w") as f:
        json.dump(doc, f)
    print(f"[gen] {preset}: {rid} reads, {n_bases} bases in "
          f"{doc['gen_s']:.1f} s ({t_sample:.1f} s sampling); reads sha256 "
          f"{doc['sha256']}", flush=True)
    return doc


# -- ours / ref ---------------------------------------------------------------

def pass_digests(d, k, first_k, final):
    """sha256 of the graph artifacts a pass leaves in tmp dir `d`."""
    names = list(GRAPH_ARTIFACTS)
    names.append("contig_data_init.txt" if final else "unitig_data.txt")
    names.append(os.path.join("smallContigs", f"smallContigs_k{k}.bin"))
    if k <= first_k + 1:
        names.append("kminmerData_min.txt")
    names += sorted(os.path.relpath(p, d) for p in
                    glob.glob(os.path.join(d, "filter", "unitigs_*.bin")))
    return {name: sha256_file(os.path.join(d, name)) for name in names}


class _MallInfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def _malloc_gb():
    """glibc's malloc totals over all its arenas (mallinfo2): bytes taken
    from the system by sbrk and arenas, mmapped, in use, and free but kept;
    None where the C library has no mallinfo2."""
    fn = getattr(ctypes.CDLL(None), "mallinfo2", None)
    if fn is None:
        return None
    fn.restype = _MallInfo2
    mi = fn()
    return {"arenas": mi.arena / 2 ** 30, "mmapped": mi.hblkhd / 2 ** 30,
            "in_use": (mi.uordblks + mi.hblkhd) / 2 ** 30,
            "free_kept": mi.fordblks / 2 ** 30}


def _held_gb():
    """Bytes that live numpy arrays (their owning bases), torch CPU tensors
    (their storages) and bytes objects hold, found through the gc's
    containers; an array over a bytes object counts both."""
    import gc

    np, torch = sys.modules.get("numpy"), sys.modules.get("torch")
    seen, held = set(), {"numpy": 0, "torch_cpu": 0, "bytes": 0}
    for obj in gc.get_objects():
        for r in gc.get_referents(obj):
            if np is not None and isinstance(r, np.ndarray):
                while isinstance(r.base, np.ndarray):
                    r = r.base
                if id(r) not in seen:
                    seen.add(id(r))
                    held["numpy"] += r.nbytes
            elif torch is not None and isinstance(r, torch.Tensor) and \
                    r.device.type == "cpu":
                st = r.untyped_storage()
                if ("t", st.data_ptr()) not in seen:
                    seen.add(("t", st.data_ptr()))
                    held["torch_cpu"] += st.nbytes()
            elif isinstance(r, (bytes, bytearray)) and id(r) not in seen:
                seen.add(id(r))
                held["bytes"] += len(r)
    return {k: v / 2 ** 30 for k, v in held.items()}


def memory_snapshot(name, walk=False):
    """The process's memory as a stage ends: VmRSS, glibc's malloc totals,
    the card's bytes allocated and reserved by torch, and with `walk` the
    bytes that live Python objects hold (_held_gb)."""
    snap = {"stage": name, "vmrss_gb": _vmrss_kb(os.getpid()) / 2 ** 20,
            "malloc_gb": _malloc_gb()}
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        snap["cuda_allocated_gb"] = torch.cuda.memory_allocated() / 2 ** 30
        snap["cuda_reserved_gb"] = torch.cuda.memory_reserved() / 2 ** 30
    if walk:
        t0 = time.perf_counter()
        snap["held_gb"] = _held_gb()
        snap["walk_s"] = time.perf_counter() - t0
    return snap


def _nbytes(v, np, torch):
    if np is not None and isinstance(v, np.ndarray):
        return v.nbytes
    if torch is not None and isinstance(v, torch.Tensor) and \
            v.device.type == "cpu":
        return v.untyped_storage().nbytes()
    if isinstance(v, (bytes, bytearray)):
        return len(v)
    return 0


def _frame_holders(frame, top=12):
    """The largest locals of the functions on a thread's stack: numpy
    arrays, torch CPU tensors and bytes, each alone or inside a list, tuple
    or dict (its values); [(GB, "file:function:line variable")]. Reading a
    running function's f_locals fills a dict that keeps its values alive,
    so the dict is emptied after the read (nothing traces the process, so
    nothing writes it back)."""
    np, torch = sys.modules.get("numpy"), sys.modules.get("torch")
    found = []
    while frame is not None:
        code = frame.f_code
        if not code.co_flags & inspect.CO_OPTIMIZED:  # a module's namespace
            frame = frame.f_back
            continue
        where = (f"{os.path.basename(code.co_filename)}:{code.co_name}:"
                 f"{frame.f_lineno}")
        snapshot = frame.f_locals
        local_items = list(snapshot.items())
        snapshot.clear()
        for name, v in local_items:
            n = _nbytes(v, np, torch)
            if isinstance(v, (list, tuple)):
                n += sum(_nbytes(x, np, torch) for x in v)
            elif isinstance(v, dict):
                n += sum(_nbytes(x, np, torch) for x in list(v.values()))
            if n >= 1 << 24:
                found.append((n / 2 ** 30, f"{where} {name}"))
        frame = frame.f_back
    return sorted(found, reverse=True)[:top]


def _peak_sampler(peaks, stage_of, main_id, step=1.25, interval_s=0.2):
    """A daemon thread: each time VmRSS passes `step` times its value at
    the last sample it kept (and 1 GB), keeps the stage, VmRSS, glibc's
    totals and the largest locals on the main thread's stack."""
    import threading

    def run():
        last = 1 << 20
        while True:
            kb = _vmrss_kb(os.getpid())
            if kb > step * last:
                last = kb
                holders = _frame_holders(sys._current_frames().get(main_id))
                # no frame is kept: a frame keeps its locals alive
                peaks.append({"stage": stage_of[0], "vmrss_gb": kb / 2 ** 20,
                              "malloc_gb": _malloc_gb(),
                              "holders": holders})
            time.sleep(interval_s)

    threading.Thread(target=run, name="scale_torch_peaks",
                     daemon=True).start()


def child(package, record_path, walk, argv):
    """The asm process: `package`'s CLI with each pass's graph artifact
    digests recorded as the pass ends, and a memory_snapshot at the end of
    every stage but the ladder's (walk "1": with the Python objects' bytes,
    and the _peak_sampler's samples); all go into record_path at exit. The
    port's process refuses the JAX package."""
    import contextlib
    import importlib
    import importlib.abc

    if package == "metamdbg_tpu_torch":
        class _Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "metamdbg_tpu"):
                    raise ImportError(f"{name} is refused in the port's "
                                      f"process")
                return None
        sys.meta_path.insert(0, _Refuse())
    asm = importlib.import_module(f"{package}.pipeline.asm")
    digests, snapshot = {}, asm.Pipeline._save_pass_snapshot

    def record_pass(self, k):
        digests[str(k)] = pass_digests(self.tmp_dir, k, self.first_k,
                                       k == self.last_k)
        snapshot(self, k)

    memory, peaks, stage_of, stage = [], [], [""], asm.Pipeline._stage
    if walk == "1":
        import threading
        _peak_sampler(peaks, stage_of, threading.get_ident())

    @contextlib.contextmanager
    def probed_stage(self, name):
        stage_of[0] = name
        with stage(self, name):
            yield
        if not re.match(r"k\d+_", name):
            memory.append(memory_snapshot(name, walk == "1"))

    asm.Pipeline._save_pass_snapshot = record_pass
    asm.Pipeline._stage = probed_stage
    rc = importlib.import_module(f"{package}.__main__").main(argv)
    with open(record_path, "w") as f:
        json.dump({"passes": digests, "memory": memory, "peaks": peaks}, f)
    return rc


_LAUNCHER = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "import scale_torch; "
             "sys.exit(scale_torch.child(sys.argv[2], sys.argv[3], "
             "sys.argv[4], sys.argv[5:]))")


def _vmrss_kb(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def _track_lines(tmp):
    try:
        with open(os.path.join(tmp, "memoryTrack.txt")) as f:
            return [line.split() for line in f if line.strip()]
    except OSError:
        return []


def _watch(proc, tmp, interval_s=0.1):
    """Samples the asm process's VmRSS until it exits; returns one entry
    per tmp/memoryTrack.txt line: (the stage's highest sampled VmRSS, its
    VmRSS when the line appeared), in GB."""
    stages, hi, now = [], 0, 0
    while True:
        done = proc.poll() is not None
        now = _vmrss_kb(proc.pid) or now
        hi = max(hi, now)
        for _ in range(len(_track_lines(tmp)) - len(stages)):
            stages.append((hi / 2 ** 20, now / 2 ** 20))
            hi = now
        if done:
            return stages
        time.sleep(interval_s)


def bounded_evidence(text):
    """Which bounded paths fired, from the asm's log (the regexes of
    tools/scale_run.py:_bounded_evidence, and the count chunks)."""
    parts = re.findall(r"Processing partition (\d+)/(\d+)", text)
    corr = re.search(r"correction partitions: (\d+)", text)
    chunks = re.findall(r"bounded k-min-mer counting: (\d+) chunks", text)
    return {
        "counting_chunked": "bounded k-min-mer counting" in text,
        "count_chunks": [int(c) for c in chunks] or None,
        "correction_partitions": int(corr.group(1)) if corr else None,
        "polish_partitions": max((int(b) for _a, b in parts), default=1),
    }


def stage_split(names_walls):
    out = {}
    for name, wall in names_walls:
        key = next((g for p, g in STAGE_GROUPS if name.startswith(p)),
                   "graph")
        out[key] = out.get(key, 0.0) + wall
    return out


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def tmp_digests(tmp):
    """sha256 of every file the asm left in tmp/, by relative path; of a
    .gz file, of its decompressed bytes (its header holds a write time)."""
    out = {}
    for d, _, files in os.walk(tmp):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, tmp)
            if rel not in NOT_ARTIFACTS and not rel.startswith("checkpoints"):
                out[rel] = sha256_file(path, gunzip=name.endswith(".gz"))
    return dict(sorted(out.items()))


def run_asm(side, preset, bounded, threads, work, results, walk=False):
    reads = gen(preset, work)
    fq = _paths(work, preset)[0]
    tag = f"{preset}{'_bounded' if bounded else ''}_{side}"
    out = os.path.join(work, tag)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(results, exist_ok=True)
    env = dict(os.environ, METAMDBG_TPU_KEEP_TMP="1")
    for name in BOUND_ENV:
        env.pop(name, None)
    if bounded:
        env.update(BOUND_ENV)
    cli = ["asm", "--out-dir", out, PRESETS[preset]["flag"], fq,
           "--threads", str(threads)]
    if side == "ours":
        package = "metamdbg_tpu_torch"
        cli += ["--device", "cuda"]
    else:
        package = "metamdbg_tpu"
        env.update(JAX_PLATFORMS="cpu", METAMDBG_TPU_HOST_ONLY="1")
    record_path = os.path.join(work, f"{tag}.record.json")
    log_path = os.path.join(work, f"{tag}.log")
    smi = card()
    print(f"[{tag}] start: {package} {' '.join(cli)}; card {smi}; "
          f"cpu_count {os.cpu_count()}; loadavg {os.getloadavg()}",
          flush=True)
    t0 = time.perf_counter()
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-c", _LAUNCHER, os.path.dirname(__file__),
             package, record_path, "1" if walk else "0", *cli], cwd=ROOT,
            env=env, stdout=logf,
            stderr=subprocess.STDOUT)
        rss = _watch(proc, os.path.join(out, "tmp"))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f"[{tag}] asm exited {proc.returncode}:\n"
                 f"{open(log_path, errors='replace').read()[-6000:]}")
    tmp = os.path.join(out, "tmp")
    record = json.load(open(record_path))
    text = open(os.path.join(out, "metaMDBG.log"), errors="replace").read()
    stages = []
    for (name, dt, peak), (hi, end) in zip(_track_lines(tmp), rss):
        stages.append({"name": name, "wall_s": float(dt.rstrip("s")),
                       "peak_rss_gb": float(peak.rstrip("GB")),
                       "rss_max_gb": hi, "rss_end_gb": end})
    launches = by_site = phases = None
    if side == "ours":
        dev = json.load(open(os.path.join(tmp, "device.json")))
        launches = {k: dev[k]["by_stage"] for k in KERNELS}
        by_site = dev["window_hash_kernel"].get("by_site")
        phases = dev.get("multiplex_phase_seconds")
    doc = {
        "tag": tag, "package": package, "preset": preset,
        "bounded": bounded, "env": BOUND_ENV if bounded else {},
        "threads": threads, "cli": cli, "reads": reads,
        "cpu_count": os.cpu_count(), "card": smi,
        "asm_wall_s": wall,
        "stages": stages,
        "stage_split_s": stage_split((s["name"], s["wall_s"])
                                     for s in stages),
        "peak_rss_gb": max([s["peak_rss_gb"] for s in stages] +
                           [s["rss_max_gb"] for s in stages]),
        "bounded_paths": bounded_evidence(text),
        "launches_by_stage": launches,
        "window_hash_by_site": by_site,
        "multiplex_phase_seconds": phases,
        "timing": [line.split(" INFO ", 1)[-1].strip()
                   for line in text.splitlines()
                   if re.search(r"timing|tiling: |partitions: |checksum",
                                line, re.I)],
        "contigs_sha256": sha256_file(os.path.join(out, "contigs.fasta.gz"),
                                      gunzip=True),
        "memory": record["memory"], "peaks": record["peaks"],
        "pass_digests": record["passes"],
        "tmp_digests": tmp_digests(tmp),
    }
    with open(os.path.join(results, f"{tag}.json"), "w") as f:
        json.dump(doc, f, indent=1)
    shutil.copyfile(os.path.join(out, "contigs.fasta.gz"),
                    os.path.join(results, f"{tag}.contigs.fasta.gz"))
    shutil.rmtree(out, ignore_errors=True)
    for s in stages:
        print(f"[{tag}] stage {s['name']}: {s['wall_s']:.2f} s, RSS max "
              f"{s['rss_max_gb']:.3f} GB, at end {s['rss_end_gb']:.3f} GB")
    print(f"[{tag}] asm wall {wall:.1f} s; split "
          f"{json.dumps(doc['stage_split_s'])}; peak RSS "
          f"{doc['peak_rss_gb']:.3f} GB; bounded "
          f"{json.dumps(doc['bounded_paths'])}; launches "
          f"{json.dumps(launches)}; window hash launches by call site "
          f"{json.dumps(by_site)}; multiplex phases summed (s) "
          f"{json.dumps(phases)}; contigs sha256 {doc['contigs_sha256']}",
          flush=True)
    return doc


# -- compare / report ---------------------------------------------------------

def _load(results):
    runs = {}
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        doc = json.load(open(path))
        if isinstance(doc, dict) and "tag" in doc:
            runs[doc["tag"]] = doc
    return runs


def compare_pair(a, b):
    """Equal and differing digests of two runs: every pass's graph
    artifacts, every tmp/ file both left, the decompressed contigs."""
    mine = {f"pass_k{k}/{n}": v for k, d in a["pass_digests"].items()
            for n, v in d.items()}
    theirs = {f"pass_k{k}/{n}": v for k, d in b["pass_digests"].items()
              for n, v in d.items()}
    mine.update({f"tmp/{n}": v for n, v in a["tmp_digests"].items()})
    theirs.update({f"tmp/{n}": v for n, v in b["tmp_digests"].items()})
    mine["contigs.fasta (decompressed)"] = a["contigs_sha256"]
    theirs["contigs.fasta (decompressed)"] = b["contigs_sha256"]
    both = sorted((set(mine) & set(theirs)) - set(NOT_COMPARED))
    return {"reads_equal": a["reads"]["sha256"] == b["reads"]["sha256"],
            "equal": sum(mine[n] == theirs[n] for n in both),
            "differ": [n for n in both if mine[n] != theirs[n]],
            "only_" + a["tag"]: sorted(set(mine) - set(theirs)),
            "only_" + b["tag"]: sorted(set(theirs) - set(mine))}


def comparisons(runs):
    pairs = []
    for tag in runs:
        if tag.endswith("_ours"):
            pairs.append((tag, tag[:-5] + "_ref"))
        if "_bounded_" in tag:
            pairs.append((tag, tag.replace("_bounded", "")))
    out = {}
    for a, b in pairs:
        if b in runs:
            out[f"{a} vs {b}"] = compare_pair(runs[a], runs[b])
    return out


def compare(results):
    out = comparisons(_load(results))
    bad = False
    for name, c in out.items():
        ok = c["reads_equal"] and not c["differ"]
        bad |= not ok
        print(f"{name}: {'IDENTICAL' if ok else 'DIFFERENT'}; reads equal "
              f"{c['reads_equal']}; {c['equal']} digests equal, differing "
              f"{c['differ'][:20]}; "
              + "; ".join(f"{k} {len(v)}" for k, v in c.items()
                          if k.startswith("only_")))
    if not out:
        print("no pair of runs to compare")
    return 1 if bad or not out else 0


def report(results, out_json):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import quality

    runs = _load(results)
    genomes = {}
    doc = {"note": ("tools/scale_torch.py: `ours` on the card (--device "
                    "cuda), `ref` the JAX package host-only; asm walls are "
                    "the asm process's from start to exit; rss_max_gb / "
                    "rss_end_gb are the process's VmRSS sampled every 0.1 s "
                    "by the tool; peak_rss_gb also takes tmp/memoryTrack.txt"
                    "'s own peak"),
           "runs": {}, "comparisons": comparisons(runs)}
    for tag, run in runs.items():
        run = {k: v for k, v in run.items()
               if k not in ("pass_digests", "tmp_digests")}
        run["artifacts_digested"] = (
            sum(len(d) for d in runs[tag]["pass_digests"].values()),
            len(runs[tag]["tmp_digests"]))
        contigs = os.path.join(results, f"{tag}.contigs.fasta.gz")
        if os.path.exists(contigs):
            preset = run["preset"]
            if preset not in genomes:
                genomes[preset] = genomes_of(preset)
            run["metrics"] = quality.assembly_metrics(
                quality.load_fasta_gz(contigs), genomes[preset])
        doc["runs"][tag] = run
    with open(out_json, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out_json}: runs {sorted(doc['runs'])}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", choices=("gen", "ours", "ref", "compare",
                                        "report"))
    ap.add_argument("preset", nargs="?", choices=sorted(PRESETS))
    ap.add_argument("--bounded", action="store_true")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--work", default=WORK)
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--probe-memory", action="store_true")
    args = ap.parse_args(argv)
    if args.command in ("gen", "ours", "ref") and args.preset is None:
        ap.error(f"{args.command} needs a PRESET")
    if args.command == "gen":
        gen(args.preset, args.work)
        return 0
    if args.command in ("ours", "ref"):
        if args.command == "ours":
            import torch
            if not torch.cuda.is_available():
                sys.exit("no CUDA GPU: `ours` runs the port on the card")
        run_asm(args.command, args.preset, args.bounded, args.threads,
                args.work, args.results, args.probe_memory)
        return 0
    if args.command == "compare":
        return compare(args.results)
    return report(args.results, OUT_JSON)


if __name__ == "__main__":
    sys.exit(main())
