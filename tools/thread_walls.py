"""Walls of the port's HiFi `asm` at several `--threads`, on the GPU.

    python3 tools/thread_walls.py [--genome-len 4000000] [--runs 1,8,8,1]
        [--out DIR]

Makes chip_smoke.py's phase 4 reads (a circular genome at 30x HiFi,
tests/datagen.py, seed 1), then runs `python -m metamdbg_tpu_torch asm
--device cuda --threads N` on them once per entry N of --runs, one after
the other, each in its own process with the JAX package refused. Every
run's decompressed contigs.fasta.gz must equal the first run's.

Prints per run: the asm wall, the stage walls, the process's own peak RSS
after each stage where it rose (tmp/memoryTrack.txt), and the tiling,
polish pass and correction timing lines of metaMDBG.log; before the runs,
the card's nvidia-smi name and power limit, os.cpu_count() and
os.getloadavg(); last, one JSON line of every run's numbers, also written
to DIR/thread_walls.json. Exits non-zero without a GPU.
"""

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LAUNCHER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "metamdbg_tpu"):
            raise ImportError(name + " is refused here")
        return None
sys.meta_path.insert(0, _Block())
from metamdbg_tpu_torch.__main__ import main
sys.exit(main(sys.argv[1:]))
"""


def run(cs, work, fq, threads):
    out = os.path.join(work, f"out_{threads}_{time.monotonic_ns()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCHER, "asm", "--out-dir", out,
         "--in-hifi", fq, "--device", "cuda", "--threads", str(threads)],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f"--threads {threads}: asm exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
    walls, rss = cs._stage_walls(out)
    with open(os.path.join(out, "contigs.fasta.gz"), "rb") as f:
        contigs = gzip.decompress(f.read())
    return contigs, {"threads": threads, "asm_wall_s": wall,
                     "stage_walls_s": walls, "peak_rss": rss,
                     "rss_rises": cs._rss_rises(out),
                     "timing": cs._timing_lines(out)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-len", type=int, default=4_000_000)
    ap.add_argument("--runs", default="1,8,8,1")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA GPU: these walls are the card's machine's")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; cpu_count {os.cpu_count()}; loadavg "
          f"{os.getloadavg()}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="thread_walls_") as work:
        fq = os.path.join(work, "hifi.fastq.gz")
        t0 = time.perf_counter()
        cs.write_reads(fq, "hifi", args.genome_len)
        print(f"reads: {time.perf_counter() - t0:.1f} s", flush=True)
        results, first = [], None
        for threads in map(int, args.runs.split(",")):
            print(f"--threads {threads}: start, loadavg {os.getloadavg()}",
                  flush=True)
            contigs, res = run(cs, work, fq, threads)
            if first is None:
                first = contigs
            elif contigs != first:
                sys.exit(f"--threads {threads}: contigs differ from the "
                         f"first run's")
            for name, dt in res["stage_walls_s"].items():
                print(f"--threads {threads} stage {name}: {dt:.2f} s")
            for line in res["timing"]:
                print(f"--threads {threads} log: {line}")
            print(f"--threads {threads}: asm wall {res['asm_wall_s']:.1f} s, "
                  f"peak RSS {res['peak_rss']} (rose at "
                  f"{res['rss_rises']}); contigs identical to the first "
                  f"run's", flush=True)
            results.append(res)
    doc = {"card": smi.strip(), "cpu_count": os.cpu_count(),
           "runs": results}
    with open(os.path.join(args.out, "thread_walls.json"), "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
