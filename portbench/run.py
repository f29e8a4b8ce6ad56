"""One run of one cell: `python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout.

Set-up: the cell's file (`portbench/workloads/<cell>.json`) names its
configuration (`portbench/configs/<name>.json`), its stage
(`portbench/stages/<stage>.py`), its traffic and its spans. The units'
inputs are made from the seed (cached under `portbench/data/`, keyed by
cell, configuration and seed), then one small warm-up unit runs outside
the window.

The window: turns of all the units made, each turn in the seed's order,
run back to back from the first unit's start, in fresh directories;
once `--seconds` have passed, the turn in progress finishes and the
window ends at its end, so every seed's window holds whole turns of the
same set of units. Of the end-to-end metrics that `BENCHMARK.json` names
for the cell: `Mbp_per_s` is every window unit's input bases over the
window's time; `peak_rss_gb` the highest VmRSS that a thread of this
process reads every 10 ms over the window alone. With
`--trace 1` the window runs under torch.profiler with the cell's spans
installed, and the per-layer metrics named for the cell in
`BENCHMARK.json` are read by their readers (`portbench/metrics/`).

After the window, the outputs of a sample of the window's units, drawn
from the seed, are compared with the reference's (`portbench/reference/`,
a copy of the JAX package's host route), run on the CPU in a process of
its own on the same inputs. The last line on standard output is
one JSON object; the numbers compared, with their limits, are the last
lines on standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
REFUSED = ("jax", "jaxlib", "flax", "metamdbg_tpu")
# seeds whose data a checkout keeps per cell (a check's second set of runs
# repeats the first set's seeds)
KEEP_SEEDS = 8


class NoResult(Exception):
    """A run that may print no result: the reason goes to standard error
    and the exit code is not 0."""


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def refused_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in REFUSED)


class RssSampler:
    """The highest VmRSS of this process, read every `interval` seconds by
    a thread between start() and stop()."""

    def __init__(self, interval: float = 0.01):
        self.interval = interval
        self.peak_kb = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="portbench-rss")

    @staticmethod
    def read_kb() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
        return 0

    def _run(self):
        while not self._stop.is_set():
            self.peak_kb = max(self.peak_kb, self.read_kb())
            self._stop.wait(self.interval)

    def start(self):
        self.peak_kb = self.read_kb()
        self._thread.start()

    def stop(self) -> float:
        """The peak in GB (kB / 2**20, as the port's `peak_rss_gb`)."""
        self._stop.set()
        self._thread.join()
        self.peak_kb = max(self.peak_kb, self.read_kb())
        return self.peak_kb / 1048576.0


class Context:
    """What a stage's functions get: the configuration and cell, the seed,
    where data and work go, and the device."""

    def __init__(self, cell_name, cell, cfg, seed, device, data_root,
                 work_root):
        self.cell_name = cell_name
        self.cell = cell
        self.cfg = cfg
        self.seed = seed
        self.device = device
        self.data_root = data_root
        self.work_root = work_root


def prune_data(cell_dir: str, keep: str):
    """Keep the `KEEP_SEEDS` seeds used last under `cell_dir`."""
    if not os.path.isdir(cell_dir):
        return
    dirs = sorted((os.path.getmtime(os.path.join(cell_dir, d)), d)
                  for d in os.listdir(cell_dir) if d != keep)
    for _, d in dirs[:max(0, len(dirs) - KEEP_SEEDS + 1)]:
        shutil.rmtree(os.path.join(cell_dir, d), ignore_errors=True)


def window(ctx, stage, units, seconds: float, traced: bool):
    """Runs turns of all `units`, in their order, back to back until
    `seconds` have passed and the turn in progress has ended, so that a
    window holds the same work for every seed. Returns (ran, t0, t1): ran
    holds (unit, work, error) of every unit started, in order."""
    from torch.profiler import record_function

    from . import trace

    def annotate(name):
        return record_function(name) if traced else contextlib.nullcontext()

    ran = []
    with annotate(trace.WINDOW):
        t0 = time.perf_counter()
        turn = 0
        while True:
            for unit in units:
                unit = dict(unit, turn=turn)
                work = os.path.join(ctx.work_root, f"{unit['name']}_{turn}")
                try:
                    t = time.perf_counter()
                    with annotate(trace.UNIT):
                        stage.run_unit(ctx, unit, work)
                    unit["seconds"] = time.perf_counter() - t
                    ran.append((unit, work, None))
                except Exception as exc:  # noqa: BLE001  counted as failed
                    ran.append((unit, work, f"{type(exc).__name__}: {exc}"))
            if time.perf_counter() - t0 >= seconds:
                if ctx.device.type == "cuda":
                    import torch
                    torch.cuda.synchronize()
                return ran, t0, time.perf_counter()
            turn += 1


def check_outputs(ctx, stage, ran):
    """(units checked, outputs compared, mismatches): a sample of the
    window's finished units, `check_units` of them drawn from the seed,
    against the reference."""
    from . import gen
    from .stages import check

    done = [(u, w) for u, w, err in ran if err is None]
    if not done:
        return 0, 0, ["no unit finished"]
    rng = gen.rng_for(ctx.seed, 7)
    n = min(ctx.cell["check_units"], len(done))
    picked = [done[i] for i in
              sorted(rng.choice(len(done), size=n, replace=False).tolist())]
    compared, bad = check(ctx, stage, [u for u, _ in picked],
                          [w for _, w in picked])
    return n, compared, bad


def layer_metrics(bench, cell_name) -> list:
    """The per-layer metrics `BENCHMARK.json` names for this cell."""
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def cell_spans(bench, cell_name, cell) -> list:
    """The spans of the cell's file, and those a reader of one of the
    cell's per-layer metrics declares (`SPANS`), each once."""
    specs = list(cell.get("spans", []))
    for m in layer_metrics(bench, cell_name):
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        specs += getattr(reader, "SPANS", [])
    out = []
    for spec in specs:
        if spec not in out:
            out.append(spec)
    return out


def read_layer_metrics(bench, cell_name, timeline, bases,
                       units) -> dict:
    """The per-layer metrics `BENCHMARK.json` names for this cell, each by
    its reader `portbench/metrics/<name>.py`; a reader that finds nothing
    to read gives None and the metric is left out."""
    from types import SimpleNamespace

    run = SimpleNamespace(timeline=timeline, bases=bases, units=units)
    out = {}
    for m in layer_metrics(bench, cell_name):
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell_name: str, seed: int, seconds: float, traced: bool,
            device_name: str = "cuda", cell=None, cfg=None, bench=None):
    """One run; returns (result, checks, notes). `cell`, `cfg` and `bench`
    replace the cell's file, its configuration and `BENCHMARK.json` (tests
    run small ones on the CPU)."""
    import torch

    from . import trace

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise NoResult(f"no workload {cell_name!r} in BENCHMARK.json")
    if cell is None:
        cell = load_json(HERE, "workloads", f"{cell_name}.json")
    if cfg is None:
        cfg = load_json(HERE, "configs", f"{entry['config']}.json")
    device = torch.device(device_name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise NoResult("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < entry["chips"]:
            raise NoResult(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {entry['chips']}")
    stage = importlib.import_module(f"portbench.stages.{cell['stage']}")
    from .stages import make_units, unit_key
    cell_data = os.path.join(HERE, "data", cell_name)
    key = f"{unit_key(cfg, cell)}_{seed}"
    prune_data(cell_data, key)
    ctx = Context(cell_name, cell, cfg, seed, device,
                  os.path.join(cell_data, key),
                  os.path.join(HERE, "work", cell_name))
    os.makedirs(ctx.data_root, exist_ok=True)
    os.utime(ctx.data_root)
    shutil.rmtree(ctx.work_root, ignore_errors=True)
    os.makedirs(ctx.work_root)

    # set-up: the program and its builds, the inputs, one warm-up unit
    import metamdbg_tpu_torch.pipeline  # noqa: F401  the system under test
    from metamdbg_tpu_torch.io import native
    native.build_all()
    warm, units = make_units(ctx)
    os.sync()  # the inputs' writes reach the disk before the window
    for unit in warm:
        stage.run_unit(ctx, dict(unit, turn=0),
                       os.path.join(ctx.work_root, f"warm_{unit['name']}"))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spans = trace.Spans(cell_spans(bench, cell_name, cell) if traced else [])
    spans.install()
    gc.collect()
    setup_s = time.perf_counter() - T_START

    rss = RssSampler()
    rss.start()
    cpu0 = time.process_time()
    try:
        with trace.profiled(traced) as prof:
            ran, t0, t1 = window(ctx, stage, units, seconds, traced)
    finally:
        peak_rss = rss.stop()
        spans.remove()
    cpu_s = time.process_time() - cpu0
    window_s = t1 - t0
    bases = sum(u["bases"] for u, _, _ in ran)
    failed = [(u["name"], err) for u, _, err in ran if err is not None]
    memory_peak = torch.cuda.max_memory_allocated() \
        if device.type == "cuda" else 0

    metrics_e2e = {"Mbp_per_s": bases / 1e6 / window_s,
                   "peak_rss_gb": peak_rss, "setup_s": setup_s}
    result = {"metrics": {}}
    device_doc = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(0)
                  if device.type == "cuda" else "cpu",
                  "count": entry["chips"],
                  "memory_peak_bytes": int(memory_peak)}
    if traced:
        timeline = trace.Timeline(prof)
        prof = None
        device_doc.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        result["metrics"] = read_layer_metrics(bench, cell_name, timeline,
                                               bases, len(ran))
        result["breakdown"] = timeline.breakdown()
        del timeline
    else:
        for m in bench["end_to_end"]:
            if cell_name in m.get("workloads", [cell_name]):
                result["metrics"][m["name"]] = {
                    "value": metrics_e2e[m["name"]], "unit": m["unit"]}

    n_checked, compared, notes = check_outputs(ctx, stage, ran)
    # each number is held at most at its limit
    checks = [("units_failed", len(failed), 0),
              ("units_unchecked", int(n_checked == 0), 0),
              ("mismatched_outputs", len(notes), 0)]
    correct = all(v <= limit for _, v, limit in checks)
    result = {"correct": correct, "attempted": len(ran),
              "failed": len(failed), **result, "device": device_doc,
              # the numbers compared, with their limits, come last
              "checks": {n: {"value": v, "limit": lim}
                         for n, v, lim in checks}}
    window_doc = {"units": len(ran), "seconds": window_s, "bases": bases,
                  "cpu_seconds": cpu_s,
                  "outputs_compared": compared,
                  "unit_seconds": [round(u.get("seconds", 0), 3)
                                   for u, _, _ in ran][:400],
                  "unit_strains": [u.get("strain") for u, _, _ in ran][:400]}
    shutil.rmtree(ctx.work_root, ignore_errors=True)
    notes = [("window", json.dumps(window_doc))] + failed[:5] + \
        [(n, "") for n in notes[:20]]
    return result, checks, notes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    import logging
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    try:
        result, checks, notes = measure(args.workload, args.seed,
                                        args.seconds, bool(args.trace))
    except NoResult as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    refused = refused_modules()
    if refused:
        print("portbench: modules of JAX or of the JAX package were loaded: "
              + ", ".join(refused), file=sys.stderr)
        return 3
    for name, note in notes:
        print(f"portbench: {name} {note}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
