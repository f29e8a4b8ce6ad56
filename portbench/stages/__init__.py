"""What the stages share: the asm flags of a configuration, the stage
parameters the asm would pass, the making of the samples, the reference's
runs beside the program's, and digests of what a unit wrote.

A stage module (`portbench/stages/<stage>.py`, named by a cell's `stage`)
has:
- `finish(cfg, cell, d, genome) -> meta`: a sample's minimizer-space
  files beside its reads, made by the reference's code in a worker
  process of the set-up;
- `run_unit(ctx, unit, work)`: the program on one unit, in `work`;
- `reference(cfg, unit, work)`: the reference on the same unit, in
  `work`, run by `portbench/refrun.py` in a process of its own;
- `OUTPUT`: the file that a unit has to write;
- `CONTROL_ENV`: the environment under which the reference, put in the
  program's place, breaks one guarantee of the configuration.
"""

import concurrent.futures
import gzip
import hashlib
import importlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys

import numpy as np

from .. import gen

READ_FILE = "reads.fastq.gz"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def asm_options(cfg: dict) -> dict:
    """The asm flags of a configuration, with metaMDBG's defaults
    (`metamdbg_tpu_torch/__main__.py`) for those it leaves out."""
    flags = {"minimizer_size": 15, "density_assembly": 0.005,
             "density_correction": 0.025, "min_contig_length": 50,
             "min_contig_coverage": 1.0, "max_bubble_length": 50000,
             "max_tip_length": 50000, "min_abundance": 0, "threads": 1}
    flags.update(cfg["asm"])
    return flags


def make_params(records, cfg: dict, k: int, prev_k: int, last_k: int,
                mean_read_length: int):
    """The stage parameters as `pipeline/asm.py:Pipeline.make_params`
    builds them, in `records.Parameters` of the side that takes them."""
    opt = asm_options(cfg)
    hifi = cfg["platform"] == "hifi"
    spacing = 1 / np.float32(opt["density_assembly"])
    return records.Parameters(
        minimizer_size=min(opt["minimizer_size"], 16), kminmer_size=k,
        density_assembly=opt["density_assembly"], kminmer_size_first=4,
        minimizer_spacing_mean=float(spacing),
        kminmer_length_mean=float(spacing * np.float32(k - 1)),
        kminmer_overlap_mean=float(spacing * np.float32(k - 1) - spacing),
        kminmer_size_prev=prev_k, kminmer_size_last=last_k,
        mean_read_length=mean_read_length,
        density_correction=opt["density_correction"],
        use_homopolymer_compression=hifi, data_type=0 if hifi else 1,
        snpmer_size=21)


def unit_key(cfg: dict, cell: dict) -> str:
    """What a unit's data depends on, as a short digest: the cache of a
    changed configuration or cell is another directory."""
    blob = json.dumps([cfg, cell], sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def unit_strains(cfg: dict, cell: dict) -> list:
    """Indexes of the strains whose genomes the units hold: those at or
    above the cell's `min_abundance_pct`."""
    least = cell["traffic"]["min_abundance_pct"]
    return [i for i, s in enumerate(cfg["strains"])
            if s["abundance_pct"] >= least]


def sample_specs(cfg: dict, cell: dict, seed: int) -> list:
    """[(name, index, strain, Mbp)]: the warm-up sample (the smallest of
    the unit strains, at `warm_mbp`, an index of its own) and the window's
    samples. Every seed makes the same set: each unit strain in turn, in
    an order drawn from the seed."""
    t = cell["traffic"]
    strains = unit_strains(cfg, cell)
    order = [strains[i] for i in
             gen.rng_for(seed, 5).permutation(len(strains))]
    smallest = min(strains, key=lambda i: cfg["strains"][i]["genome_mb"])
    return [("warm", 1 << 30, smallest, t["warm_mbp"])] + \
        [(f"unit{i}", i, order[i % len(order)], t["unit_mbp"])
         for i in range(t["units"])]


def make_units(ctx):
    """(the warm-up units, the window's units), each the meta of its
    sample with its `dir` and `name`. A sample that an earlier run of this
    seed left whole (`meta.json` is written last) is reused; the others
    are made by `portbench/make.py` in a process of its own, so that none
    of its memory, threads or allocator state is left in the process that
    measures."""
    specs = sample_specs(ctx.cfg, ctx.cell, ctx.seed)

    def meta_path(name):
        return os.path.join(ctx.data_root, name, "meta.json")

    missing = [s for s in specs if not os.path.exists(meta_path(s[0]))]
    if missing:
        job = os.path.join(ctx.data_root, "job.json")
        with open(job, "w") as f:
            json.dump({"stage": ctx.cell["stage"], "cell": ctx.cell,
                       "cfg": ctx.cfg, "seed": ctx.seed,
                       "data_root": ctx.data_root, "specs": missing}, f)
        subprocess.run([sys.executable, "-m", "portbench.make", job],
                       check=True, stdout=sys.stderr, cwd=ROOT)
    out = []
    for name, _, _, _ in specs:
        with open(meta_path(name)) as f:
            meta = json.load(f)
        meta.update(dir=os.path.join(ctx.data_root, name), name=name)
        out.append(meta)
    return out[:1], out[1:]


def make_sample(stage_name: str, cfg: dict, cell: dict, seed: int,
                data_root: str, spec) -> str:
    """One sample (a worker process of `portbench/make.py`): its reads,
    then the stage's minimizer-space files, then its `meta.json`."""
    name, index, strain, mbp = spec
    stage = importlib.import_module(f"portbench.stages.{stage_name}")
    d = os.path.join(data_root, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    genome, bases = gen.write_sample(os.path.join(d, READ_FILE), cfg, seed,
                                     index, strain, mbp)
    meta = stage.finish(cfg, cell, d, genome)
    meta.update(bases=bases, strain=cfg["strains"][strain]["name"],
                genome_bases=int(genome.shape[0]))
    path = os.path.join(d, "meta.json")
    with open(path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".tmp", path)
    return name


def make_missing(job: dict):
    """Makes the samples of `job` in worker processes (numpy and the
    reference's native engines, no card)."""
    from .. import reference

    reference.build()
    specs = [tuple(s) for s in job["specs"]]
    workers = max(1, min(len(specs), (os.cpu_count() or 2) - 2))
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(make_sample, job["stage"], job["cfg"],
                              job["cell"], job["seed"], job["data_root"], s)
                  for s in specs]:
            f.result()


def link_inputs(unit_dir: str, work: str, names):
    """A fresh work directory holding links to the unit's input files."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for n in names:
        os.symlink(os.path.join(unit_dir, n), os.path.join(work, n))


def digest_files(root: str) -> dict:
    """sha256 of every regular file under `root` that is not a link; a .gz
    file is digested decompressed (its header holds a time)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            if os.path.islink(p):
                continue
            opener = gzip.open if f.endswith(".gz") else open
            h = hashlib.sha256()
            with opener(p, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 22), b""):
                    h.update(block)
            out[os.path.relpath(p, root)] = h.hexdigest()
    return dict(sorted(out.items()))


def mismatches(got: dict, want: dict) -> list:
    """Names whose digests differ, or that one side lacks."""
    return sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))


def run_reference(ctx, runs, env=None):
    """The reference on each (unit, work directory) of `runs`, each by
    `portbench/refrun.py` in a process of its own (no card, no torch), all
    at once, with `env` added to their environment."""
    procs = []
    for i, (unit, work) in enumerate(runs):
        job = os.path.join(ctx.work_root, f"refrun{i}.json")
        with open(job, "w") as f:
            json.dump({"stage": ctx.cell["stage"], "cfg": ctx.cfg,
                       "unit": unit, "work": work}, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "portbench.refrun", job],
            stdout=sys.stderr, cwd=ROOT, env={**os.environ, **(env or {})}))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"the reference's runs exited {codes}")


def check(ctx, stage, units, works):
    """Every file that the program wrote for each unit against the
    reference's, run on the same inputs: (outputs compared, those that
    differ)."""
    refs = [w + ".reference" for w in works]
    run_reference(ctx, list(zip(units, refs)))
    compared, bad = 0, []
    for unit, work, ref in zip(units, works, refs):
        want = digest_files(ref)
        if stage.OUTPUT not in want:
            raise RuntimeError(f"the reference wrote no {stage.OUTPUT}")
        compared += len(want)
        bad += [f"{unit['name']}: {n}"
                for n in mismatches(digest_files(work), want)]
        shutil.rmtree(ref, ignore_errors=True)
    return compared, bad


def control(ctx, stage, units):
    """The reference in the program's place, with one stated guarantee
    broken (`stage.CONTROL_ENV`), on `units`: the work directories."""
    works = [os.path.join(ctx.work_root, u["name"] + ".control")
             for u in units]
    run_reference(ctx, list(zip(units, works)), stage.CONTROL_ENV)
    return works
