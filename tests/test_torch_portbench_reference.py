"""The port against the benchmark's plain reference (`portbench/reference/`,
a copy of the JAX package's host route that imports neither JAX, torch
nor the port), byte for byte, on the CPU, on data from `portbench/gen.py`:
toBasespace on an ONT sample of the `ont_d6331` read model, through the
whole-contig refinement, and read selection on a HiFi and an ONT sample.

Each side runs as the benchmark's stages run it (`portbench/stages/`):
the port in this process, the reference in a process of its own.
"""

import json
import logging
import os
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metamdbg_tpu_torch.utils import spans
from portbench import gen, reference
from portbench.stages import (
    READ_FILE, digest_files, mismatches, readselection, run_reference,
    tobasespace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "portbench", "configs")
CPU = torch.device("cpu")
SEED = 2**33 + 22


def config(name: str, genome_mb: float, threads: int = 2) -> dict:
    """A configuration of the benchmark, its first strain's genome cut to
    `genome_mb` (here only), on `threads` threads."""
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["strains"][0]["genome_mb"] = genome_mb
    cfg["asm"]["threads"] = threads
    return cfg


def make_unit(tmp_path, stage, cfg: dict, mbp: float) -> dict:
    """A sample of the first strain's genome and `mbp` of its reads, with
    the stage's inputs made beside them, as the benchmark's set-up makes
    a unit."""
    d = str(tmp_path / "unit")
    os.makedirs(d)
    genome, bases = gen.write_sample(os.path.join(d, READ_FILE), cfg, SEED,
                                     0, 0, mbp)
    meta = stage.finish(cfg, {}, d, genome)
    return dict(meta, dir=d, name="unit", bases=bases)


def against_reference(tmp_path, stage_name: str, stage, cfg, unit,
                      run_port):
    """(the files the port wrote, the names that differ from the
    reference's on the same unit)."""
    ctx = SimpleNamespace(cfg=cfg, device=CPU, cell={"stage": stage_name},
                          work_root=str(tmp_path))
    port = str(tmp_path / "port")
    ref = str(tmp_path / "reference")
    run_port(ctx, unit, port)
    run_reference(ctx, [(unit, ref)])
    got, want = digest_files(port), digest_files(ref)
    assert stage.OUTPUT in want
    return got, mismatches(got, want)


@pytest.fixture(scope="module", autouse=True)
def reference_built():
    reference.build()


def test_ont_to_basespace_matches_the_reference_through_the_refinement(
        tmp_path, caplog):
    """One genome of `ont_d6331` cut to 200 kb, 0.6 Mbp of its reads (3x)
    at the configuration's read model: every file the port's toBasespace
    writes equals the reference's, and the ONT refinement re-polished
    changed contigs whole."""
    cfg = config("ont_d6331", 0.2)
    assert cfg["platform"] == "ont"
    unit = make_unit(tmp_path, tobasespace, cfg, 0.6)
    t0 = time.time_ns()

    def run_port(ctx, unit, work):
        with caplog.at_level(logging.INFO, logger="metamdbg_tpu_torch"):
            with profile(activities=[ProfilerActivity.CPU]):
                tobasespace.run_unit(ctx, unit, work)

    got, differ = against_reference(tmp_path, "tobasespace", tobasespace,
                                    cfg, unit, run_port)
    assert differ == []
    assert tobasespace.OUTPUT in got and len(got) >= 4
    logged = [m for m in caplog.messages if "Polish refinement" in m]
    refines = [r for r in spans.records() if r.start_ns >= t0
               and r.name == "polish" and r.counts.get("restricted")]
    assert logged and len(refines) == len(logged)
    for r in refines:
        assert r.counts["whole"] == 1
        assert r.counts["regions"] == r.counts["contigs"] >= 1
        assert r.counts["bases"] > 0


@pytest.mark.parametrize("name,genome_mb,mbp", [
    ("hifi_msa1003", 0.3, 1.5),
    ("ont_d6331", 0.3, 1.2),
])
def test_read_selection_matches_the_reference(tmp_path, name, genome_mb,
                                              mbp):
    """Every file the port's read selection writes equals the reference's:
    HiFi with homopolymer compression and the palindrome purge, ONT with
    the repetitive-minimizer pass at the correction density."""
    cfg = config(name, genome_mb)
    unit = make_unit(tmp_path, readselection, cfg, mbp)
    got, differ = against_reference(tmp_path, "readselection", readselection,
                                    cfg, unit, readselection.run_unit)
    assert differ == []
    hifi = cfg["platform"] == "hifi"
    assert ("read_data_corrected.txt" in got) == hifi
    assert os.path.getsize(os.path.join(
        tmp_path, "port", "repetitiveMinimizers.bin")) > 0 or hifi


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(CONFIGS) if f.endswith(".json")))
def test_a_configuration_s_abundances_make_its_whole_community(name):
    """A configuration's strains make up its whole community: their shares
    sum to 100% within the product sheet's rounding, each share is above
    0, and no strain is listed twice."""
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    shares = [s["abundance_pct"] for s in cfg["strains"]]
    assert sum(shares) == pytest.approx(100.0, abs=0.5)
    assert all(0 < p <= max(shares) for p in shares)
    assert len({s["name"] for s in cfg["strains"]}) == len(shares)
