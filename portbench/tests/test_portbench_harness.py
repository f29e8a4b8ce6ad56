"""The benchmark harness on the CPU, at small sizes: the unit maker, the
window rule, the files found by name, the imports, the result line, and
the comparison that decides `correct` against its control and against
faults planted under the timed path.

Run from the repository's root: `python -m pytest -q portbench/tests`.
The test that needs the card decides in a fixture and skips here.
"""

import ast
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import control, gen, run, trace
from portbench.stages import digest_files, sample_specs, unit_strains

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = run.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
REFUSED = {"jax", "jaxlib", "flax", "metamdbg_tpu"}


def small(cell_name: str):
    """The cell and its configuration cut to a CPU test's size: genomes
    at 2% of their sizes, 4 kb reads, 1 Mbp units, 3 units, 2 threads."""
    cell = run.load_json(run.HERE, "workloads", f"{cell_name}.json")
    cfg = run.load_json(run.HERE, "configs", f"{cell['config']}.json")
    for s in cfg["strains"]:
        s["genome_mb"] *= 0.02
    cfg["reads"]["mean_len"] = 4000
    cfg["asm"]["threads"] = 2
    cell["traffic"].update(unit_mbp=1.0, units=3, warm_mbp=0.3)
    return cell, cfg


def measure_small(cell_name, seed=1234567890123, traced=False):
    cell, cfg = small(cell_name)
    return run.measure(cell_name, seed, 1.0, traced, "cpu", cell=cell,
                       cfg=cfg)


# -- the unit maker -----------------------------------------------------------

@pytest.mark.parametrize("cell_name", CELLS)
def test_units_are_the_same_for_a_seed_and_sized_as_asked(cell_name,
                                                          tmp_path):
    from portbench.stages import make_units

    cell, cfg = small(cell_name)
    digests = []
    for run_dir in ("a", "b"):
        ctx = run.Context(cell_name, cell, cfg, 2**40 + 7, torch.device("cpu"),
                          str(tmp_path / run_dir / "data"),
                          str(tmp_path / run_dir / "work"))
        os.makedirs(ctx.data_root)
        warm, units = make_units(ctx)
        digests.append({u["name"]: digest_files(u["dir"])
                        for u in warm + units})
        for u in units:
            want = cell["traffic"]["unit_mbp"] * 1e6
            # the reads reach the unit's bases, by at most one read more
            assert want <= u["bases"] <= want + 2 * cfg["reads"]["mean_len"]
    assert digests[0] == digests[1]
    assert len(digests[0]) == cell["traffic"]["units"] + 1


def test_every_seed_makes_the_same_set_of_units_in_another_order():
    cell, cfg = run.load_json(run.HERE, "workloads",
                              "hifi_msa1003.tobasespace.json"), \
        run.load_json(run.HERE, "configs", "hifi_msa1003.json")
    strains = unit_strains(cfg, cell)
    # the top two tiers: ten strains at 18% and 1.8%
    assert len(strains) == 10
    orders = [[s[2] for s in sample_specs(cfg, cell, seed)[1:]]
              for seed in (1, 2**31 + 11)]
    assert orders[0] != orders[1]
    for order in orders:
        assert sorted(order) == strains
    assert all(s[3] == cell["traffic"]["unit_mbp"]
               for s in sample_specs(cfg, cell, 1)[1:])


def test_another_seed_makes_another_genome_of_the_same_size():
    cfg = small("hifi_msa1003.tobasespace")[1]
    a = gen.genome(cfg["strains"][0], 500, 1, 0)
    b = gen.genome(cfg["strains"][0], 500, 2, 0)
    assert a.shape == b.shape == (int(round(cfg["strains"][0]["genome_mb"]
                                            * 1e6)),)
    assert not np.array_equal(a, b)


# -- the window rule ----------------------------------------------------------

class SleepStage:
    """Units that take `seconds` each."""

    def __init__(self, seconds):
        self.seconds = seconds

    def run_unit(self, ctx, unit, work):
        time.sleep(self.seconds)


def test_the_window_finishes_the_unit_in_progress():
    ctx = SimpleNamespace(work_root="/nonexistent", device=torch.device("cpu"))
    units = [dict(name=f"u{i}", bases=1000) for i in range(3)]
    ran, t0, t1 = run.window(ctx, SleepStage(0.2), units, 0.5, False)
    # 0.5 s pass during the third unit, which runs to its end, and with
    # it the turn; no unit starts after it
    assert [u["name"] for u, _, _ in ran] == ["u0", "u1", "u2"]
    assert t1 - t0 >= 0.6
    assert abs((t1 - t0) - sum(u["seconds"] for u, _, _ in ran)) < 0.05


def test_the_window_finishes_the_turn_in_progress():
    ctx = SimpleNamespace(work_root="/nonexistent", device=torch.device("cpu"))
    units = [dict(name=f"u{i}", bases=1000) for i in range(4)]
    ran, t0, t1 = run.window(ctx, SleepStage(0.1), units, 0.15, False)
    # 0.15 s pass during the second unit; the other two of the turn run
    # too, so that every window holds whole turns of the same units
    assert [u["name"] for u, _, _ in ran] == ["u0", "u1", "u2", "u3"]
    assert t1 - t0 >= 0.4


def test_the_window_runs_the_units_again_when_they_run_out():
    ctx = SimpleNamespace(work_root="/nonexistent", device=torch.device("cpu"))
    units = [dict(name="u0", bases=1000), dict(name="u1", bases=1000)]
    ran, t0, t1 = run.window(ctx, SleepStage(0.1), units, 0.35, False)
    assert [(u["name"], u["turn"]) for u, _, _ in ran] == [
        ("u0", 0), ("u1", 0), ("u0", 1), ("u1", 1)]


def test_the_rate_is_the_bases_of_whole_units_over_the_window():
    result, _, notes = measure_small("hifi_msa1003.tobasespace", traced=True)
    window = json.loads(dict(notes)["window"])
    rate = result["metrics"]["window_Mbp_per_s"]["value"]
    window_s = result["device"]["window_s"]
    assert rate == pytest.approx(window["bases"] / 1e6 / window_s)
    # the traced window is the units' window, whole turns of every unit
    assert window_s == pytest.approx(window["seconds"], rel=0.05)
    assert window["seconds"] >= 1.0
    assert len(window["unit_seconds"]) == result["attempted"]
    assert result["attempted"] % 3 == 0


# -- files found by name ------------------------------------------------------

@pytest.mark.parametrize("cell_name", CELLS)
def test_each_cell_finds_its_files_by_name(cell_name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    cell = run.load_json(run.HERE, "workloads", f"{cell_name}.json")
    assert cell["config"] == entry["config"]
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    cfg = run.load_json(ROOT, conf["file"])
    for key in conf["reduced"]:
        assert key in cfg
    stage = importlib.import_module(f"portbench.stages.{cell['stage']}")
    for fn in ("finish", "run_unit", "reference"):
        assert callable(getattr(stage, fn))
    assert stage.OUTPUT and stage.CONTROL_ENV
    for span in cell["spans"]:
        mod, attr = span["target"].split(":")
        assert callable(getattr(importlib.import_module(mod), attr))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_layer_metric_has_its_reader(metric):
    reader = importlib.import_module(f"portbench.metrics.{metric}")
    assert callable(reader.read)


# -- imports --------------------------------------------------------------------

def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    found = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module]
                found += [(path, n) for n in names
                          if n.split(".")[0] in REFUSED]
    assert found == []


def test_the_reference_imports_nothing_of_the_port_or_torch():
    found = []
    ref = os.path.join(ROOT, "portbench", "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        found += [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and not node.level:
                        found.append(node.module)
    assert not [n for n in found if n.split(".")[0] in
                REFUSED | {"torch", "metamdbg_tpu_torch", "portbench"}]


def test_a_run_refuses_a_loaded_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "metamdbg_tpu", object())
    assert run.refused_modules() == ["metamdbg_tpu"]
    monkeypatch.delitem(sys.modules, "metamdbg_tpu")
    monkeypatch.setitem(sys.modules, "metamdbg_tpu_torch_extra", object())
    assert run.refused_modules() == []


# -- the result line ----------------------------------------------------------

@pytest.mark.parametrize("traced", [False, True])
def test_the_result_has_the_keys_a_check_reads(traced):
    result, checks, _ = measure_small("hifi_msa1003.tobasespace",
                                      traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert set(result) == set(keys + (["breakdown"] if traced else []) +
                              ["checks"])
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    names = {m["name"] for m in BENCH["per_layer" if traced else "end_to_end"]
             if "hifi_msa1003.tobasespace" in m.get(
                 "workloads", ["hifi_msa1003.tobasespace"])}
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
    assert names <= set(result["metrics"])
    assert [c[0] for c in checks] == list(result["checks"])


def test_without_a_card_the_run_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "is_available" in proc.stderr


# -- what decides `correct` -----------------------------------------------------

@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name):
    cell, cfg = small(cell_name)
    got = control.control_run(cell_name, 99, cell=cell, cfg=cfg)
    assert got["mismatched_outputs"] > got["limit"]


@contextlib.contextmanager
def patched(target: str, make):
    """Replaces `module:attr` of the program by make(original)."""
    mod_name, attr = target.split(":")
    owner = importlib.import_module(mod_name)
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _unchanged(orig):
    return lambda *a, **k: None


def _half_alignments(orig):
    def run(*a, **k):
        return orig(*a, **k)[::2]
    return run


def _altered_fasta(orig):
    def run(path, records, *a, **k):
        records = list(records)
        if records:
            h, seq = records[0]
            seq = seq.encode() if isinstance(seq, str) else bytes(seq)
            records[0] = (h, (b"A" if seq[:1] != b"A" else b"C") + seq[1:])
        return orig(path, records, *a, **k)
    return run


PORT = "metamdbg_tpu_torch"
FAULTS = {
    # a step that returns its state unchanged
    "unchanged": (f"{PORT}.basespace.reconstruct:run_to_basespace",
                  _unchanged),
    # half of the batch left out
    "half": (f"{PORT}.basespace.reconstruct:map_reads_to_contigs",
             _half_alignments),
    # an answer altered where it is produced
    "altered": (f"{PORT}.io.fastq:write_fasta", _altered_fasta),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(fault):
    target, make = FAULTS[fault]
    with patched(target, make):
        result, checks, _ = measure_small("hifi_msa1003.tobasespace",
                                          seed=4242)
    assert result["correct"] is False
    assert any(v > limit for _, v, limit in checks)


def test_spans_wrap_and_unwrap_the_program():
    from metamdbg_tpu_torch.basespace import poa_native

    orig = poa_native.polish_windows
    spans = trace.Spans([{"name": "polish_poa",
                          "target": f"{PORT}.basespace.poa_native:"
                                    "polish_windows"}])
    spans.install()
    assert poa_native.polish_windows is not orig
    spans.remove()
    assert poa_native.polish_windows is orig


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell_name):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", cell_name,
         "--seed", str(2**33 + 5), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
