"""The port's spans (metamdbg_tpu_torch/utils/spans.py) on the CPU.

Outside a torch.profiler session a span keeps no record and still times
itself; inside one it records, in a thread_map worker too, with its
start on the profiler's clock; parent, root and counts hold under
thread_map at a switch every microsecond; the Chrome trace writer and
`asm --trace-out`; toBasespace on a small sample: its span tree and
counts, the timing lines that read them, and the same contigs with
recording on and off; read selection's spans, its K1 launches' counts
and the fastq decode's seconds, HiFi and ONT; and the refinement's
counts on an ONT sample against its log line.
"""

import gzip
import json
import logging
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu_torch.__main__ import main as port_main
from metamdbg_tpu_torch.kernels import sketch as ksketch
from metamdbg_tpu_torch.basespace import reconstruct
from metamdbg_tpu_torch.constants import compute_last_k
from metamdbg_tpu_torch.io import records
from metamdbg_tpu_torch.pipeline import asm
from metamdbg_tpu_torch.sketch import read_selection
from metamdbg_tpu_torch.sketch.batch import TILE_LEN
from metamdbg_tpu_torch.utils import spans, threadmap
from portbench import gen

CPU = torch.device("cpu")
NOREPEATS = "contig_data_init_small.txt.norepeats"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def recording_session():
    return profile(activities=[ProfilerActivity.CPU])


def recorded_since(t0_ns: int, prefix: str = "") -> list:
    return [r for r in spans.records()
            if r.start_ns >= t0_ns and r.name.startswith(prefix)]


def test_a_span_outside_a_profiler_session_keeps_no_record_but_times():
    assert not spans.recording()
    n0 = len(spans.records())
    with spans.span("t.off") as s:
        time.sleep(0.02)
        s.add("n", 5)
        with spans.timed("t_s"):
            time.sleep(0.01)
    assert 0.03 <= s.seconds < 5
    assert len(spans.records()) == n0
    # counts are added while recording only; timed seconds always
    assert "n" not in s.counts
    assert 0.01 <= s.counts["t_s"] <= s.seconds


def test_a_profiler_session_records_also_in_a_thread_map_worker():
    t0 = time.time_ns()
    main = threading.get_ident()

    def work(i):
        with spans.span("t.item") as s:
            s.add("items")
        return threading.get_ident()

    with recording_session():
        assert spans.recording()
        with spans.span("t.outer") as outer:
            idents = threadmap.thread_map(work, range(64), 4)
    assert not spans.recording()
    items = recorded_since(t0, "t.item")
    assert len(items) == 64
    assert {r.thread for r in items} == set(idents)
    assert any(r.thread != main for r in items)
    assert all(r.parent == outer.id and r.root == outer.id for r in items)
    assert all(r.counts["items"] == 1 for r in items)
    (rec,) = recorded_since(t0, "t.outer")
    assert rec is outer and rec.rss_kb[0] > 0 and rec.rss_kb[1] > 0
    assert outer.counts["t.item"] == pytest.approx(
        sum(r.seconds for r in items))


def test_a_span_starts_on_the_profilers_clock():
    with recording_session() as prof:
        with record_function("t.warm"):
            pass
        with record_function("t.clock"):
            with spans.span("t.clock") as s:
                pass
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "t.clock"]
    assert abs(s.start_ns - event.start_ns()) < 1_000_000


def test_links_and_counts_hold_under_fast_switching():
    """More workers than cores and a switch every microsecond: every
    worker span's parent and root are the span that started the map, and
    no count added to it from the workers is lost."""
    n = 4000
    t0 = time.time_ns()

    def work(i):
        with spans.span("t.stress.item") as s:
            s.add("items")
            with spans.span("t.stress.leaf") as leaf:
                leaf.add("leaves")
        spans.add("done")
        with threadmap.packing("stress"):
            pass
        return i

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording_session():
            with spans.span("t.stress") as root:
                out = threadmap.thread_map(work, range(n),
                                           4 * (os.cpu_count() or 1))
    finally:
        sys.setswitchinterval(interval)
    assert out == list(range(n))
    items = recorded_since(t0, "t.stress.item")
    leaves = recorded_since(t0, "t.stress.leaf")
    assert len(items) == len(leaves) == n
    assert len({r.id for r in items + leaves}) == 2 * n
    item_ids = {r.id for r in items}
    assert all(r.parent == root.id and r.root == root.id for r in items)
    assert all(r.parent in item_ids and r.root == root.id for r in leaves)
    by_id = {r.id: r for r in items}
    assert all(by_id[r.parent].thread == r.thread for r in leaves)
    assert root.counts["done"] == n
    assert sum(r.counts["items"] for r in items) == n
    assert root.counts["t.stress.item"] == pytest.approx(
        sum(r.seconds for r in items))
    assert root.counts["pack.stress"] > 0


def test_the_chrome_trace_writer(tmp_path):
    t0 = time.time_ns()

    def work(i):
        with spans.span("t.trace.w"):
            pass

    with recording_session():
        with spans.span("t.trace") as outer:
            outer.add("windows", 7)
            threadmap.thread_map(work, range(4), 2)
    recs = recorded_since(t0, "t.trace")
    path = str(tmp_path / "trace.json")
    spans.write_chrome_trace(path, recs)
    doc = json.load(open(path))
    events = doc["traceEvents"]
    assert all(e["ph"] == "X" for e in events)
    assert len(events) == len(recs) == 5
    (top,) = [e for e in events if e["name"] == "t.trace"]
    assert top["args"]["windows"] == 7
    assert top["args"]["span_id"] == outer.id
    assert top["args"]["rss_kb_open"] > 0
    assert top["ts"] == pytest.approx(outer.start_ns / 1e3)
    assert top["dur"] == pytest.approx(outer.seconds * 1e6)
    for e in events:
        if e["name"] == "t.trace.w":
            assert e["args"]["parent"] == outer.id
            assert top["ts"] <= e["ts"] <= top["ts"] + top["dur"]
    assert {e["tid"] for e in events} == {r.thread for r in recs}


def test_asm_trace_out_records_the_whole_run(tmp_path, monkeypatch):
    class Stub:
        def __init__(self, *args, **kwargs):
            pass

        def run(self):
            with spans.span("asm"):
                with spans.span("stage.stub", rss=True) as s:
                    s.add("launches.stub", 3)

    monkeypatch.setattr(asm, "Pipeline", Stub)
    monkeypatch.setattr(spans, "_all", [False])
    reads = tmp_path / "reads.fastq"
    reads.write_text("")
    path = str(tmp_path / "asm_trace.json")
    assert port_main(["asm", "--out-dir", str(tmp_path / "out"),
                      "--in-hifi", str(reads), "--device", "cpu",
                      "--trace-out", path]) == 0
    assert spans.recording()
    events = json.load(open(path))["traceEvents"]
    (stage,) = [e for e in events if e["name"] == "stage.stub"]
    (top,) = [e for e in events if e["name"] == "asm"
              and e["args"]["span_id"] == stage["args"]["parent"]]
    assert stage["args"]["launches.stub"] == 3
    assert stage["args"]["rss_kb_close"] > 0
    assert top["args"]["root"] == top["args"]["span_id"]


# -- toBasespace on a small sample ---------------------------------------------

@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A 40 kb genome's HiFi reads and their read selection, the genome
    sketched like the reads as the minimizer-space contig, and the stage's
    parameters."""
    d = tmp_path_factory.mktemp("sample")
    fq = str(d / "reads.fastq.gz")
    genome = datagen.make_test_fastq(fq, genome_len=40_000, coverage=12,
                                     mean_length=5000, seed=17)
    g = d / "genome"
    g.mkdir()
    gfq = str(g / "genome.fastq.gz")
    datagen.write_fastq(gfq, [("genome", genome,
                               np.full(genome.shape, ord("I"), np.uint8))])
    base = records.Parameters(kminmer_size=4)
    stats = read_selection.run_read_selection([fq], str(d), base, "cpu",
                                              skip_correction=True)
    read_selection.run_read_selection([gfq], str(g), base, "cpu",
                                      skip_correction=True)
    with records.ReadDataWriter(str(d / NOREPEATS), with_quality=False) as w:
        for i, rec in enumerate(records.read_read_data(
                str(g / "read_data_init.txt"), with_quality=True)):
            w.write(records.MinimizerRead(i, rec.minimizers, None, None,
                                          None))
    k = compute_last_k(base.density_assembly, stats.n50, 4, 0)
    spacing = 1 / np.float32(base.density_assembly)
    params = records.Parameters(
        kminmer_size=k, minimizer_spacing_mean=float(spacing),
        kminmer_length_mean=float(spacing * np.float32(k - 1)),
        kminmer_overlap_mean=float(spacing * np.float32(k - 1) - spacing),
        kminmer_size_prev=k - 1, kminmer_size_last=k,
        mean_read_length=stats.n50)
    return fq, str(d), params


def _to_basespace(sample, work, traced: bool):
    fq, d, params = sample
    os.makedirs(work)
    for name in ("read_data_init.txt", NOREPEATS):
        os.symlink(os.path.join(d, name), os.path.join(work, name))
    out = os.path.join(work, "contigs.fasta.gz")
    with threadmap.stage_pool(2):
        if traced:
            with recording_session():
                reconstruct.run_to_basespace(work, [fq], out, params, CPU,
                                             n_threads=2)
        else:
            reconstruct.run_to_basespace(work, [fq], out, params, CPU,
                                         n_threads=2)
    with gzip.open(out, "rb") as f:
        return f.read()


def test_to_basespace_spans(sample, tmp_path, caplog):
    t0 = time.time_ns()
    with caplog.at_level(logging.INFO, logger="metamdbg_tpu_torch"):
        traced = _to_basespace(sample, str(tmp_path / "traced"), True)
    assert traced.count(b">") >= 1
    recs = recorded_since(t0)
    by_id = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.name == "tobasespace"]
    assert root.parent is None and root.root == root.id
    assert all(r.root == root.id for r in recs)
    assert root.counts["contigs"] == traced.count(b">")
    assert root.counts["partitions"] >= 1

    def names_under(parent):
        return {r.name for r in recs if r.parent == parent.id}

    assert names_under(root) == {
        "tobasespace.map", "tobasespace.partition", "tobasespace.load",
        "tobasespace.tile", "polish", "tobasespace.derep",
        "tobasespace.trim", "tobasespace.write"}
    for r in recs:
        if r.parent == root.id or r is root:
            assert r.rss_kb is not None and min(r.rss_kb) > 0
    (mapping,) = [r for r in recs if r.name == "tobasespace.map"]
    assert mapping.counts["reads"] > 0
    assert mapping.counts["groups"] > 0
    assert mapping.counts["anchors"] >= 2 * mapping.counts["groups"]

    tiles = [r for r in recs if r.name == "tiling"]
    assert tiles and all(by_id[r.parent].name == "tobasespace.tile"
                         for r in tiles)
    walks = [r for r in recs if r.name == "tiling.walk"]
    assert walks and all(by_id[r.parent].name == "tiling" for r in walks)
    walk = walks[0]
    assert walk.counts["pair_calls"] > walk.counts.get("pair_cache_hits", 0)
    assert 0 < walk.counts["successors_accepted"] <= walk.counts["pair_calls"]
    assert walk.counts["erroneous_calls"] > 0
    assert walk.counts["pair_s"] + walk.counts["erroneous_s"] < walk.seconds
    assert names_under(tiles[0]) == {"tiling.sketch", "tiling.walk",
                                     "tiling.contigs"}

    passes = [r for r in recs if r.name == "polish"]
    for p in passes:
        assert names_under(p) == {"polish.map", "polish.cut", "polish.index",
                                  "polish.poa", "polish.stitch"}
    (poa,) = [r for r in recs if r.name == "polish.poa"
              and r.parent == passes[0].id]
    assert poa.counts["windows"] > 0 and poa.counts["threads"] == 2
    assert 0 < poa.counts["pack.poa"] < poa.seconds

    # the timing lines read the spans: one a partition, one a pass
    port_log = [r.getMessage() for r in caplog.records
                if r.name == "metamdbg_tpu_torch"]
    assert sum(" tiling: " in m for m in port_log) == \
        root.counts["partitions"]
    assert sum("polish pass timing" in m for m in port_log) == len(passes)

    # recording changes no output
    assert _to_basespace(sample, str(tmp_path / "plain"), False) == traced


# -- read selection and the refinement ----------------------------------------

def ont_config(genome_mb: float) -> dict:
    """The benchmark's ONT configuration, its first genome cut to
    `genome_mb`."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "ont_d6331.json")) as f:
        cfg = json.load(f)
    cfg["strains"][0]["genome_mb"] = genome_mb
    return cfg


ONT_SELECTION = records.Parameters(kminmer_size=4,
                                   use_homopolymer_compression=False,
                                   data_type=1)


@pytest.fixture(scope="module")
def ont_sample(tmp_path_factory):
    """A 100 kb genome's reads at 4x under the `ont_d6331` read model
    (portbench/gen.py), their read selection without homopolymer
    compression, the genome sketched like the reads as the
    minimizer-space contig, and ONT parameters for toBasespace."""
    d = tmp_path_factory.mktemp("ont_sample")
    fq = str(d / "reads.fastq.gz")
    genome, _ = gen.write_sample(fq, ont_config(0.1), 2**35 + 3, 0, 0, 0.4)
    g = d / "genome"
    g.mkdir()
    gfq = str(g / "genome.fastq.gz")
    datagen.write_fastq(gfq, [("genome", genome,
                               np.full(genome.shape, ord("I"), np.uint8))])
    stats = read_selection.run_read_selection([fq], str(d), ONT_SELECTION,
                                              "cpu")
    read_selection.run_read_selection([gfq], str(g), ONT_SELECTION, "cpu",
                                      skip_correction=True)
    with records.ReadDataWriter(str(d / NOREPEATS), with_quality=False) as w:
        for i, rec in enumerate(records.read_read_data(
                str(g / "read_data_init.txt"), with_quality=True)):
            w.write(records.MinimizerRead(i, rec.minimizers, None, None,
                                          None))
    k = compute_last_k(ONT_SELECTION.density_assembly, stats.n50, 4, 0)
    spacing = 1 / np.float32(ONT_SELECTION.density_assembly)
    params = records.Parameters(
        kminmer_size=k, minimizer_spacing_mean=float(spacing),
        kminmer_length_mean=float(spacing * np.float32(k - 1)),
        kminmer_overlap_mean=float(spacing * np.float32(k - 1) - spacing),
        kminmer_size_prev=k - 1, kminmer_size_last=k,
        mean_read_length=stats.n50, use_homopolymer_compression=False,
        data_type=1)
    return fq, str(d), params


def _select(fq, out, params, traced, skip_correction):
    """The port's read selection of `fq` into `out`: (stats, the files'
    bytes)."""
    os.makedirs(out)
    if traced:
        with recording_session():
            stats = read_selection.run_read_selection(
                [fq], out, params, "cpu", skip_correction=skip_correction)
    else:
        stats = read_selection.run_read_selection(
            [fq], out, params, "cpu", skip_correction=skip_correction)
    return stats, {f: open(os.path.join(out, f), "rb").read()
                   for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("platform", ["hifi", "ont"])
def test_read_selection_spans(platform, sample, ont_sample, tmp_path):
    """The `readselection` root and its phases, its counts against the
    stage's own stats, each K1 launch's bound inputs on the span that
    launched it, and the decode's seconds on the span that read."""
    hifi = platform == "hifi"
    fq = (sample if hifi else ont_sample)[0]
    params = records.Parameters(kminmer_size=4) if hifi else ONT_SELECTION
    t0 = time.time_ns()
    stats, _ = _select(fq, str(tmp_path / "rs"), params, True, hifi)
    recs = recorded_since(t0)
    (root,) = [r for r in recs if r.name == "readselection"]
    assert root.parent is None and root.rss_kb[1] > 0
    assert {r.name for r in recs if r.parent == root.id} == {
        "readselection.repeats", "readselection.sketch",
        "readselection.filters", "readselection.write"} | (
            {"readselection.palindromes"} if hifi else set())
    assert all(r.root == root.id for r in recs)
    assert (root.counts["reads"], root.counts["bases"],
            root.counts["minimizers"]) == (stats.nb_reads, stats.nb_bases,
                                           stats.nb_minimizers)
    assert 0 < root.counts["decode"] < root.seconds
    sketches = [r for r in recs if r.name == "readselection.sketch"]
    assert sum(r.counts["reads"] for r in sketches) == stats.nb_reads
    (repeats,) = [r for r in recs if r.name == "readselection.repeats"]
    launched = sketches + ([] if hifi else [repeats])
    if hifi:
        # homopolymer compression on: no blacklist pass, no launch
        assert "k1_launches" not in repeats.counts
    else:
        assert 0 < repeats.counts["decode"] < repeats.seconds
    for r, density in zip(launched, [params.density_assembly] * len(
            sketches) + [params.density_correction]):
        c = r.counts
        n, nk = c["k1_launches"], TILE_LEN - params.minimizer_size + 1
        assert n >= 1 and c["k1_row_len"] == n * TILE_LEN
        assert c["k1_windows"] == c["k1_rows"] * nk
        assert c["k1_cap"] == n * ksketch.compact_cap(nk, density)


def test_the_refinement_counts_match_its_log_line(ont_sample, tmp_path,
                                                  caplog):
    """ONT: the refinement's `polish` span counts the contigs and regions
    its log line gives, re-polishes changed contigs whole (one region a
    contig, `whole` 1), and its bases are at most the bases its root
    counts as polished."""
    fq, d, params = ont_sample
    work = str(tmp_path / "tb")
    os.makedirs(work)
    for name in ("read_data_init.txt", NOREPEATS):
        os.symlink(os.path.join(d, name), os.path.join(work, name))
    t0 = time.time_ns()
    with caplog.at_level(logging.INFO, logger="metamdbg_tpu_torch"):
        with threadmap.stage_pool(2), recording_session():
            reconstruct.run_to_basespace(
                work, [fq], os.path.join(work, "contigs.fasta.gz"), params,
                CPU, n_threads=2)
    logged = [tuple(int(x) for x in re.findall(r"(\d+) (?:contigs|active)",
                                               m))
              for m in caplog.messages if "Polish refinement" in m]
    recs = recorded_since(t0)
    (root,) = [r for r in recs if r.name == "tobasespace"]
    refines = [r for r in recs if r.name == "polish"
               and r.counts.get("restricted")]
    assert logged and len(refines) == len(logged)
    for r, (contigs, regions) in zip(refines, logged):
        assert (r.counts["contigs"], r.counts["regions"]) == (contigs,
                                                              regions)
        assert r.counts["whole"] == 1 and regions == contigs
    assert 0 < sum(r.counts["bases"] for r in refines) \
        <= root.counts["polished_bases"]


def test_with_recording_off_read_selection_keeps_nothing(ont_sample,
                                                         tmp_path):
    """Outside a profiler session read selection keeps no record, and it
    writes the same files as with recording on."""
    fq = ont_sample[0]
    n0 = len(spans.records())
    plain = _select(fq, str(tmp_path / "plain"), ONT_SELECTION, False,
                    False)
    assert len(spans.records()) == n0
    traced = _select(fq, str(tmp_path / "traced"), ONT_SELECTION, True,
                     False)
    assert len(spans.records()) > n0
    assert plain[1] == traced[1] and plain[0] == traced[0]
