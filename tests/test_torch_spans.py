"""The port's spans (metamdbg_tpu_torch/utils/spans.py) on the CPU.

Outside a torch.profiler session a span keeps no record and still times
itself; inside one it records, in a thread_map worker too, with its
start on the profiler's clock; parent, root and counts hold under
thread_map at a switch every microsecond; the Chrome trace writer and
`asm --trace-out`; and toBasespace on a small sample: its span tree and
counts, the timing lines that read them, and the same contigs with
recording on and off.
"""

import gzip
import json
import logging
import os
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
from metamdbg_tpu_torch.basespace import reconstruct
from metamdbg_tpu_torch.constants import compute_last_k
from metamdbg_tpu_torch.io import records
from metamdbg_tpu_torch.pipeline import asm
from metamdbg_tpu_torch.sketch import read_selection
from metamdbg_tpu_torch.utils import spans, threadmap

CPU = torch.device("cpu")
NOREPEATS = "contig_data_init_small.txt.norepeats"


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
