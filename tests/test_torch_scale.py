"""The port's bounded-memory paths all at once, against the JAX package, and
the scale tool tools/scale_torch.py.

HiFi and ONT `asm` on a 65 kb three-genome metagenome at uneven coverage
with the three variables of tools/scale_run.py's BOUND_ENV set together,
scaled down so that every path fires on this input: chunked first-pass
counting (METAMDBG_TPU_COUNT_TABLE_GB), several correction partitions
(METAMDBG_TPU_CORRECTION_MEMORY_GB, ONT) and several polish partitions
(METAMDBG_TPU_MAX_PARTITION_GB). The port runs with jax and the JAX package
refused (tests/test_torch_e2e.py's launcher) at --threads 2, beside the
JAX package's asm in this process under the same variables; every file
both leave in tmp/ and the contigs must be identical.
"""

import gzip
import hashlib
import json
import logging
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import datagen
import scale_torch
from metamdbg_tpu.__main__ import main as jax_main
from test_torch_e2e import JAX_AND_PACKAGE, _BLOCKED_LAUNCHER, \
    assert_same_contigs

SIZES = [30_000, 20_000, 15_000]
# the bounds of BOUND_ENV, scaled to this input so that each path cuts a
# few pieces
SMALL_BOUND_ENV = {
    "METAMDBG_TPU_COUNT_TABLE_GB": "0.00003",
    "METAMDBG_TPU_CORRECTION_MEMORY_GB": "0.0001",
    "METAMDBG_TPU_MAX_PARTITION_GB": "0.0005",
}


def _reads(path, platform):
    genomes = datagen.make_metagenome(n_genomes=3, sizes=SIZES,
                                      repeat_len=4000, seed=61)
    if platform == "hifi":
        reads = datagen.metagenome_reads(genomes, [12, 5, 20],
                                         mean_length=6000,
                                         error_rate=0.002, seed=62)
    else:
        reads = datagen.metagenome_reads(genomes, [6, 12, 9],
                                         mean_length=6000, error_rate=0.01,
                                         ins_rate=0.004, del_rate=0.004,
                                         mean_quality=20, seed=63)
    datagen.write_fastq(path, reads)


def _jax_asm(out, platform, fq, env, caplog):
    env = {**env, "METAMDBG_TPU_KEEP_TMP": "1",
           "METAMDBG_TPU_HOST_ONLY": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with caplog.at_level(logging.INFO, logger="metamdbg_tpu"):
            assert jax_main(["asm", "--out-dir", out, f"--in-{platform}",
                             fq]) in (0, None)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("platform", ["hifi", "ont"])
def test_bounded_asm_matches_jax_package(tmp_path, platform, caplog):
    fq = str(tmp_path / "reads.fastq.gz")
    _reads(fq, platform)
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    # the port's process runs beside the JAX package's asm in this one
    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_LAUNCHER, ",".join(JAX_AND_PACKAGE),
         "asm", "--out-dir", out, f"--in-{platform}", fq, "--device", "cpu",
         "--threads", "2"], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, METAMDBG_TPU_KEEP_TMP="1",
                 **SMALL_BOUND_ENV))
    try:
        _jax_asm(jout, platform, fq, SMALL_BOUND_ENV, caplog)
        err = proc.communicate(timeout=300)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]

    ev = scale_torch.bounded_evidence(
        open(os.path.join(out, "metaMDBG.log")).read())
    assert ev["counting_chunked"] and ev["count_chunks"][0] > 1, ev
    assert ev["polish_partitions"] > 1, ev
    if platform == "ont":
        assert ev["correction_partitions"] > 1, ev
    jev = scale_torch.bounded_evidence(caplog.text)
    assert (jev["counting_chunked"], jev["correction_partitions"],
            jev["polish_partitions"]) == \
        (True, ev["correction_partitions"], ev["polish_partitions"])

    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
    mine = scale_torch.tmp_digests(os.path.join(out, "tmp"))
    theirs = scale_torch.tmp_digests(os.path.join(jout, "tmp"))
    for name in ("read_data_init.txt", "kminmerData_abundance_init.txt",
                 "readsVsContigsAlignments.bin", "contig_data_final.bin"):
        assert name in mine, name
    assert sorted(mine) == sorted(theirs)
    assert [n for n in mine if mine[n] != theirs[n]] == [], \
        [n for n in mine if mine[n] != theirs[n]]


def test_presets_are_the_jax_tools():
    """The presets and BOUND_ENV are tools/scale_run.py's and
    tools/scale10_run.py's."""
    import scale10_run
    import scale_run

    assert scale_torch.BOUND_ENV == scale_run.BOUND_ENV
    for name in ("hifi", "ont"):
        assert scale_torch.PRESETS[name] == scale_run.DATASETS[name], name
    h10 = scale_torch.PRESETS["hifi10"]
    assert (h10["sizes"], h10["coverages"], h10["seed"], h10["mean_len"],
            h10["error_rate"]) == (scale10_run.SIZES, scale10_run.COVERAGES,
                                   scale10_run.SEED, scale10_run.MEAN_LEN,
                                   scale10_run.ERROR_RATE)


TINY = dict(sizes=[30_000, 20_000, 25_000], coverages=[3, 5, 2],
            error_rate=0.01, ins=0.004, dele=0.004, mean_q=20,
            mean_len=3000, flag="--in-ont", seed=7)


def test_gen_is_metagenome_reads(tmp_path, monkeypatch):
    """`gen` makes each genome's reads in its own process and writes them
    as datagen.metagenome_reads yields them; the sha256 is of the
    decompressed reads."""
    monkeypatch.setitem(scale_torch.PRESETS, "tiny", TINY)
    doc = scale_torch.gen("tiny", str(tmp_path))
    genomes = datagen.make_metagenome(n_genomes=3, sizes=TINY["sizes"],
                                      seed=7)
    h, n = hashlib.sha256(), 0
    for header, seq, qual in datagen.metagenome_reads(
            genomes, TINY["coverages"], mean_length=3000, error_rate=0.01,
            seed=8, ins_rate=0.004, del_rate=0.004, mean_quality=20):
        h.update(b"@%s\n%s\n+\n%s\n" % (header.encode(), seq.tobytes(),
                                        qual.tobytes()))
        n += 1
    fq, gnp, _ = scale_torch._paths(str(tmp_path), "tiny")
    assert doc["sha256"] == h.hexdigest() == \
        scale_torch.sha256_file(fq, gunzip=True)
    assert doc["reads"] == n
    saved = np.load(gnp)
    assert sorted(saved.files) == ["g00", "g01", "g02"]
    for i, g in enumerate(genomes):
        assert np.array_equal(saved[f"g{i:02d}"], g)
    # a second call finds the files
    assert scale_torch.gen("tiny", str(tmp_path)) == doc


def test_bounded_evidence_parses_a_log():
    log = "\n".join([
        "2026 INFO bounded k-min-mer counting: table budget 0.02 GB "
        "(167772 rows/chunk)",
        "2026 INFO bounded k-min-mer counting: 31 chunks",
        "2026 INFO correction partitions: 3 (max memory 0.13 GB)",
        "2026 INFO   Processing partition 0/2",
        "2026 INFO   Processing partition 1/2"])
    assert scale_torch.bounded_evidence(log) == {
        "counting_chunked": True, "count_chunks": [31],
        "correction_partitions": 3, "polish_partitions": 2}
    assert scale_torch.bounded_evidence("nothing bounded") == {
        "counting_chunked": False, "count_chunks": None,
        "correction_partitions": None, "polish_partitions": 1}


def _fake_run(results, tag, preset, contigs, digest="a"):
    fasta = b"".join(b">ctg%d\n%s\n" % (i, c.tobytes())
                     for i, c in enumerate(contigs))
    with gzip.open(os.path.join(results, f"{tag}.contigs.fasta.gz"),
                   "wb") as f:
        f.write(fasta)
    doc = {"tag": tag, "preset": preset, "reads": {"sha256": "r"},
           "asm_wall_s": 1.0, "contigs_sha256":
           hashlib.sha256(fasta).hexdigest(),
           "pass_digests": {"4": {"unitigGraph.nodes.bin": digest}},
           "tmp_digests": {"read_data_init.txt": "b"}}
    with open(os.path.join(results, f"{tag}.json"), "w") as f:
        json.dump(doc, f)


def test_report_and_compare(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(scale_torch.PRESETS, "tiny", TINY)
    genomes = scale_torch.genomes_of("tiny")
    results = str(tmp_path / "results")
    os.makedirs(results)
    for side in ("ours", "ref"):
        _fake_run(results, f"tiny_bounded_{side}", "tiny", genomes)
    _fake_run(results, "tiny_ours", "tiny", genomes[:2])
    out = str(tmp_path / "SCALE_torch.json")
    assert scale_torch.report(results, out) == 0
    doc = json.load(open(out))
    assert sorted(doc["runs"]) == ["tiny_bounded_ours", "tiny_bounded_ref",
                                   "tiny_ours"]
    run = doc["runs"]["tiny_bounded_ours"]
    assert "tmp_digests" not in run and run["artifacts_digested"] == [1, 1]
    assert run["metrics"]["n_contigs"] == 3
    assert run["metrics"]["genome_fraction"] > 0.99
    assert doc["runs"]["tiny_ours"]["metrics"]["n_contigs"] == 2
    same = doc["comparisons"]["tiny_bounded_ours vs tiny_bounded_ref"]
    assert same["equal"] == 3 and same["differ"] == []
    # the bounded run against the natural one: the contigs differ
    other = doc["comparisons"]["tiny_bounded_ours vs tiny_ours"]
    assert other["differ"] == ["contigs.fasta (decompressed)"]
    assert scale_torch.compare(results) == 1
    assert "DIFFERENT" in capsys.readouterr().out
    os.remove(os.path.join(results, "tiny_ours.json"))
    _fake_run(results, "tiny_bounded_ref", "tiny", genomes, digest="c")
    assert scale_torch.compare(results) == 1
    _fake_run(results, "tiny_bounded_ref", "tiny", genomes)
    assert scale_torch.compare(results) == 0


def _holders_of_a_local():
    big = np.ones(1 << 25, np.uint8)  # 32 MiB
    alive = weakref.ref(big)
    found = scale_torch._frame_holders(sys._getframe())
    assert big[0] == 1  # the function's own locals are untouched
    del big
    return found, alive() is None  # nothing else held it


def test_memory_probes():
    """The stage-end snapshot's fields, and the peak sampler's holders: a
    32 MiB local is found by name, and reading the frame keeps nothing
    alive after the function drops it."""
    snap = scale_torch.memory_snapshot("stage", walk=True)
    assert snap["stage"] == "stage" and snap["vmrss_gb"] > 0
    assert set(snap["held_gb"]) == {"numpy", "torch_cpu", "bytes"}
    if snap["malloc_gb"] is not None:
        assert snap["malloc_gb"]["in_use"] > 0
    found, freed = _holders_of_a_local()
    assert [name for gb, name in found if "_holders_of_a_local" in name] \
        == [f"test_torch_scale.py:_holders_of_a_local:"
            f"{_holders_of_a_local.__code__.co_firstlineno + 3} big"]
    assert found[0][0] == 1 / 32
    assert freed
