"""The port's toBasespace (metamdbg_tpu_torch/basespace/) against the JAX
package's on the CPU, piece by piece and whole.

HiFi input: the three-genome metagenome of tests/test_torch_postprocess.py,
assembled by the JAX package's asm with its tmp kept. The port's pieces run
on the JAX package's inputs: the read-vs-contig alignments (kernel K3's
plain version), the partition files, every contig's draft from
create_base_contig, one polish pass, and the whole run_to_basespace, once
as the asm runs it and once with METAMDBG_TPU_MAX_PARTITION_GB forcing one
partition per contig. ONT input: a JAX-package ONT asm of the
tests/test_e2e.py:55 input, resumed by the port at toBasespace, where the
ONT (data_type 1) refinement pass runs. Every output must be identical:
bytes, arrays and dict order (tolerance 0), and contigs.fasta.gz outside
the gzip header's write time.
"""

import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.__main__ import main as jax_main
from metamdbg_tpu_torch.__main__ import main as port_main
from metamdbg_tpu_torch.basespace import contig_mapper as pmapper
from metamdbg_tpu_torch.basespace import partition as ppartition
from metamdbg_tpu_torch.basespace import polisher as ppolisher
from metamdbg_tpu_torch.basespace import postprocess as ppost
from metamdbg_tpu_torch.basespace import reconstruct as preconstruct
from metamdbg_tpu_torch.basespace import tiling as ptiling
from metamdbg_tpu_torch.io import records as precords
from test_torch_e2e import assert_same_contigs
from test_torch_postprocess import make_metagenome_fastq

CPU = torch.device("cpu")
AVG_DIST = float(1.0 / np.float32(0.005))
MIN_LEN, MIN_COV = 50, 1.0
NOREPEATS = "contig_data_init_small.txt.norepeats"
ALIGNMENTS = "readsVsContigsAlignments.bin"
PARTITIONS = "_polish_readPartitions"


def _jax_asm(d, platform, make_reads):
    fq = str(d / "reads.fastq.gz")
    make_reads(fq)
    out = str(d / "jax")
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    try:
        jax_main(["asm", "--out-dir", out, f"--in-{platform}", fq])
    finally:
        os.environ.pop("METAMDBG_TPU_KEEP_TMP", None)
    return fq, out


@pytest.fixture(scope="module")
def hifi(tmp_path_factory):
    """(reads, JAX package's out dir) of the metagenome, tmp kept."""
    return _jax_asm(tmp_path_factory.mktemp("hifi"), "hifi",
                    make_metagenome_fastq)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _mappings(tmp):
    from metamdbg_tpu_torch.basespace.tiling import Mapping
    return [Mapping(t) for t in ppost.read_alignments(
        os.path.join(tmp, ALIGNMENTS))]


def _contigs(tmp):
    return [(i, np.asarray(rec.minimizers, np.uint32), rec.is_circular)
            for i, rec in enumerate(precords.read_read_data(
                os.path.join(tmp, NOREPEATS), with_quality=False))]


def test_reads_vs_contigs_alignments(hifi, tmp_path):
    """readsVsContigsAlignments.bin, every group chained by K3's plain
    version."""
    tmp = os.path.join(hifi[1], "tmp")
    out = str(tmp_path / ALIGNMENTS)
    got = pmapper.map_reads_to_contigs(
        os.path.join(tmp, "read_data_init.txt"), os.path.join(tmp, NOREPEATS),
        out, AVG_DIST, CPU)
    assert len(got) > 100
    assert _read(out) == _read(os.path.join(tmp, ALIGNMENTS))


def test_partition_files(hifi, tmp_path):
    """{i}_reads.bin (reads contig-oriented) and {i}_contigs.bin."""
    from metamdbg_tpu_torch.io import fastq

    fq, jout = hifi
    tmp = os.path.join(jout, "tmp")
    contigs = _contigs(tmp)
    part = ppartition.Partitionner(contigs, _mappings(tmp), AVG_DIST)
    ppartition.write_read_partitions(part, fastq.iter_reads([fq]),
                                     str(tmp_path), use_qual=True)
    ppartition.write_contig_partitions(part, contigs, str(tmp_path))
    assert part.nb_partitions >= 1
    for i in range(part.nb_partitions):
        for name in (f"{i}_reads.bin", f"{i}_contigs.bin"):
            assert _read(str(tmp_path / name)) == \
                _read(os.path.join(tmp, PARTITIONS, name)), name


def _partition_inputs(tmp):
    """Partition 0's reads, quals and contigs, and each contig's mappings
    on reads of the partition, as run_to_basespace gathers them."""
    reads, quals = {}, {}
    for idx, seq, qual in ppartition.read_read_partition(
            os.path.join(tmp, PARTITIONS, "0_reads.bin")):
        reads[idx] = seq
        quals[idx] = qual
    per_contig: dict = {}
    for al in _mappings(tmp):
        per_contig.setdefault(al.contig_index, []).append(al)
    contigs = [(cid, mins, circ, [al for al in per_contig.get(cid, [])
                                  if al.read_index in reads])
               for cid, mins, circ in ppartition.read_contig_partition(
                   os.path.join(tmp, PARTITIONS, "0_contigs.bin"))]
    return reads, quals, contigs


def _jax_drafts(tmp):
    """The JAX package's drafts of partition 0 and its tiler's sketches."""
    from metamdbg_tpu.basespace import tiling as jtiling

    reads, _, contigs = _partition_inputs(tmp)
    tiler = jtiling.ContigTiler(reads, AVG_DIST, MIN_LEN)
    tiler.n_threads = 1
    drafts = [jtiling.create_base_contig(
        tiler, mins, circ, [jtiling.Mapping(
            (a.read_index, a.contig_index, a.read_start, a.read_end,
             a.contig_start, a.contig_end, a.is_reversed, a.match_score,
             a.read_start_real, a.read_end_real, a.read_length_bp))
            for a in als])
        for _, mins, circ, als in contigs]
    return drafts, dict(tiler._sketches)


def _same_pieces(a, b):
    assert len(a) == len(b)
    for (sa, ca, ma, ra), (sb, cb, mb, rb) in zip(a, b):
        assert np.array_equal(sa, sb) and ca == cb and ra == rb
        assert np.array_equal(ma, mb)


def test_create_base_contig_drafts(hifi):
    """Every contig's draft from verified read tiling: sequence, circular
    flag, minimizer slice and read path; and the tiler's sketches (K1 in
    the port, the native sketcher in the JAX package)."""
    tmp = os.path.join(hifi[1], "tmp")
    want, want_sketches = _jax_drafts(tmp)
    reads, _, contigs = _partition_inputs(tmp)
    tiler = ptiling.ContigTiler(reads, AVG_DIST, MIN_LEN, CPU, n_threads=2)
    n = 0
    for (_, mins, circ, als), (w_pieces, w_cov) in zip(contigs, want):
        pieces, cov = ptiling.create_base_contig(tiler, mins, circ, als)
        assert cov == w_cov
        _same_pieces(pieces, w_pieces)
        n += len(pieces)
    assert n >= 1
    assert list(tiler._sketches) == list(want_sketches)
    for r, (v, p, d) in tiler._sketches.items():
        wv, wp, wd = want_sketches[r]
        assert v.dtype == wv.dtype and p.dtype == wp.dtype
        assert np.array_equal(v, wv) and np.array_equal(p, wp) \
            and np.array_equal(d, wd)


def test_one_polish_pass(hifi):
    """One polish pass over partition 0's drafts: the polished contigs,
    headers, coverages, header strings and changed intervals, in order."""
    from metamdbg_tpu.basespace import polisher as jpolisher

    tmp = os.path.join(hifi[1], "tmp")
    drafts, sketches = _jax_drafts(tmp)
    reads, quals, _ = _partition_inputs(tmp)
    contigs, headers = {}, {}
    for pieces, _ in drafts:
        for seq, circ, _, _ in pieces:
            contigs[len(contigs)] = seq
            headers[len(headers)] = (len(headers), circ)
    part_reads = [(r, reads[r], quals[r]) for r in reads]
    want = jpolisher.polish_pass(contigs, headers, part_reads, MIN_LEN,
                                 MIN_COV, final_headers=True, n_threads=1,
                                 read_sketches=sketches)
    got = ppolisher.polish_pass(contigs, headers, part_reads, MIN_LEN,
                                MIN_COV, final_headers=True, device=CPU,
                                n_threads=2, read_sketches=sketches)
    assert len(got[0]) >= 1
    assert list(got[0]) == list(want[0])
    for cid in want[0]:
        assert np.array_equal(got[0][cid], want[0][cid])
    for g, w in zip(got[1:], want[1:]):
        assert list(g.items()) == list(w.items())


def _fresh_tmp(jtmp, dst):
    """The JAX package's tmp as toBasespace found it."""
    shutil.copytree(jtmp, dst, ignore=shutil.ignore_patterns(
        "pass_k*", "filter", PARTITIONS, ALIGNMENTS, "contig_data_final.bin"))
    return dst


def _port_to_basespace(fq, jtmp, dst, n_threads=1):
    tmp = _fresh_tmp(jtmp, dst)
    params = precords.Parameters.load(os.path.join(tmp, "parameters.gz"))
    out = os.path.join(tmp, "contigs.fasta.gz")
    preconstruct.run_to_basespace(tmp, [fq], out, params, CPU, MIN_LEN,
                                  MIN_COV, n_threads)
    return tmp, out


def _assert_same_outputs(jtmp, jcontigs, tmp, contigs):
    assert_same_contigs(jcontigs, contigs)
    for name in (ALIGNMENTS, "contig_data_final.bin"):
        assert _read(os.path.join(tmp, name)) == \
            _read(os.path.join(jtmp, name)), name


def test_run_to_basespace_hifi(hifi, tmp_path):
    """The whole stage, as the asm runs it (two native threads)."""
    fq, jout = hifi
    jtmp = os.path.join(jout, "tmp")
    tmp, out = _port_to_basespace(fq, jtmp, str(tmp_path / "tmp"),
                                  n_threads=2)
    _assert_same_outputs(jtmp, os.path.join(jout, "contigs.fasta.gz"), tmp,
                         out)


def test_run_to_basespace_several_partitions(hifi, tmp_path, monkeypatch):
    """A partition memory cap below any contig's model puts every contig
    in a partition of its own, in both packages."""
    from metamdbg_tpu.basespace import reconstruct as jreconstruct
    from metamdbg_tpu.io import records as jrecords

    monkeypatch.setenv("METAMDBG_TPU_MAX_PARTITION_GB", "0.000001")
    fq, jout = hifi
    jtmp = _fresh_tmp(os.path.join(jout, "tmp"), str(tmp_path / "jax"))
    jcontigs = os.path.join(jtmp, "contigs.fasta.gz")
    jreconstruct.run_to_basespace(
        jtmp, [fq], jcontigs,
        jrecords.Parameters.load(os.path.join(jtmp, "parameters.gz")),
        MIN_LEN, MIN_COV, None, n_threads=1)
    tmp, out = _port_to_basespace(fq, os.path.join(jout, "tmp"),
                                  str(tmp_path / "port"))
    n_parts = len([n for n in os.listdir(os.path.join(tmp, PARTITIONS))
                   if n.endswith("_contigs.bin")])
    assert n_parts == len(_contigs(tmp)) >= 2
    _assert_same_outputs(jtmp, jcontigs, tmp, out)


@pytest.mark.parametrize("env", [{"METAMDBG_TPU_POLISH_PASSES": "1"},
                                 {"METAMDBG_TPU_POLISH_PASSES": "3"},
                                 {"METAMDBG_TPU_POLISH_REFINE": "0"}],
                         ids=["passes1", "passes3", "no_refine"])
def test_run_to_basespace_polish_env(hifi, tmp_path, monkeypatch, caplog,
                                     env):
    """METAMDBG_TPU_POLISH_PASSES and METAMDBG_TPU_POLISH_REFINE=0 set the
    polish passes as in the JAX package (metamdbg_tpu/basespace/
    reconstruct.py:160-162): the contigs are the JAX package's under the
    same variable."""
    from metamdbg_tpu.basespace import reconstruct as jreconstruct
    from metamdbg_tpu.io import records as jrecords

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    fq, jout = hifi
    jtmp = _fresh_tmp(os.path.join(jout, "tmp"), str(tmp_path / "jax"))
    jcontigs = os.path.join(jtmp, "contigs.fasta.gz")
    jreconstruct.run_to_basespace(
        jtmp, [fq], jcontigs,
        jrecords.Parameters.load(os.path.join(jtmp, "parameters.gz")),
        MIN_LEN, MIN_COV, None, n_threads=1)
    with caplog.at_level(logging.INFO, logger="metamdbg_tpu_torch"):
        tmp, out = _port_to_basespace(fq, os.path.join(jout, "tmp"),
                                      str(tmp_path / "port"))
    port_log = [r.getMessage() for r in caplog.records
                if r.name == "metamdbg_tpu_torch"]
    passes = int(env.get("METAMDBG_TPU_POLISH_PASSES", "2"))
    partitions = sum(" tiling: " in m for m in port_log)
    refined = sum("Polish refinement" in m for m in port_log)
    assert sum("polish pass timing" in m for m in port_log) == \
        passes * partitions + refined
    if "METAMDBG_TPU_POLISH_REFINE" in env:
        assert refined == 0
    _assert_same_outputs(jtmp, jcontigs, tmp, out)


def _ont_reads(path):
    """The tests/test_e2e.py:55 ONT input."""
    genome = datagen.random_genome(70_000, seed=31)
    datagen.write_fastq(path, datagen.sample_reads(
        genome, coverage=35, mean_length=8000, error_rate=0.005,
        ins_rate=0.0035, del_rate=0.0035, seed=32, mean_quality=22))


def test_run_to_basespace_ont(tmp_path, caplog):
    """A JAX-package ONT run, its toBasespace checkpoint removed, resumed by
    the port: the ONT refinement pass re-polishes whole contigs, and the
    contigs are the JAX package's."""
    fq, jout = _jax_asm(tmp_path, "ont", _ont_reads)
    out = str(tmp_path / "resumed")
    shutil.copytree(jout, out)
    os.remove(os.path.join(out, "contigs.fasta.gz"))
    os.remove(os.path.join(out, "tmp", "checkpoints",
                           "toBasespace.checkpoint"))
    with caplog.at_level(logging.INFO, logger="metamdbg_tpu_torch"):
        assert port_main(["asm", "--out-dir", out, "--in-ont", fq,
                          "--device", "cpu"]) == 0
    assert "Polish refinement: 1 contigs" in caplog.text
    params = precords.Parameters.load(os.path.join(out, "tmp",
                                                   "parameters.gz"))
    assert params.data_type == 1
    assert_same_contigs(os.path.join(jout, "contigs.fasta.gz"),
                        os.path.join(out, "contigs.fasta.gz"))
