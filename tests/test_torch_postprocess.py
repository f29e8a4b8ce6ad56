"""The port's post-processing (metamdbg_tpu_torch/basespace/postprocess.py:
derepSmall, removeOverlaps, removeRepeats) against the JAX package's on
the CPU.

Input: a three-genome HiFi metagenome from tests/datagen.py with a shared
repeat family and one genome at 5x (its contig stays linear), assembled by
the JAX package's own asm with its tmp kept. Each port stage runs on a copy
of that tmp holding the JAX package's inputs to the stage, and its output
must equal the JAX package's byte for byte (tolerance 0).
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.__main__ import main as jax_main
from metamdbg_tpu_torch.basespace import chaining as pchaining
from metamdbg_tpu_torch.basespace import postprocess as ppost
from metamdbg_tpu_torch.io import records as precords

CPU = torch.device("cpu")
OUTPUTS = ("contig_data_init_small.txt",
           "contig_data_init_small.txt.nooverlaps",
           "contig_data_init_small.txt.norepeats")


def make_metagenome_fastq(path):
    genomes = datagen.make_metagenome(n_genomes=3,
                                      sizes=[50_000, 40_000, 30_000],
                                      repeat_len=4000, seed=20)
    datagen.write_fastq(path, datagen.metagenome_reads(
        genomes, [20, 5, 30], mean_length=6000, error_rate=0.002, seed=21))


@pytest.fixture(scope="module")
def jax_tmp(tmp_path_factory):
    """The JAX package's asm tmp dir on the metagenome, kept."""
    d = tmp_path_factory.mktemp("post")
    fq = str(d / "reads.fastq.gz")
    make_metagenome_fastq(fq)
    out = str(d / "jax")
    os.environ["METAMDBG_TPU_KEEP_TMP"] = "1"
    try:
        jax_main(["asm", "--out-dir", out, "--in-hifi", fq])
    finally:
        os.environ.pop("METAMDBG_TPU_KEEP_TMP", None)
    return os.path.join(out, "tmp")


def _params(tmp):
    return precords.Parameters.load(os.path.join(tmp, "parameters.gz"))


def _copy_without(tmp, dst, names):
    shutil.copytree(tmp, dst, ignore=shutil.ignore_patterns(
        "pass_k*", "filter", "_polish_readPartitions"))
    for name in names:
        os.remove(os.path.join(dst, name))
    return dst


def _same(a, b, name):
    with open(os.path.join(a, name), "rb") as fa, \
            open(os.path.join(b, name), "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("stage", range(3))
def test_stage_matches_jax_package(jax_tmp, tmp_path, stage):
    """derepSmall, removeOverlaps, removeRepeats, each from the JAX
    package's inputs: the output file is byte-identical."""
    work = _copy_without(jax_tmp, str(tmp_path / "work"), OUTPUTS[stage:])
    params = _params(jax_tmp)
    if stage == 0:
        ks = sorted(int(n[len("smallContigs_k"):-len(".bin")])
                    for n in os.listdir(os.path.join(work, "smallContigs")))
        assert len(ks) > 10
        ppost.run_derep_small(work, params, params.kminmer_size_first,
                              params.kminmer_size)
    elif stage == 1:
        ppost.run_remove_overlaps(work, params, CPU)
    else:
        ppost.run_remove_repeats(work, params, CPU)
    assert _same(jax_tmp, work, OUTPUTS[stage])
    if stage == 2:
        # the stage deletes its read-vs-contig alignments when it is done
        assert not os.path.exists(os.path.join(
            work, "readsVsContigsAlignments.bin"))


def test_stages_change_the_contig_set(jax_tmp):
    """The input exercises every stage: derep keeps some small contigs out
    of the long set, removeOverlaps trims, one contig stays linear."""
    def sizes(name):
        return [r.minimizers.shape[0] for r in precords.read_read_data(
            os.path.join(jax_tmp, name), with_quality=False)]

    init = sizes("contig_data_init.txt")
    small = sizes(OUTPUTS[0])
    assert len(small) > len(init)
    assert sum(sizes(OUTPUTS[1])) < sum(init)
    circ = [r.is_circular for r in precords.read_read_data(
        os.path.join(jax_tmp, OUTPUTS[2]), with_quality=False)]
    assert not all(circ)


def test_read_vs_contig_mapper_matches_jax_package(jax_tmp, tmp_path):
    """removeRepeats' read-vs-contig alignments (the file it deletes)."""
    from metamdbg_tpu.basespace import postprocess as jpost

    reads = os.path.join(jax_tmp, "read_data_init.txt")
    contigs = os.path.join(jax_tmp, OUTPUTS[1])
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jpost.run_read_vs_contig_mapper(reads, contigs, a)
    ppost.run_read_vs_contig_mapper(reads, contigs, b)
    data = open(a, "rb").read()
    assert len(data) > 0 and data == open(b, "rb").read()


@pytest.mark.parametrize("k", [3, 4, 5, 7])
def test_kminmer_hash_keys_match_jax_package(k):
    """One KW launch over many sequences gives each sequence's keys, as the
    JAX package's per-sequence numpy hash does; shorter than k gives none;
    palindromic windows are planted."""
    from metamdbg_tpu.basespace import postprocess as jpost

    rng = np.random.default_rng(k)
    seqs = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for n in (0, 1, k - 1, k, k + 1, 40, 200)]
    win = seqs[-1][10:10 + k]  # a view: make it a palindrome
    win[k - k // 2:] = win[:k // 2][::-1].copy()
    got = ppost.kminmer_hash_keys(seqs, k, CPU)
    for s, g in zip(seqs, got):
        want = jpost._kminmer_hash_keys(s, k)
        assert g.dtype == np.uint64 and np.array_equal(g, want)


def test_pair_index_is_the_jax_package_copy(jax_tmp):
    """The best mapping of every small contig against the long contigs."""
    from metamdbg_tpu.basespace import chaining as jchaining

    indexes = []
    for mod in (jchaining, pchaining):
        index = mod.PairIndex()
        for rec in precords.read_read_data(
                os.path.join(jax_tmp, "contig_data_init.txt"),
                with_quality=False):
            index.add(rec.index, rec.minimizers)
        index.build()
        indexes.append(index)
    n = 0
    small = os.path.join(jax_tmp, "smallContigs")
    for name in sorted(os.listdir(small)):
        for rec in precords.read_read_data(os.path.join(small, name),
                                           with_quality=False):
            a = jchaining.best_mapping(indexes[0], rec.minimizers)
            b = pchaining.best_mapping(indexes[1], rec.minimizers)
            assert (a is None) == (b is None)
            if a is not None:
                n += 1
                assert a[0] == b[0]
                assert dataclasses.astuple(a[1]) == dataclasses.astuple(b[1])
    assert n > 0
