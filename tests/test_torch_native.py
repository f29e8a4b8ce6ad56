"""The port's native/ build and bindings (metamdbg_tpu_torch/io/native.py,
fastq.py, sketch/native_sketch.py) against the JAX package's."""

import ctypes
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.io import fastq as jfastq
from metamdbg_tpu_torch.io import fastq, native
from metamdbg_tpu_torch.sketch import filters, native_sketch


def _reads(seed, n=60):
    rng = np.random.default_rng(seed)
    seqs, quals = [], []
    for i in range(n):
        m = int(rng.integers(0, 3000))
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=m)]
        if i % 7 == 0 and m > 100:
            s = s.copy()
            s[20:40] = ord("N")
        if i % 11 == 0:
            s = np.resize(np.frombuffer(b"AC", np.uint8), m)
        seqs.append(s)
        quals.append(np.zeros(0, np.uint8) if i % 5 == 0 else
                     rng.integers(35, 75, size=m).astype(np.uint8))
    return seqs, quals


def test_build_all_leaves_nothing_stale():
    native.build_all()
    for name in native.RECIPES:
        assert os.path.exists(os.path.join(native.NATIVE_DIR, name))
        assert not native._stale(name)


def test_library_without_openmp_gives_the_same_filters(tmp_path,
                                                       monkeypatch):
    """Where g++ has no OpenMP runtime the libraries are built without
    -fopenmp; the read filters must not change."""
    seqs, quals = _reads(seed=5)
    args = (seqs, quals, 64, 32, filters._QUAL_TABLE)
    want = native_sketch.read_filters_batch(*args)
    out = str(tmp_path / "libsketch.so")
    native.compile_library("libsketch.so", out, openmp=False)
    lib = ctypes.CDLL(out)
    assert not hasattr(lib, "GOMP_parallel")
    monkeypatch.setitem(native._LIBS, "libsketch.so", lib)
    got = native_sketch.read_filters_batch(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isnan(want[1][0]) and np.isfinite(want[0]).any()


def test_fastq_reads_match_jax_parser(tmp_path):
    fq = str(tmp_path / "reads.fastq.gz")
    datagen.make_test_fastq(fq, genome_len=20_000, coverage=5,
                            mean_length=3000, seed=6)
    fa = str(tmp_path / "reads.fasta")
    with open(fa, "w") as f:
        f.write(">a\nACGTN\nAC\n>b\n\n>c\nTTTT\n")
    paths = [fq, fa]
    got = list(fastq.iter_reads(paths))
    want = list(jfastq.iter_reads(paths, need_headers=True))
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.index == w.index
        np.testing.assert_array_equal(g.seq, w.seq)
        np.testing.assert_array_equal(g.qual, w.qual)
    assert [r.index for r in fastq.iter_reads(paths, max_reads=4)] == \
        [0, 1, 2, 3]
