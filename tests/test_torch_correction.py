"""ONT read correction in the port (metamdbg_tpu_torch/correction/) against
the JAX package's (metamdbg_tpu/correction/) on the CPU, on the same reads:
the read mapper's readAlignmentsLowDensity.bin (one chunk and several), the
correction-density re-sketch with its qualities, the read partitions, and
read_data_corrected.txt with its checksum, at 1 and 4 threads. Everything
is compared byte for byte or exactly: tolerance 0.

The reads are a small ONT sample from tests/datagen.py (a seeded numpy
generator), read-selected by the port, whose read_data_init.txt equals the
JAX package's (tests/test_torch_read_selection.py).
"""

import dataclasses
import logging
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.correction import mapper as jmapper
from metamdbg_tpu.correction import stage as jstage
from metamdbg_tpu.io import records as jrecords
from metamdbg_tpu_torch.correction import mapper, stage
from metamdbg_tpu_torch.io import records
from metamdbg_tpu_torch.sketch import read_selection

PARAMS = records.Parameters(
    minimizer_size=15, kminmer_size=4, density_assembly=0.005,
    kminmer_size_first=4, kminmer_size_prev=4, kminmer_size_last=20,
    density_correction=0.025, use_homopolymer_compression=False,
    data_type=1)


def _jax_params(params=PARAMS):
    return jrecords.Parameters(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def ont_tmp(tmp_path_factory):
    """A tmp dir as read selection leaves it for correction: ONT reads of
    a 50 kb genome at 30x with 1% substitutions and 0.7% indels."""
    d = tmp_path_factory.mktemp("correction")
    fq = str(d / "reads.fastq.gz")
    genome = datagen.random_genome(50_000, seed=51)
    datagen.write_fastq(fq, datagen.sample_reads(
        genome, coverage=30, mean_length=6000, error_rate=0.01,
        ins_rate=0.0035, del_rate=0.0035, seed=52, mean_quality=20))
    tmp = str(d / "tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "input.txt"), "w") as f:
        f.write(fq + "\n")
    read_selection.run_read_selection([fq], tmp, PARAMS, "cpu")
    return fq, tmp


def _reads(tmp):
    return list(records.read_read_data(
        os.path.join(tmp, "read_data_init.txt"), with_quality=True))


@pytest.mark.parametrize("chunk", [2000, 10 ** 9], ids=["chunks", "one"])
@pytest.mark.parametrize("band", [62, 10])
def test_mapper_alignments_match_jax(ont_tmp, tmp_path, chunk, band):
    """readAlignmentsLowDensity.bin byte for byte, with one mapper chunk
    and with several (chunk size 2000, as tests/test_pair_join.py:72)."""
    _, tmp = ont_tmp
    reads = _reads(tmp)
    assert sum(r.minimizers.shape[0] for r in reads) > 3 * 2000
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    want = jmapper.run_read_mapper(reads, chunk, band, alignment_path=a)
    got = mapper.run_read_mapper(reads, chunk, band, "cpu",
                                 alignment_path=b)
    assert os.path.getsize(a) > 1000
    assert open(a, "rb").read() == open(b, "rb").read()
    assert sorted(want) == sorted(got)
    for r in want:
        assert np.array_equal(want[r], got[r]), r


def test_high_density_sketch_matches_jax(ont_tmp):
    """The re-sketch at correction density through the sketch kernel's
    plain version equals the JAX package's native sketcher, qualities
    (over the inclusive span) included, with a blacklist that bites."""
    fq, _ = ont_tmp
    plain = stage.sketch_high_density_reads([fq], PARAMS,
                                            np.zeros(0, np.uint32), "cpu")
    pool = np.concatenate([r.minimizers[::7] for r in plain])
    repetitive = np.unique(pool)[:200]
    got = stage.sketch_high_density_reads([fq], PARAMS, repetitive, "cpu")
    want = jstage.sketch_high_density_reads([fq], _jax_params(), repetitive)
    assert sum(r.minimizers.shape[0] for r in got) < \
        sum(r.minimizers.shape[0] for r in plain)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.index == w.index and g.read_length == w.read_length
        for name in ("minimizers", "positions", "directions", "qualities"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                (g.index, name)
    assert any(np.any(r.qualities != 1) for r in got)


def test_quality_span_is_inclusive():
    """getMinQuality reads rle_pos[p] .. rle_pos[p + l - 1] inclusive, one
    base past read selection's span end."""
    qual = np.frombuffer(b"IIII#III", np.uint8)
    rle_pos = np.arange(8, dtype=np.uint64)
    pos = np.array([0, 1], np.uint32)
    # spans [0, 3] and [1, 4]: the '#' at 4 only enters the second
    assert stage._min_qualities(qual, rle_pos, pos, 4).tolist() == [40, 2]
    assert np.array_equal(
        stage._min_qualities(qual, rle_pos, pos, 4),
        jstage._min_qualities(qual, rle_pos, pos, 4))


@pytest.mark.parametrize("nb_bases", [0, 86_000_000, 9_000_000_000,
                                      250_000_000_000, 10 ** 13])
def test_memory_model_matches_jax(nb_bases, monkeypatch):
    monkeypatch.delenv("METAMDBG_TPU_CORRECTION_MEMORY_GB", raising=False)
    assert stage.compute_max_memory(nb_bases) == \
        jstage.compute_max_memory(nb_bases)
    monkeypatch.setenv("METAMDBG_TPU_CORRECTION_MEMORY_GB", "0.01")
    assert stage.compute_max_memory(nb_bases) == 10_000_000


def test_written_records_match_jax(ont_tmp, tmp_path):
    """writeRead: the density filter, the palindrome purge, the record and
    the running checksum, on the reads' own minimizers, on reads too short
    for a record, and on palindromic ones."""
    _, tmp = ont_tmp
    rng = np.random.default_rng(53)
    arrays = [r.minimizers for r in _reads(tmp)[:150]]
    arrays += [np.zeros(0, np.uint32), arrays[0][:3]]
    arrays += [np.concatenate([a, a[::-1]]) for a in arrays[1:20]]
    arrays += [rng.integers(0, 1 << 32, 400, dtype=np.uint64).astype(
        np.uint32)]
    out = {}
    for name, mod, rec, params in (
            ("jax", jstage, jrecords, _jax_params()),
            ("port", stage, records, PARAMS)):
        path = str(tmp_path / name)
        checksum = 0
        with rec.ReadDataWriter(path, with_quality=False) as writer:
            for i, mins in enumerate(arrays):
                checksum = mod._write_read(writer, i * 7 + 1, mins, params,
                                           checksum)
        out[name] = (open(path, "rb").read(), checksum)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) > 1000 and out["port"][1] != 0


@pytest.mark.parametrize("max_memory", [10 ** 9, 40_000, 9_000])
def test_partitions_match_jax(ont_tmp, max_memory):
    """partition_reads on the mapper's alignments: one partition, and
    several when the memory budget is small."""
    _, tmp = ont_tmp
    reads = _reads(tmp)
    aligned = mapper.run_read_mapper(reads, 10 ** 9, 62, "cpu")
    align_lists = [aligned.get(i, np.zeros(0, np.uint32)).tolist()
                   for i in range(len(reads))]
    got = stage.partition_reads(align_lists, max_memory, 500)
    assert got == jstage.partition_reads(align_lists, max_memory, 500)
    assert (len(got[0]) > 1) == (max_memory < 10 ** 9)


def _run_both(ont_tmp, tmp_path, n_threads, caplog):
    _, tmp = ont_tmp
    out = {}
    for name, fn, params, args in (
            ("jax", jstage.run_read_correction, _jax_params(), ()),
            ("port", stage.run_read_correction, PARAMS, ("cpu",))):
        d = str(tmp_path / name)
        shutil.copytree(tmp, d)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            checksum = fn(d, params, *args, min_identity=0.96,
                          min_overlap_length=1000, n_threads=n_threads)
        logged = [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("Correction checksum")]
        assert logged == [f"Correction checksum: {checksum}"], name
        out[name] = (d, checksum,
                     [r.getMessage() for r in caplog.records
                      if r.getMessage().startswith("correction partitions")])
    (jd, jsum, jparts), (pd, psum, pparts) = out["jax"], out["port"]
    assert psum == jsum != 0
    assert pparts == jparts
    for name in ("readAlignmentsLowDensity.bin", "read_data_corrected.txt"):
        a = open(os.path.join(jd, name), "rb").read()
        assert len(a) > 1000, name
        assert a == open(os.path.join(pd, name), "rb").read(), name
    return jparts


@pytest.mark.parametrize("n_threads", [1, 4])
def test_correction_matches_jax(ont_tmp, tmp_path, n_threads, caplog,
                                monkeypatch):
    """read_data_corrected.txt byte for byte and the same checksum."""
    monkeypatch.delenv("METAMDBG_TPU_CORRECTION_MEMORY_GB", raising=False)
    parts = _run_both(ont_tmp, tmp_path, n_threads, caplog)
    assert parts[0].startswith("correction partitions: 1 ")


def test_multi_partition_correction_matches_jax(ont_tmp, tmp_path, caplog,
                                                monkeypatch):
    """A memory budget forced small (METAMDBG_TPU_CORRECTION_MEMORY_GB)
    splits the reads into several partitions: the same bytes."""
    monkeypatch.setenv("METAMDBG_TPU_CORRECTION_MEMORY_GB", "0.00002")
    parts = _run_both(ont_tmp, tmp_path, 2, caplog)
    assert not parts[0].startswith("correction partitions: 1 ")
