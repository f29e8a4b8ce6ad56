"""Read selection in the port (device="cpu": the sketch kernel's plain
version) against the JAX package's read selection on the same reads.

The JAX side runs host-only, through its native C++ sketcher, an
implementation independent of the port's. Every artifact must be
byte-identical (tolerance 0).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.io import records as jrecords
from metamdbg_tpu.sketch import read_selection as jrs
from metamdbg_tpu_torch.io import records as precords
from metamdbg_tpu_torch.sketch import batch
from metamdbg_tpu_torch.sketch import read_selection as prs

ARTIFACTS = ("read_data_init.txt", "read_stats.txt",
             "read_data_corrected.txt", "repetitiveMinimizers.bin")


def _write_reads(path, platform):
    if platform == "hifi":
        datagen.make_test_fastq(path, genome_len=60_000, coverage=12,
                                mean_length=6000, error_rate=0.002, seed=41)
        return
    genome = datagen.random_genome(60_000, seed=42)
    # a repeat family gives the ONT blacklist something to ban
    rep = genome[1000:4000].copy()
    genome[20_000:23_000] = rep
    genome[40_000:43_000] = rep
    reads = list(datagen.sample_reads(
        genome, coverage=12, mean_length=6000, error_rate=0.005,
        ins_rate=0.0035, del_rate=0.0035, seed=43, mean_quality=22))
    # every other read of higher quality, so a quality cut keeps some
    reads = [(h, seq, qual + 8 if i % 2 else qual)
             for i, (h, seq, qual) in enumerate(reads)]
    # one low-complexity read and one read with an N run
    h, seq, qual = reads[0]
    reads.append(("lowcomplexity", np.resize(np.frombuffer(b"ACG", np.uint8),
                                             3000), qual[:3000]))
    seq = seq.copy()
    seq[100:130] = ord("N")
    reads.append(("withN", seq, qual))
    datagen.write_fastq(path, reads)


def _params(mod, use_hpc):
    return mod.Parameters(minimizer_size=15, kminmer_size=4,
                          density_assembly=0.005, kminmer_size_first=4,
                          density_correction=0.025,
                          use_homopolymer_compression=use_hpc,
                          data_type=0 if use_hpc else 1)


@pytest.mark.parametrize("platform,skip_correction,min_quality", [
    ("hifi", False, 0.0), ("ont", False, 0.0), ("ont", True, 25.0)])
def test_read_selection_matches_jax_package(tmp_path, monkeypatch, platform,
                                            skip_correction, min_quality):
    fq = str(tmp_path / "reads.fastq.gz")
    _write_reads(fq, platform)
    use_hpc = platform == "hifi"
    jdir = tmp_path / "jax"
    pdir = tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()

    with monkeypatch.context() as m:
        m.setenv("METAMDBG_TPU_HOST_ONLY", "1")
        jrs.run_read_selection([fq], str(jdir), _params(jrecords, use_hpc),
                               min_read_quality=min_quality,
                               skip_correction=skip_correction)
    before = batch.tile_batches
    prs.run_read_selection([fq], str(pdir), _params(precords, use_hpc),
                           device="cpu", min_read_quality=min_quality,
                           skip_correction=skip_correction)
    assert batch.tile_batches > before

    written = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == written
    expected = [a for a in ARTIFACTS
                if a != "read_data_corrected.txt"
                or use_hpc or skip_correction]
    assert sorted(expected) == written
    for name in written:
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name
    if not use_hpc:
        assert (pdir / "repetitiveMinimizers.bin").stat().st_size > 0
    stats = precords.ReadStats.load(str(pdir / "read_stats.txt"))
    assert 0 < stats.nb_minimizers
    kept = [r.minimizers.size > 0 for r in precords.read_read_data(
        str(pdir / "read_data_init.txt"), with_quality=True)]
    assert any(kept) and (min_quality == 0.0 or not all(kept))
