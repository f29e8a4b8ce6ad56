"""Record files written by one package read back identically by the other:
the port's io/records.py against the JAX package's, byte for byte."""

import gzip

import numpy as np
import pytest

from metamdbg_tpu.io import records as jrecords
from metamdbg_tpu_torch.io import records as precords

PACKAGES = {"port": precords, "jax": jrecords}
PAIRS = [("port", "jax"), ("jax", "port")]


def _params(mod):
    return mod.Parameters(minimizer_size=15, kminmer_size=7,
                          density_assembly=0.005, kminmer_size_first=4,
                          minimizer_spacing_mean=200.0,
                          kminmer_length_mean=1200.0,
                          kminmer_overlap_mean=1000.0, kminmer_size_prev=6,
                          kminmer_size_last=40, mean_read_length=12000,
                          density_correction=0.025,
                          use_homopolymer_compression=False, data_type=1,
                          snpmer_size=21)


def _reads(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(20):
        n = int(rng.integers(0, 50))
        out.append(dict(
            index=i,
            minimizers=rng.integers(0, 1 << 32, size=n, dtype=np.uint32),
            positions=np.sort(rng.integers(0, 1 << 20, size=n,
                                           dtype=np.uint32)),
            directions=rng.integers(0, 2, size=n, dtype=np.uint8),
            qualities=rng.integers(0, 60, size=n, dtype=np.uint8),
            mean_quality=float(rng.random() * 40),
            read_length=int(rng.integers(100, 30000)),
            is_circular=bool(i % 3 == 0)))
    return out


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_parameters_round_trip(tmp_path, writer, reader):
    path = str(tmp_path / "parameters.gz")
    again = str(tmp_path / "again.gz")
    _params(PACKAGES[writer]).save(path)
    got = PACKAGES[reader].Parameters.load(path)
    # float fields come back rounded to float32, by both packages alike
    assert vars(got) == vars(PACKAGES[writer].Parameters.load(path))
    assert got.kminmer_size_last == 40 and got.data_type == 1
    got.save(again)
    assert gzip.decompress(open(path, "rb").read()) == \
        gzip.decompress(open(again, "rb").read())


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_read_stats_round_trip(tmp_path, writer, reader):
    a = str(tmp_path / "a.txt")
    b = str(tmp_path / "b.txt")
    stats = dict(nb_reads=1234, n50=11_500, density=0.00497,
                 nb_bases=98_765_432_100, avg_quality=31.25,
                 mean_length=9876, nb_minimizers=4_567_890)
    PACKAGES[writer].ReadStats(**stats).save(a)
    got = PACKAGES[reader].ReadStats.load(a)
    assert vars(got) == vars(PACKAGES[writer].ReadStats.load(a))
    got.save(b)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("with_quality", [True, False])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_read_data_round_trip(tmp_path, writer, reader, with_quality):
    wmod, rmod = PACKAGES[writer], PACKAGES[reader]
    reads = _reads(seed=3)
    a = str(tmp_path / "a.txt")
    b = str(tmp_path / "b.txt")
    with wmod.ReadDataWriter(a, with_quality=with_quality) as w:
        for r in reads:
            w.write(wmod.MinimizerRead(**r))
    back = list(rmod.read_read_data(a, with_quality=with_quality))
    assert len(back) == len(reads)
    for r, g in zip(reads, back):
        np.testing.assert_array_equal(g.minimizers, r["minimizers"])
        assert g.is_circular == r["is_circular"]
        if with_quality:
            np.testing.assert_array_equal(g.positions, r["positions"])
            np.testing.assert_array_equal(g.directions, r["directions"])
            np.testing.assert_array_equal(g.qualities, r["qualities"])
            assert g.mean_quality == np.float32(r["mean_quality"])
            assert g.read_length == r["read_length"]
    # the reader's package writes the same bytes back
    with rmod.ReadDataWriter(b, with_quality=with_quality) as w:
        for g in back:
            w.write(g)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_repetitive_minimizers_round_trip(tmp_path, writer, reader):
    path = str(tmp_path / "repetitiveMinimizers.bin")
    mins = np.array([7, 1 << 31, (1 << 32) - 1, 0], np.uint32)
    PACKAGES[writer].save_repetitive_minimizers(path, mins)
    np.testing.assert_array_equal(
        PACKAGES[reader].load_repetitive_minimizers(path), mins)
