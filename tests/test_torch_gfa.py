"""The `gfa` and `map` subcommands of the port against the JAX package's.

Two assemblies are made by both packages, with --all-assembly-graph: the
isolate of tests/test_e2e.py:test_gfa_and_map_subcommands (a 40 kb genome at
15x, seed 21) and a three-genome metagenome whose genomes share a repeat
(more unitigs, links and contigs). Their pass_k snapshots must be
byte-identical; then each package's `gfa` and `map` run on copies of the
port's output directory and must write the same files. Unit cases pin the
pieces: the sketcher's read-end trim, the unitig drafts, the coverage
means, and the dict semantics of the contig path (the last unitig wins) and
of `map` (the first reference wins, a strict majority). Everything is
compared exactly (tolerance 0: bytes and integer arrays). The JAX package
runs host-only (METAMDBG_TPU_HOST_ONLY), as chip_smoke.py's references run
it; the port runs with --device cpu, the kernels' plain versions.
"""

import contextlib
import gzip
import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import datagen
from metamdbg_tpu.__main__ import main as jax_main
from metamdbg_tpu_torch.__main__ import main as port_main
from metamdbg_tpu_torch.io import records
from metamdbg_tpu_torch.pipeline import gfa as port_gfa
from metamdbg_tpu_torch.pipeline import mapref as port_mapref
from metamdbg_tpu_torch.sketch.batch import TILE_LEN, BatchSketcher
from test_torch_e2e import run_port

GRAPH_FILES = ("assembly_graph.gfa", "assembly_graph.gfa.unitigs")


@contextlib.contextmanager
def host_only():
    old = os.environ.get("METAMDBG_TPU_HOST_ONLY")
    os.environ["METAMDBG_TPU_HOST_ONLY"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("METAMDBG_TPU_HOST_ONLY")
        else:
            os.environ["METAMDBG_TPU_HOST_ONLY"] = old


def _assemble(d, write_reads):
    """Both packages' asm --all-assembly-graph on the reads `write_reads`
    makes; returns (jax out dir, port out dir, what write_reads returned)."""
    fq = str(d / "reads.fastq.gz")
    made = write_reads(fq)
    jout, pout = str(d / "jax"), str(d / "port")
    with host_only():
        jax_main(["asm", "--out-dir", jout, "--in-hifi", fq,
                  "--all-assembly-graph"])
    assert port_main(["asm", "--out-dir", pout, "--in-hifi", fq,
                      "--all-assembly-graph", "--device", "cpu"]) == 0
    return jout, pout, made


def _isolate_reads(fq):
    return [datagen.make_test_fastq(fq, genome_len=40_000, coverage=15,
                                    mean_length=6000, error_rate=0.002,
                                    seed=21)]


def _metagenome_reads(fq):
    genomes = datagen.make_metagenome(n_genomes=3,
                                      sizes=[40_000, 50_000, 60_000],
                                      repeat_len=3000, seed=22)
    datagen.write_fastq(fq, datagen.metagenome_reads(
        genomes, [8, 15, 25], mean_length=6000, error_rate=0.002, seed=23))
    return genomes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {"isolate": _assemble(tmp_path_factory.mktemp("isolate"),
                                 _isolate_reads),
            "metagenome": _assemble(tmp_path_factory.mktemp("metagenome"),
                                    _metagenome_reads)}


def _ks(out):
    return port_gfa.available_ks(os.path.join(out, "tmp"))


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _outputs(d):
    """name -> bytes of every file a `gfa` or `map` run writes in `d`."""
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))
            if n.startswith(("assemblyGraph", "x.", "x_"))}


def _write_fasta(path, records_, width=60, final_newline=True):
    """Multi-line FASTA; without `final_newline` the last line has no
    newline."""
    text = "".join(f">{name}\n" + "".join(
        seq[i:i + width] + "\n" for i in range(0, len(seq), width))
        for name, seq in records_)
    with open(path, "w") as f:
        f.write(text if final_newline else text.rstrip("\n"))
    return str(path)


@pytest.mark.parametrize("run", ["isolate", "metagenome"])
def test_pass_snapshots_match(runs, run):
    """Every pass_k<k>/ snapshot of the port's asm is the JAX package's,
    byte for byte (parameters.gz decompressed: its gzip header holds the
    write time), and so is assembly_graph.gfa.unitigs.init.k5."""
    jout, pout, _ = runs[run]
    ks = _ks(pout)
    assert ks == _ks(jout) and len(ks) > 50
    for k in ks:
        a = os.path.join(jout, "tmp", f"pass_k{k}")
        b = os.path.join(pout, "tmp", f"pass_k{k}")
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in GRAPH_FILES:
            assert open(os.path.join(a, name), "rb").read() == \
                open(os.path.join(b, name), "rb").read(), (k, name)
        assert gzip.open(os.path.join(a, "parameters.gz")).read() == \
            gzip.open(os.path.join(b, "parameters.gz")).read(), k
    name = "assembly_graph.gfa.unitigs.init.k5"
    assert open(os.path.join(jout, "tmp", name), "rb").read() == \
        open(os.path.join(pout, "tmp", name), "rb").read()


GFA_CASES = [("smallest", []), ("smallest", ["--coverage", "--readpath"]),
             ("largest", []), ("largest", ["--coverage", "--readpath"]),
             ("largest", ["--output", "x.gfa"])]


@pytest.mark.parametrize("run", ["isolate", "metagenome"])
@pytest.mark.parametrize("which,flags", GFA_CASES,
                         ids=["-".join([w] + f) for w, f in GFA_CASES])
def test_gfa_matches_jax(runs, tmp_path, run, which, flags):
    """The port's `gfa` writes the JAX package's files, on copies of one
    output directory, and removes tmp/gfaAlignments.bin as it does."""
    _, pout, _ = runs[run]
    ks = _ks(pout)
    k = str(ks[0] if which == "smallest" else ks[-1])
    jdir, pdir = _copy(pout, tmp_path / "j"), _copy(pout, tmp_path / "p")

    def args(d):
        return [a if a != "x.gfa" else os.path.join(d, a) for a in flags]

    with host_only():
        jax_main(["gfa", jdir, k, *args(jdir)])
    assert port_main(["gfa", pdir, k, *args(pdir), "--device", "cpu"]) == 0
    want, got = _outputs(jdir), _outputs(pdir)
    expected = 5 if "--readpath" in flags else 4
    assert len(want) == expected, sorted(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    for d in (jdir, pdir):
        assert not os.path.exists(os.path.join(d, "tmp", "gfaAlignments.bin"))


def test_gfa_listing_and_unknown_k(runs, capsys):
    """`gfa <dir> 0` prints the JAX package's listing and returns the same
    k; an unknown k raises the same SystemExit in `gfa` and `map`."""
    from metamdbg_tpu.pipeline import gfa as jax_gfa
    from metamdbg_tpu.pipeline import mapref as jax_mapref

    _, pout, _ = runs["metagenome"]
    capsys.readouterr()
    want = jax_gfa.run_gfa(pout, 0)
    want_text = capsys.readouterr().out
    got = port_gfa.run_gfa(pout, 0, device="cpu")
    got_text = capsys.readouterr().out
    assert got == want and len(got) > 50
    assert got_text == want_text and "  k=5\t~" in got_text
    with pytest.raises(SystemExit) as jexc:
        jax_gfa.run_gfa(pout, 3)
    with pytest.raises(SystemExit) as pexc:
        port_gfa.run_gfa(pout, 3, device="cpu")
    assert str(pexc.value) == str(jexc.value)
    with pytest.raises(SystemExit) as jexc:
        jax_mapref.run_map(pout, 3, [])
    with pytest.raises(SystemExit) as pexc:
        port_mapref.run_map(pout, 3, [], device="cpu")
    assert str(pexc.value) == str(jexc.value)


def _references(run, genomes, d):
    """The `map` references of a run: for the isolate, its genome as two
    records of one multi-line FASTA, three quarters and a quarter (the
    second lowercase in part, with Ns), and an unrelated genome in a second
    file without a final newline; for the metagenome, its three genomes in
    two files, the first holding two records."""
    def text(g):
        return g.tobytes().decode()

    if run == "isolate":
        g = text(genomes[0])
        cut = len(g) * 3 // 4
        second = g[cut:cut + 3000].lower() + "NNNNN" + g[cut + 3005:]
        other = text(datagen.random_genome(30_000, seed=77))
        return [_write_fasta(d / "genome.fasta",
                             [("first", g[:cut]), ("second", second)]),
                _write_fasta(d / "other.fa", [("other", other)],
                             final_newline=False)]
    gs = [text(g) for g in genomes]
    return [_write_fasta(d / "two.fasta", [("g0", gs[0]), ("g1", gs[1])],
                         width=80),
            _write_fasta(d / "third.fasta", [("g2", gs[2])])]


@pytest.mark.parametrize("run", ["isolate", "metagenome"])
def test_map_matches_jax(runs, tmp_path, run):
    """The port's `map` colours the same unitigs as the JAX package's, at
    the smallest and the largest saved k. The JAX package parses the FASTA
    references in Python, the port with the native decoder: multi-line
    records, lowercase bases, Ns and a last record without a newline must
    give the same bytes."""
    _, pout, genomes = runs[run]
    refs = _references(run, genomes, tmp_path)
    ks = _ks(pout)
    jdir, pdir = _copy(pout, tmp_path / "j"), _copy(pout, tmp_path / "p")
    coloured = set()
    for k in (ks[0], ks[-1]):
        with host_only():
            jax_main(["map", jdir, str(k), "--references", *refs])
        assert port_main(["map", pdir, str(k), "--references", *refs,
                          "--device", "cpu"]) == 0
        want, got = _outputs(jdir), _outputs(pdir)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name
        names = want[f"assemblyGraph_k{k}.contigName.csv"].decode()
        coloured |= {line.split(",")[1] for line in names.splitlines()[1:]}
    assert len(coloured) >= (1 if run == "isolate" else 3), coloured


def test_blocked_launcher_gfa_and_map(runs, tmp_path):
    """`gfa --coverage --readpath` and `map` through the e2e tests' launcher,
    with jax and the JAX package refused and os.fork raising, write the
    JAX package's files."""
    _, pout, genomes = runs["metagenome"]
    refs = _references("metagenome", genomes, tmp_path)
    k = str(_ks(pout)[0])
    jdir, pdir = _copy(pout, tmp_path / "j"), _copy(pout, tmp_path / "p")
    with host_only():
        jax_main(["gfa", jdir, k, "--coverage", "--readpath"])
        jax_main(["map", jdir, k, "--references", *refs])
    for args in (["gfa", pdir, k, "--coverage", "--readpath"],
                 ["map", pdir, k, "--references", *refs]):
        proc = run_port([*args, "--device", "cpu"], timeout=120)
        assert proc.returncode == 0, proc.stderr[-4000:]
    want, got = _outputs(jdir), _outputs(pdir)
    assert len(want) == 7 and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# -- unit cases ---------------------------------------------------------------

def _edge_sequences(l, seed):
    """Base codes and bad masks at lengths l, l + 1, TILE_LEN and past it
    (split segments), with bad bases at the ends of some."""
    rng = np.random.default_rng(seed)
    codes, bads = [], []
    for n in (l, l + 1, l + 2, 2 * l, TILE_LEN, TILE_LEN + 1,
              TILE_LEN + 3000, 2 * TILE_LEN + 7):
        for rep in range(12):
            c = rng.integers(0, 4, size=n, dtype=np.uint8)
            b = rng.random(n) < 0.002
            if rep % 3 == 1:
                b[0] = True
            if rep % 3 == 2:
                b[-1] = True
            codes.append(c)
            bads.append(b)
    return codes, bads


@pytest.mark.parametrize("trim", [0, 1])
@pytest.mark.parametrize("density", [0.005, 0.3])
def test_batch_sketcher_trim_matches_select_minimizers(trim, density):
    """BatchSketcher(trim=t) against the JAX package's numpy golden path
    select_minimizers_numpy(trim=t), with a blacklist: windows 0 and nk-1
    are selected exactly when trim is 0."""
    from metamdbg_tpu.sketch.minimizers import select_minimizers_numpy

    l = 15
    codes, bads = _edge_sequences(l, seed=5)
    want = [select_minimizers_numpy(c, b, l, density, None, trim)
            for c, b in zip(codes, bads)]
    chosen = np.concatenate([w[0] for w in want])
    repetitive = np.unique(chosen[::7])
    want = [select_minimizers_numpy(c, b, l, density, repetitive, trim)
            for c, b in zip(codes, bads)]
    got = BatchSketcher(l, density, repetitive, "cpu",
                        trim=trim).sketch_many(codes, bads)
    ends = 0
    for (gv, gp, gd), (wv, wp, wd), c in zip(got, want, codes):
        assert np.array_equal(gv, wv) and np.array_equal(gp, wp) and \
            np.array_equal(gd, wd)
        ends += int(wp.size > 0 and (wp[0] == 0 or
                                     wp[-1] == c.shape[0] - l))
    assert (ends > 0) == (trim == 0 and density > 0.1)


def _alignments(out, k):
    """(unitig records, per-unitig alignment tuples, read sequences) of
    pass k, as run_gfa makes them, from the JAX package's mapper."""
    from metamdbg_tpu.basespace import postprocess as jpost
    from metamdbg_tpu.io import fastq as jfastq

    tmp = os.path.join(out, "tmp")
    unitigs_file = os.path.join(tmp, f"pass_k{k}", GRAPH_FILES[1])
    aln = os.path.join(tmp, "unit_alignments.bin")
    jpost.run_read_vs_contig_mapper(os.path.join(tmp, "read_data_init.txt"),
                                    unitigs_file, aln)
    unitigs = list(records.read_read_data(unitigs_file, with_quality=False))
    per_unitig = {i: [] for i in range(len(unitigs))}
    for al in jpost.read_alignments(aln):
        per_unitig[al[1]].append(al)
    os.remove(aln)
    paths = [line.strip() for line in open(os.path.join(tmp, "input.txt"))]
    seqs = {r.index: r.seq for r in jfastq.iter_reads(paths,
                                                      need_headers=False)}
    return unitigs, per_unitig, seqs


def test_reconstruct_unpolished_matches_jax(runs):
    """The port's reconstruct_unpolished drafts each unitig of the
    metagenome's smallest k as the JAX package's does, on the same
    Mappings."""
    from metamdbg_tpu.basespace import reconstruct as jrec
    from metamdbg_tpu.basespace import tiling as jtiling
    from metamdbg_tpu_torch.basespace import reconstruct as prec
    from metamdbg_tpu_torch.basespace import tiling as ptiling

    _, pout, _ = runs["metagenome"]
    unitigs, per_unitig, seqs = _alignments(pout, _ks(pout)[0])
    avg_dist = float(1.0 / np.float32(0.005))
    drafts = 0
    with host_only():
        for i, rec in enumerate(unitigs):
            want = jrec.reconstruct_unpolished(
                rec.minimizers, rec.is_circular,
                [jtiling.Mapping(al) for al in per_unitig[i]], seqs,
                avg_dist)
            got = prec.reconstruct_unpolished(
                rec.minimizers, rec.is_circular,
                [ptiling.Mapping(al) for al in per_unitig[i]], seqs,
                avg_dist, "cpu")
            assert (got is None) == (want is None), i
            if want is not None:
                assert np.array_equal(got, want), i
                drafts += 1
    assert len(unitigs) > 20 and drafts >= 3


def _write_minimizer_records(path, seqs, circular=()):
    with open(path, "wb") as f:
        for i, m in enumerate(seqs):
            f.write(struct.pack("<IB", len(m), 1 if i in circular else 0))
            f.write(np.asarray(m, np.uint32).tobytes())


def _unitig(rng, n):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def test_coverage_means_match_jax(tmp_path):
    """--coverage's means against the JAX package's _recomputed_coverages:
    unitigs of 0-3 minimizers (1.0), k-min-mers of count 0, 1 (not kept)
    and > 1, absent ones (counted 1), a repeated record (the last one
    holds), and means whose %.6f text needs float64."""
    from metamdbg_tpu.count.kminmers import extract_kminmers
    from metamdbg_tpu.pipeline import gfa as jax_gfa
    from metamdbg_tpu.utils.hashing import kminmer_hash128

    rng = np.random.default_rng(8)
    unitigs = [records.MinimizerRead(i, _unitig(rng, n), None, None, None)
               for i, n in enumerate((0, 1, 3, 4, 5, 9, 40, 7, 300))]
    keys = np.concatenate([kminmer_hash128(extract_kminmers(u.minimizers,
                                                            4)[0])
                           for u in unitigs])
    pick = rng.permutation(keys.shape[0])[:keys.shape[0] * 2 // 3]
    counts = rng.choice([0, 1, 2, 3, 7, 1000003], size=pick.size)
    rows = [(int(keys[i, 1]), int(keys[i, 0]), int(c))
            for i, c in zip(pick, counts)]
    rows += [(int(keys[pick[0], 1]), int(keys[pick[0], 0]), 5),
             (int(keys[pick[1], 1]), int(keys[pick[1], 0]), 1)]
    rows += [(int(x), int(y), 9) for x, y in
             rng.integers(0, 1 << 63, size=(20, 2))]
    with open(tmp_path / "kminmerData_abundance_init.txt", "wb") as f:
        for lo, hi, c in rows:
            f.write(struct.pack("<QQI", lo, hi, c))
    want = jax_gfa._recomputed_coverages(str(tmp_path), unitigs)
    got = port_gfa._recomputed_coverages(str(tmp_path), unitigs, "cpu")
    assert got == want
    assert [f"{x:.6f}" for x in got] == [f"{x:.6f}" for x in want]
    assert want[:3] == [1.0, 1.0, 1.0] and len(set(want)) > 4


def _path_dir(tmp_path, unitigs, contigs, reads=None):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    _write_minimizer_records(tmp / "contig_data_final.bin", contigs)
    if reads is not None:
        with records.ReadDataWriter(str(tmp / "read_data_init.txt"),
                                    True) as w:
            for i, m in enumerate(reads):
                n = len(m)
                w.write(records.MinimizerRead(
                    i, np.asarray(m, np.uint32), np.arange(n, dtype=np.uint32),
                    np.zeros(n, np.uint8), np.zeros(n, np.uint8), 20.0,
                    1000))
    unitig_records = [records.MinimizerRead(i, np.asarray(u, np.uint32),
                                            None, None, None)
                      for i, u in enumerate(unitigs)]
    return str(tmp), unitig_records


def test_contig_and_read_paths_last_unitig_wins(tmp_path):
    """A k-min-mer in two unitigs belongs to the later one (the JAX
    package's dict overwrite in unitig order); windows missing from the
    table are skipped, consecutive repeats dropped, and `ctg<i>` counts the
    skipped contigs too."""
    from metamdbg_tpu.pipeline import gfa as jax_gfa

    rng = np.random.default_rng(3)
    k = 4
    shared = _unitig(rng, k)
    a, b, c = _unitig(rng, 10), _unitig(rng, 8), _unitig(rng, 6)
    unitigs = [np.concatenate([a, shared]), np.concatenate([shared, b]), c,
               shared[::-1].copy()]
    contigs = [shared, _unitig(rng, 9), np.concatenate([a, shared, b, c]),
               np.concatenate([c, c[:3], _unitig(rng, 5), c]), a[:3]]
    reads = [np.concatenate([b[::-1], shared]), _unitig(rng, 4), a]
    tmp, unitig_records = _path_dir(tmp_path, unitigs, contigs, reads)
    names = [f"utg{i + 1}" for i in range(len(unitigs))]
    params = records.Parameters(kminmer_size=k)
    jax_gfa._generate_contig_path(tmp, str(tmp_path / "jax"), params,
                                  unitig_records, names)
    jax_gfa._generate_read_path(tmp, str(tmp_path / "jax"), params,
                                unitig_records, names)
    port_gfa._generate_paths(tmp, str(tmp_path / "port"), params,
                             unitig_records, names, True, "cpu")
    for suffix in ("_contigPath.tsv", "_contigNames.csv", "_readPath.tsv"):
        want = open(str(tmp_path / "jax") + suffix).read()
        assert open(str(tmp_path / "port") + suffix).read() == want, suffix
    path = open(str(tmp_path / "port") + "_contigPath.tsv").read()
    # the shared k-min-mer (and its reverse) is the last unitig's, utg4
    assert path.splitlines()[0] == "ctg0\tutg4"
    assert path.splitlines()[1].startswith("ctg2\tutg1\tutg4\t")


def _map_dir(tmp_path, params, unitigs):
    """An output directory holding one saved graph, k=9, with `unitigs`."""
    pass_dir = tmp_path / "out" / "tmp" / "pass_k9"
    pass_dir.mkdir(parents=True)
    params.save(str(pass_dir / "parameters.gz"))
    _write_minimizer_records(pass_dir / GRAPH_FILES[1], unitigs)
    with open(pass_dir / GRAPH_FILES[0], "w") as f:
        for i, u in enumerate(unitigs):
            f.write(f"S\tutg{i + 1}\t*\tLN:i:{len(u)}\tdp:i:3\n")
    return str(tmp_path / "out")


def test_map_first_reference_wins_and_strict_majority(tmp_path):
    """A k-min-mer in two references belongs to the first (the JAX
    package's setdefault in reference order); a unitig needs a strict
    majority of its k-min-mers: at exactly half it is not coloured, one
    more and it is."""
    from metamdbg_tpu.pipeline import mapref as jax_mapref
    from metamdbg_tpu.sketch import kmers as jkmers
    from metamdbg_tpu.sketch import minimizers as jmin
    from metamdbg_tpu.sketch import rle as jrle

    params = records.Parameters(kminmer_size=4, density_assembly=0.05,
                                use_homopolymer_compression=True)
    g0 = datagen.random_genome(30_000, seed=11)
    g1 = np.concatenate([datagen.random_genome(8_000, seed=12),
                         g0[10_000:20_000],
                         datagen.random_genome(8_000, seed=13)])
    refs = [_write_fasta(tmp_path / "a.fa", [("g0", g0.tobytes().decode())]),
            _write_fasta(tmp_path / "b.fa", [("g1", g1.tobytes().decode())])]

    def mins(g):
        codes, bad = jkmers.base_codes(jrle.rle_encode(g, True)[0])
        return jmin.select_minimizers_numpy(codes, bad, 15, 0.05)[0]

    m0, m1 = mins(g0), mins(g1)
    # the copied region: a run of m1 found in m0
    start = next(i for i in range(m1.size) if m1[i] in set(m0.tolist())
                 and m1[i + 1:i + 40].tolist() == m0[
                     np.flatnonzero(m0 == m1[i])[0] + 1:
                     np.flatnonzero(m0 == m1[i])[0] + 40].tolist())
    shared = m1[start:start + 30]
    own1 = m1[:20]
    half = np.concatenate([m0[-23:], own1])    # 20 + 17 of 40 windows
    more = np.concatenate([m0[-24:], own1])    # 21 of 41
    unitigs = [shared, own1, half, more, m0[:3]]
    out = _map_dir(tmp_path, params, unitigs)
    jdir, pdir = _copy(out, tmp_path / "j"), _copy(out, tmp_path / "p")
    with host_only():
        jax_mapref.run_map(jdir, 9, refs)
    port_mapref.run_map(pdir, 9, refs, device="cpu")
    want, got = _outputs(jdir), _outputs(pdir)
    assert got == want
    assert want["assemblyGraph_k9.contigName.csv"].decode().splitlines() == [
        "Name,ReferenceName", "utg1,a.fa:0", "utg2,b.fa:0", "utg4,a.fa:0"]


def test_key_table_first_and_last(tmp_path):
    """key_table keeps a repeated key's first or last value, on keys that
    differ in h1 only, in h2 only and in the sign bit."""
    h1 = torch.tensor([5, -1, 5, 7, -1, 5, 0], dtype=torch.int64)
    h2 = torch.tensor([1, 2, 1, 1, 2, -9, 1], dtype=torch.int64)
    v = torch.arange(7, dtype=torch.int64)
    q1 = torch.tensor([5, -1, 7, 5, 0, 6])
    q2 = torch.tensor([1, 2, 1, -9, 1, 1])
    first, hit = port_gfa.key_table(h1, h2, v, last=False).lookup(q1, q2, -1)
    last, _ = port_gfa.key_table(h1, h2, v, last=True).lookup(q1, q2, -1)
    assert first.tolist() == [0, 1, 3, 5, 6, -1]
    assert last.tolist() == [2, 4, 3, 5, 6, -1]
    assert hit.tolist() == [True] * 5 + [False]
