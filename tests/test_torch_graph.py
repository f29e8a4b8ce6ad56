"""The port's minimizer-space ladder (metamdbg_tpu_torch/graph/) against the
JAX package's (metamdbg_tpu/graph/) on the same reads, on the CPU.

Both chains start from one read selection of a tests/datagen.py input and
run, pass by pass: the first pass (k=4), the second pass (k=5), then
multiplex passes to k=13, each followed by the contig stage and
toMinspace, in the order of pipeline/asm.py. Every artifact is compared
byte for byte (tolerance 0): kminmerData_*, unitigGraph.*, filter dumps at
every cutoff, contigs.nodepath, refined abundances, unitig_data.txt,
smallContigs_k*.bin, and contig_data_init.txt at the last pass.
"""

import glob
import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import datagen
import simplify_scale
from metamdbg_tpu_torch.graph import contigs as pcontigs
from metamdbg_tpu_torch.graph import filter_graph as pfilter
from metamdbg_tpu_torch.graph import multiplex as pmultiplex
from metamdbg_tpu_torch.graph import simplify as psimplify
from metamdbg_tpu_torch.graph import stage as pstage
from metamdbg_tpu_torch.io import records as precords

FIRST_K, LAST_K = 4, 13
CPU = torch.device("cpu")

ARTIFACTS = ("kminmerData_abundance.txt", "unitigGraph.nodes.bin",
             "unitigGraph.edges.successors.bin",
             "unitigGraph.nodes.abundances.bin", "unitigGraph.stats.bin",
             "contigs.nodepath", "unitigGraph.nodes.refined_abundances.bin",
             "unitig_data.txt")


def _params(mod, k, prev_k):
    spacing = 1 / np.float32(0.005)
    return mod.Parameters(
        minimizer_size=15, kminmer_size=k, density_assembly=0.005,
        kminmer_size_first=FIRST_K, minimizer_spacing_mean=float(spacing),
        kminmer_length_mean=float(spacing * np.float32(k - 1)),
        kminmer_overlap_mean=float(spacing * np.float32(k - 1) - spacing),
        kminmer_size_prev=prev_k, kminmer_size_last=LAST_K,
        mean_read_length=8000, density_correction=0.025,
        use_homopolymer_compression=True, data_type=0, snpmer_size=21)


def _pass_files(d, k):
    names = list(ARTIFACTS)
    if k <= FIRST_K + 1:
        names.append("kminmerData_min.txt")
    names.append(os.path.join("smallContigs", f"smallContigs_k{k}.bin"))
    names += sorted(os.path.relpath(p, d) for p in
                    glob.glob(os.path.join(d, "filter", "unitigs_*.bin")))
    return {n: open(os.path.join(d, n), "rb").read() for n in names}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Per pass k: {artifact: bytes} of the JAX chain and of the port's."""
    from metamdbg_tpu.graph import contigs as jcontigs
    from metamdbg_tpu.graph import multiplex as jmultiplex
    from metamdbg_tpu.graph import stage as jstage
    from metamdbg_tpu.io import records as jrecords
    from metamdbg_tpu.sketch import read_selection

    base = tmp_path_factory.mktemp("ladder")
    fq = str(base / "reads.fastq.gz")
    datagen.make_test_fastq(fq, genome_len=60_000, coverage=15,
                            mean_length=8000, error_rate=0.002, seed=5)
    sel = str(base / "sel")
    os.makedirs(sel)
    read_selection.run_read_selection([fq], sel,
                                      _params(jrecords, FIRST_K, FIRST_K),
                                      skip_correction=True)
    dirs = {}
    for side in ("jax", "port"):
        d = str(base / side)
        shutil.copytree(sel, d)
        for sub in ("filter", "smallContigs"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        dirs[side] = d

    cache = pmultiplex.ReadsCache()
    out = {"jax": {}, "port": {}}
    for k in range(FIRST_K, LAST_K + 1):
        prev_k = max(FIRST_K, k - 1)
        final = k == LAST_K
        name = "contig_data_init.txt" if final else "unitig_data.txt"
        for side, d in dirs.items():
            rec = jrecords if side == "jax" else precords
            p = _params(rec, k, prev_k)
            p.save(os.path.join(d, "parameters.gz"))
            for f in glob.glob(os.path.join(d, "filter", "*")):
                os.remove(f)
            if side == "jax":
                if k == FIRST_K:
                    jstage.run_graph_first_pass(d, k, 0)
                elif k == FIRST_K + 1:
                    jstage.run_graph_second_pass(d, k, p)
                else:
                    jmultiplex.run_graph_multiplex_pass(d, k, p)
                jcontigs.run_contig_stage(d, p)
                jcontigs.run_to_minspace(
                    d, os.path.join(d, "contigs.nodepath"),
                    os.path.join(d, name),
                    os.path.join(d, "unitigGraph.nodes.bin"), p)
            else:
                if k == FIRST_K:
                    pstage.run_graph_first_pass(d, k, 0, CPU)
                elif k == FIRST_K + 1:
                    pstage.run_graph_second_pass(d, k, p, CPU)
                else:
                    pmultiplex.run_graph_multiplex_pass(d, k, p, CPU, cache)
                pcontigs.run_contig_stage(d, p)
                pcontigs.run_to_minspace(
                    d, os.path.join(d, "contigs.nodepath"),
                    os.path.join(d, name),
                    os.path.join(d, "unitigGraph.nodes.bin"), p)
            files = _pass_files(d, k)
            if final:
                files[name] = open(os.path.join(d, name), "rb").read()
            out[side][k] = files
    return out


def _assert_same(chains, k):
    want, got = chains["jax"][k], chains["port"][k]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], f"k={k}: {name} differs"


def test_first_pass_artifacts(chains):
    files = chains["jax"][FIRST_K]
    assert len(files["unitigGraph.nodes.bin"]) > 0
    assert len(files["kminmerData_min.txt"]) > 0
    _assert_same(chains, FIRST_K)


def test_second_pass_artifacts(chains):
    _assert_same(chains, FIRST_K + 1)


@pytest.mark.parametrize("k", range(FIRST_K + 2, LAST_K + 1))
def test_multiplex_pass_artifacts(chains, k):
    """Every multiplex pass, its contig stage and toMinspace."""
    assert len(chains["jax"][k]["unitigGraph.nodes.bin"]) > 0
    _assert_same(chains, k)


def test_final_contig_data(chains):
    files = chains["jax"][LAST_K]
    assert len(files["contig_data_init.txt"]) > 0
    assert any(n.startswith("filter") for n in files)


@pytest.mark.parametrize("seed", range(6))
def test_build_unitig_graph_matches_jax_package(seed):
    """build_unitig_graph on nodes with circular unitigs (anchored in either
    orientation), branching repeats (join groups with several pairs on
    each side) and linear chains: the same sequences, order and successor
    lists as metamdbg_tpu.graph.mdbg."""
    from metamdbg_tpu.count.kminmers import count_unique_rows, \
        normalize_rows
    from metamdbg_tpu.graph import mdbg as jmdbg
    from metamdbg_tpu_torch.graph import mdbg as pmdbg

    k = 4
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            .astype(np.uint32) for n in (30, 25, 18, 12)]
    seqs[0] = np.concatenate([seqs[0], seqs[0][:k - 1]])   # circular
    rep = seqs[1][5:5 + k]                                  # a repeat
    seqs[2][3:3 + k] = rep
    seqs[3][6:6 + k] = rep[::-1]
    wins = np.concatenate([np.lib.stride_tricks.sliding_window_view(s, k)
                           for s in seqs])
    nodes, _ = count_unique_rows(normalize_rows(wins)[0])
    want = jmdbg.build_unitig_graph(nodes, k)
    got = pmdbg.build_unitig_graph(torch.from_numpy(nodes.astype(np.int64)),
                                   k)
    assert len(got.sequences) == len(want.sequences) > 3
    for a, b in zip(got.sequences, want.sequences):
        np.testing.assert_array_equal(a, b)
    assert got.successors == want.successors
    assert sum(len(x) > 1 for x in want.successors) > 0


def _convert_graph(g, mod):
    """A JAX-package FilterGraph copied into the port's classes."""
    out = mod.FilterGraph(g.k, g.spacing_mean, g.kminmer_length)
    for u in g.unitigs:
        node = mod.FilterNode(u.name, u.nb_minimizers)
        node.abundances = u.abundances.copy()
        node.abundance = u.abundance
        node.succ_fwd = list(u.succ_fwd)
        node.succ_rev = list(u.succ_rev)
        out.unitigs.append(node)
    return out


def test_simplify_scale_20k_same_output(tmp_path):
    """The 20k-segment synthetic graph of tests/test_simplify_scale.py
    simplifies to the same filter dumps in both packages."""
    g = simplify_scale.build_synthetic_filter_graph(20000)
    pg = _convert_graph(g, pfilter)
    jf = simplify_scale.run_filter(g, str(tmp_path / "jax"))
    os.makedirs(tmp_path / "port" / "filter")
    pf = psimplify.ProgressiveAbundanceFilter(pg, str(tmp_path / "port"))
    pf.execute()
    assert pf.cutoff_index == jf.cutoff_index >= 5
    assert pf.cutoff_values == jf.cutoff_values
    for i in range(jf.cutoff_index):
        name = os.path.join("filter", f"unitigs_{i}.bin")
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_canonical_cycles_batch_matches_jax_package(monkeypatch):
    """Many circular unitigs spelled in one batch (one KW launch for every
    cycle's members, a second for the reversed walks): each as the JAX
    package's one-cycle _canonical_cycle spells it, anchors read forward
    and reversed, palindromic members and cycles of one member included."""
    from metamdbg_tpu.graph import mdbg as jmdbg
    from metamdbg_tpu_torch.graph import mdbg as pmdbg

    k = 5
    rng = np.random.default_rng(17)
    rows = rng.integers(0, 1 << 32, size=(120, k), dtype=np.uint64) \
        .astype(np.uint32)
    rows[::9, k - 2:] = rows[::9, :2][:, ::-1]  # palindromes
    oriented = np.empty((240, k), np.uint32)
    oriented[0::2], oriented[1::2] = rows, rows[:, ::-1]
    order = rng.permutation(240)
    sizes = rng.integers(1, 13, size=30)
    cycles = [order[a:b].tolist() for a, b in
              zip(np.cumsum(sizes) - sizes, np.cumsum(sizes)) if b <= 240]
    calls = []
    real = pmdbg.flat_window_hashes
    monkeypatch.setattr(pmdbg, "flat_window_hashes",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    got = pmdbg._canonical_cycles(oriented, cycles, k, CPU)
    assert len(calls) == 2 and calls[0] == sum(len(c) for c in cycles)
    assert len(got) == len(cycles) > 20
    for c, g in zip(cycles, got):
        np.testing.assert_array_equal(g, jmdbg._canonical_cycle(oriented, c,
                                                                k))
    assert pmdbg._canonical_cycles(oriented, [], k, CPU) == []


def _write_reads(path, seqs):
    with open(path, "wb") as f:
        for s in seqs:
            f.write(struct.pack("<IB", s.shape[0], 0))
            f.write(s.astype(np.uint32).tobytes())


def test_reads_cache_uploads_once_per_file_identity(tmp_path, monkeypatch):
    """ReadsCache builds the reads' KW stream on the device once per file
    identity (path, mtime, size), and again after the file changes."""
    from metamdbg_tpu_torch.kernels import window_hash as kw

    uploads = []
    real = kw.Stream.to
    monkeypatch.setattr(kw.Stream, "to",
                        lambda self, d: uploads.append(len(self)) or
                        real(self, d))
    rng = np.random.default_rng(3)
    path = str(tmp_path / "read_data_corrected.txt")
    seqs = [rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            for n in (5, 0, 12, 40)]
    _write_reads(path, seqs)
    cache = pmultiplex.ReadsCache()
    first = cache.reads_stream(path, CPU)
    cache.planes[7] = "plane"
    for _ in range(3):
        assert cache.reads_stream(path, CPU) is first
        assert len(cache.reads(path)) == 4
    assert uploads == [4] and cache.planes == {7: "plane"}
    assert first.words.dtype == torch.int32
    np.testing.assert_array_equal(
        first.words.numpy().view(np.uint32),
        np.concatenate(seqs).astype(np.uint32))
    _write_reads(path, seqs[:3])
    second = cache.reads_stream(path, CPU)
    assert second is not first and uploads == [4, 3] and cache.planes == {}


def test_count_phase_makes_one_kw_request_a_pass(tmp_path, monkeypatch):
    """A ladder of the port alone to k = 8: each multiplex pass's count
    hashes every plane it needs in one KW request (segmented mode) and no
    other, the reads' stream goes up once for all the passes, and the
    reads' k-1 plane is the previous pass's k plane."""
    from metamdbg_tpu_torch.kernels import window_hash as kw
    from metamdbg_tpu_torch.sketch import read_selection as prs

    fq = str(tmp_path / "reads.fastq.gz")
    datagen.make_test_fastq(fq, genome_len=20_000, coverage=10,
                            mean_length=5000, error_rate=0.002, seed=9)
    d = str(tmp_path / "run")
    for sub in ("", "filter", "smallContigs"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    prs.run_read_selection([fq], d, _params(precords, FIRST_K, FIRST_K),
                           CPU, skip_correction=True)

    requests, uploads, in_count, active = [], [], [], [False]
    real_hash, real_to = kw.hash_segments, kw.Stream.to
    real_windows = kw.hash_windows
    real_count = pmultiplex.MultiplexPass._count_kminmers

    def count(self):
        in_count.append([])
        active[0] = True
        try:
            real_count(self)
        finally:
            active[0] = False

    def hash_segments(segments, device):
        if active[0]:
            in_count[-1].append([(s.stream.device is not None, s.w)
                                 for s in segments])
        return real_hash(segments, device)

    def hash_windows(*args, **kwargs):
        if active[0]:
            in_count[-1].append("explicit")
        return real_windows(*args, **kwargs)

    monkeypatch.setattr(pmultiplex.MultiplexPass, "_count_kminmers", count)
    monkeypatch.setattr(kw, "hash_segments", hash_segments)
    monkeypatch.setattr(kw, "hash_windows", hash_windows)
    monkeypatch.setattr(kw.Stream, "to", lambda self, dev: uploads.append(
        len(self)) or real_to(self, dev))
    cache = pmultiplex.ReadsCache()
    for k in range(FIRST_K, 9):
        p = _params(precords, k, max(FIRST_K, k - 1))
        p.save(os.path.join(d, "parameters.gz"))
        for f in glob.glob(os.path.join(d, "filter", "*")):
            os.remove(f)
        if k == FIRST_K:
            pstage.run_graph_first_pass(d, k, 0, CPU)
        elif k == FIRST_K + 1:
            pstage.run_graph_second_pass(d, k, p, CPU)
        else:
            in_count.clear()
            pmultiplex.run_graph_multiplex_pass(d, k, p, CPU, cache)
            assert len(in_count) == 1 and len(in_count[0]) == 1, in_count
            requests.append(in_count[0][0])
        pcontigs.run_contig_stage(d, p)
        pcontigs.run_to_minspace(
            d, os.path.join(d, "contigs.nodepath"),
            os.path.join(d, "unitig_data.txt"),
            os.path.join(d, "unitigGraph.nodes.bin"), p)
    # the first multiplex pass hashes the reads at k-1 and k, the later
    # ones at k only; the refined nodes and contigs go up with the request
    assert requests[0] == [(False, 5), (True, 5), (False, 5), (True, 6),
                           (False, 6)]
    for k, req in zip((7, 8), requests[1:]):
        assert req == [(False, k - 1), (False, k - 1), (True, k),
                       (False, k)]
    assert len(uploads) == 1 and uploads[0] > 0
