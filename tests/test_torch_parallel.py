"""The port's multi-GPU path (metamdbg_tpu_torch/parallel/) against the JAX
package's mesh functions, tolerance 0: everything is integers or bytes.

Each world size (2 and 3 ranks) is launched once for the module: N
subprocesses run tests/torch_rank_worker.py over gloo on the CPU, with jax
and the JAX package refused, and every case runs in that launch. The JAX
side runs here, on conftest's 8-device CPU mesh. Held on every rank:
- K5: count_table's keys and counts against parallel.count_table;
- K6: pair_join's counts and matches against pair_join_mesh, an empty
  table and an empty query set included;
- the first pass with a group against run_graph_first_pass(mesh=...);
- the correction mapper with a group against run_read_mapper(mesh=...),
  readAlignmentsLowDensity.bin byte for byte, one chunk and several;
- the POA fan-out against poa_native.polish_windows, on 23 windows (uneven
  over 2 and 3 ranks) and on 1 (a rank with none).
"""

import datetime
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rank_worker.py")
WORLDS = (2, 3)
FIRST_PASS_ARTIFACTS = (
    "kminmerData_min.txt", "kminmerData_abundance.txt",
    "unitigGraph.nodes.bin", "unitigGraph.edges.successors.bin",
    "unitigGraph.nodes.abundances.bin", "unitigGraph.stats.bin")
K5_KS = (4, 5, 16)
K6_CASES = {  # name: (seed, table size, queries, universe)
    "dense": (3, 500, 300, 40),
    "unique": (7, 4096, 1024, 100000),
    "repeats": (11, 37, 1000, 10),   # heavy repeats across rank blocks
    "empty_table": (13, 0, 50, 10),
    "empty_queries": (17, 50, 0, 10),
}
MAPPER_CHUNKS = {"one_chunk": 10 ** 9, "several_chunks": 500}


def mesh_reads():
    """The reads of tests/test_mesh_first_pass.py:37-45."""
    rng = np.random.default_rng(11)
    reads = []
    base = rng.integers(1, 1 << 30, size=40, dtype=np.uint32)
    for i in range(37):
        start = rng.integers(0, 25)
        ln = int(rng.integers(6, 15))
        reads.append(base[start:start + ln].copy())
        if i % 3 == 0:
            reads.append(base[start:start + ln].copy())
    return reads


def multihost_reads():
    """The reads of tests/test_multihost.py:60-68."""
    rng = np.random.default_rng(23)
    reads = []
    base = rng.integers(1, 1 << 30, size=60, dtype=np.uint32)
    for i in range(41):
        start = int(rng.integers(0, 40))
        ln = int(rng.integers(6, 18))
        reads.append(base[start:start + ln].copy())
        if i % 3 == 0:
            reads.append(base[start:start + ln].copy())
    return reads


READ_SETS = {"mesh": mesh_reads, "multihost": multihost_reads}


def k6_input(seed, nt, nq, universe):
    """tests/test_pair_join.py:38-44's pairs."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, universe, nt).astype(np.uint64) * \
        np.uint64(0x100000001)
    queries = rng.integers(0, universe, nq).astype(np.uint64) * \
        np.uint64(0x100000001)
    return tbl, queries


def mapper_reads():
    """tests/test_pair_join.py::test_mapper_mesh_byte_identical's reads,
    as (minimizers, positions, directions)."""
    rng = np.random.default_rng(5)
    reads = []
    base = rng.integers(1, 1 << 31, size=400, dtype=np.uint32)
    for i in range(60):
        start = int(rng.integers(0, 340))
        ln = int(rng.integers(15, 60))
        mins = base[start:start + ln].copy()
        if i % 4 == 0:
            mins[rng.integers(0, ln)] ^= 12345  # noise
        pos = np.sort(rng.integers(0, 20000, ln)).astype(np.uint32)
        dirs = rng.integers(0, 2, ln).astype(np.uint8)
        reads.append((mins, pos, dirs))
    return reads


def polish_batch():
    """tests/test_multihost.py:111-125's 23 windows."""
    rng = np.random.default_rng(77)
    batch = []
    for _w in range(23):
        bb = rng.integers(65, 69, size=int(rng.integers(180, 320))).astype(
            np.uint8)
        frags = []
        for _f in range(int(rng.integers(2, 6))):
            s = bb.copy()
            for _m in range(int(rng.integers(0, 4))):
                s[int(rng.integers(0, s.shape[0]))] = int(
                    rng.integers(65, 69))
            a = int(rng.integers(0, 20))
            b = s.shape[0] - int(rng.integers(0, 20))
            frags.append((s[a:b].tobytes(), bytes([60]) * (b - a), a, b - 1))
        frags.sort(key=lambda t: (t[2], t[0]))
        batch.append((bb.tobytes(), frags))
    return batch


def cases():
    return {
        "k5": {f"{name}_k{k}": (make(), k)
               for name, make in READ_SETS.items() for k in K5_KS},
        "k6": {name: k6_input(*args) for name, args in K6_CASES.items()},
        "first_pass": {name: (make(), 4) for name, make in READ_SETS.items()},
        "first_pass_artifacts": FIRST_PASS_ARTIFACTS,
        "mapper": {name: (mapper_reads(), chunk, 62)
                   for name, chunk in MAPPER_CHUNKS.items()},
        "polish": {"23_windows": polish_batch(),
                   "1_window": polish_batch()[:1]},
    }


CASES = cases()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """world -> the results of each rank of one launch of that many
    ranks; the cases too."""
    d = tmp_path_factory.mktemp("ranks")
    path = str(d / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(CASES, f)
    procs = []
    for world in WORLDS:  # both launches at once, a group each
        (d / f"world{world}").mkdir()
        port = _free_port()
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=REPO,
                       METAMDBG_TPU_DISTRIBUTED="1",
                       METAMDBG_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       METAMDBG_TPU_NUM_PROCESSES=str(world),
                       METAMDBG_TPU_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, path, str(d / f"world{world}")],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    out = {}
    for world in WORLDS:
        out[world] = []
        for rank in range(world):
            with open(d / f"world{world}" / f"rank{rank}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out


_JAX: dict = {}


def jax_once(key, fn):
    """The JAX side of a case, computed once for both world sizes."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:8]), ("data",))


def _padded(reads, k, ndev):
    """count_kminmers_mesh's padded rows (kminmers.py:270-278)."""
    n_rows = ((max(len(reads), 1) + ndev - 1) // ndev) * ndev
    width = max(max(r.shape[0] for r in reads), k)
    mins = np.zeros((n_rows, width), np.uint32)
    lens = np.zeros(n_rows, np.int32)
    for i, m in enumerate(reads):
        mins[i, :m.shape[0]] = m
        lens[i] = m.shape[0]
    return mins, lens


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_sharded(launches, world):
    """Each rank was in a group of `world` over gloo, production_group()
    handed it out, and every sharded function ran on it."""
    for rank, res in enumerate(launches[world]):
        assert res["describe"] == {"rank": rank, "world_size": world,
                                   "transport": "gloo"}
        assert res["grouped"]
        act = res["activity"]
        assert act["count_table"]["calls"] >= len(READ_SETS) * len(K5_KS)
        assert act["pair_join"]["calls"] >= 3
        assert act["polish"]["calls"] == 2
        # 23 windows round-robin, then 1 window (rank 0's)
        assert act["polish"]["windows"] == len(range(rank, 23, world)) + \
            (rank == 0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [f"{n}_k{k}" for n in READ_SETS
                                  for k in K5_KS])
def test_count_table_matches_jax(launches, mesh, world, name):
    from metamdbg_tpu.parallel.count_table import count_table
    reads, k = CASES["k5"][name]
    keys, counts = jax_once(("k5", name), lambda: count_table(
        mesh, *_padded(reads, k, 8), k))
    for res in launches[world]:
        got_keys, got_counts = res["k5"][name]
        assert np.array_equal(got_keys, keys)
        assert np.array_equal(got_counts, counts.astype(np.int64))
    if k == 4:
        assert keys.shape[0] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(K6_CASES))
def test_pair_join_matches_jax(launches, mesh, world, name):
    from metamdbg_tpu.parallel.pair_join import pair_join_mesh
    tbl, queries = CASES["k6"][name]
    counts, matches = jax_once(("k6", name), lambda: pair_join_mesh(
        mesh, tbl, queries))
    for res in launches[world]:
        got_counts, got_matches = res["k6"][name]
        assert np.array_equal(got_counts, counts)
        assert np.array_equal(got_matches, matches)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(READ_SETS))
def test_first_pass_matches_jax(launches, mesh, tmp_path, world, name):
    from metamdbg_tpu.graph import stage
    reads, k = CASES["first_pass"][name]

    def run():
        os.makedirs(tmp_path / "smallContigs")
        stage.run_graph_first_pass(str(tmp_path), k, 0, reads=reads,
                                   mesh=mesh)
        return {art: open(tmp_path / art, "rb").read()
                for art in FIRST_PASS_ARTIFACTS}

    want = jax_once(("first_pass", name), run)
    for res in launches[world]:
        for art in FIRST_PASS_ARTIFACTS:
            assert len(want[art]) > 0, art
            assert res["first_pass"][name][art] == want[art], art


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(MAPPER_CHUNKS))
def test_mapper_matches_jax(launches, mesh, tmp_path, world, name):
    from metamdbg_tpu.correction import mapper
    from metamdbg_tpu.io import records
    reads, chunk, band = CASES["mapper"][name]
    path = str(tmp_path / "jax.bin")

    def run():
        mapper.run_read_mapper(
            [records.MinimizerRead(i, m, p, d, None)
             for i, (m, p, d) in enumerate(reads)], chunk, band,
            alignment_path=path, mesh=mesh)
        return open(path, "rb").read()

    want = jax_once(("mapper", name), run)
    assert len(want) > 0
    for res in launches[world]:
        assert res["mapper"][name] == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["23_windows", "1_window"])
def test_polish_fan_out_matches_jax(launches, world, name):
    from metamdbg_tpu.basespace import poa_native
    batch = CASES["polish"][name]
    want = jax_once(("polish", name), lambda: poa_native.polish_windows(
        batch, n_threads=1))
    for res in launches[world]:
        got = res["polish"][name]
        assert len(got) == len(want)
        for (gc, gv), (wc, wv) in zip(got, want):
            assert gc == wc
            assert gv.dtype == np.uint32
            assert np.array_equal(gv, np.asarray(wv))


@pytest.mark.parametrize("n,world", [(0, 2), (1, 2), (7, 2), (23, 3),
                                     (2, 3), (100, 4)])
def test_helpers_match_jax(monkeypatch, n, world):
    """process_read_range, shard_indices, pack_planes and unpack_planes
    against the JAX package's, in this process."""
    import jax

    from metamdbg_tpu.parallel import multihost as jmulti
    from metamdbg_tpu.parallel import polish_mesh as jpolish
    from metamdbg_tpu_torch.parallel import multihost, polish_mesh

    monkeypatch.setattr(jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        assert multihost.process_read_range(n, rank, world) == \
            jmulti.process_read_range(n)
        assert polish_mesh.shard_indices(n, rank, world) == \
            jpolish.shard_indices(n, rank, world)
    rng = np.random.default_rng(n)
    res = [(rng.integers(65, 69, int(rng.integers(0, 9))).astype(
        np.uint8).tobytes(), rng.integers(0, 1 << 32, 9).astype(np.uint32))
        for _ in range(n)]
    res = [(c, v[:len(c)]) for c, v in res]
    n_max, w_max = max(n, 1), 9
    planes = polish_mesh.pack_planes(res, n_max, w_max)
    want = jpolish.pack_planes(res, n_max, w_max)
    for a, b in zip(planes, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    stacked = [np.stack([p] * world) for p in planes]
    got = polish_mesh.unpack_planes(n, world, *stacked)
    want = jpolish.unpack_planes(n, world, *stacked)
    assert len(got) == len(want)
    for (gc, gv), (wc, wv) in zip(got, want):
        assert gc == wc and np.array_equal(gv, wv)


def test_production_group_gate():
    """production_group() is None with no group and with a one-rank group;
    ensure_distributed does nothing without METAMDBG_TPU_DISTRIBUTED."""
    import torch.distributed as dist

    from metamdbg_tpu_torch import parallel

    assert not dist.is_initialized()
    assert parallel.production_group() is None
    assert parallel.ensure_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        assert parallel.production_group() is None
        assert parallel.describe() == {"rank": 0, "world_size": 1,
                                       "transport": "gloo"}
    finally:
        parallel.shutdown()
    assert not dist.is_initialized()


def test_nccl_backend_refused_on_cpu(monkeypatch):
    """METAMDBG_TPU_DIST_BACKEND=nccl with --device cpu raises at startup,
    before any group starts."""
    import torch.distributed as dist

    from metamdbg_tpu_torch import parallel

    monkeypatch.setenv("METAMDBG_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("METAMDBG_TPU_DIST_BACKEND", "nccl")
    with pytest.raises(ValueError, match="nccl"):
        parallel.ensure_distributed("cpu")
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_one_rank_nccl_matches_single_device(monkeypatch):
    """count_table and pair_join on a one-rank NCCL group, on CUDA tensors,
    against the single-device route (count_kminmers' keys and counts, the
    sorted searchsorted join)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    from metamdbg_tpu_torch import parallel
    from metamdbg_tpu_torch.count import kminmers
    from metamdbg_tpu_torch.kernels import window_hash
    from metamdbg_tpu_torch.parallel import count_table, pair_join

    monkeypatch.setenv("METAMDBG_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("METAMDBG_TPU_COORDINATOR",
                       f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("METAMDBG_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("METAMDBG_TPU_PROCESS_ID", "0")
    monkeypatch.delenv("METAMDBG_TPU_DIST_BACKEND", raising=False)
    dev = parallel.ensure_distributed("cuda")
    import torch.distributed as dist
    try:
        assert dist.get_backend() == "nccl"
        group = dist.group.WORLD
        for reads in (mesh_reads(), multihost_reads()):
            h1, h2, counts = count_table.count_table(reads, 4, dev, group)
            rows, _, _, _ = kminmers.batch_extract_kminmers(reads, 4, dev)
            uniq, want = kminmers.count_unique_rows(rows)
            w1, w2 = window_hash.hash_rows(uniq)
            order = kminmers.sort_pairs(w1, w2)
            assert torch.equal(h1, w1[order]) and torch.equal(h2, w2[order])
            assert torch.equal(counts, want[order])
        for name, args in K6_CASES.items():
            tbl, queries = k6_input(*args)
            t = torch.from_numpy(tbl.view(np.int64)).to(dev)
            q = torch.from_numpy(queries.view(np.int64)).to(dev)
            counts, matches = pair_join.pair_join(t, q, group)
            order = np.argsort(tbl, kind="stable")
            lo = np.searchsorted(tbl[order], queries, side="left")
            hi = np.searchsorted(tbl[order], queries, side="right")
            want = np.concatenate([order[a:b] for a, b in zip(lo, hi)]
                                  + [np.zeros(0, np.int64)])
            assert np.array_equal(counts.cpu().numpy(), hi - lo), name
            assert np.array_equal(matches.cpu().numpy(), want), name
    finally:
        parallel.shutdown()
