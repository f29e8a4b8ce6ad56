"""Kernel K2 (metamdbg_tpu_torch/kernels/count.py) and the port's
k-min-mer counting (count/kminmers.py, count/refined.py) against the JAX
package's on the CPU; K2 on CUDA against the same function on the CPU
where a GPU is present.

Inputs are made with numpy from a seed. All outputs are integers: the
comparisons are exact (tolerance 0). The JAX package is imported inside
the tests that use it, so that the GPU test runs where JAX is not
installed: ``python -m pytest tests/test_torch_count.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from metamdbg_tpu_torch.count import kminmers as pkm
from metamdbg_tpu_torch.count import refined as prefined
from metamdbg_tpu_torch.kernels import count as kcount

CPU = torch.device("cpu")


def _rows(n, k, vocab, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, vocab, size=(n, k), dtype=np.uint64)
    if vocab > 1 << 31:
        # values with the top bit set, where a packed key reaches the sign
        rows[rng.random((n, k)) < 0.2] = (1 << 32) - 1
    return rows.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))


@pytest.mark.parametrize("k", [2, 4, 5, 7, 16])
@pytest.mark.parametrize("vocab", [3, 50, 1 << 32])
def test_count_matches_jax_package(k, vocab):
    """Against _count_unique_rows_host and count_unique_rows_device (JAX on
    the CPU), in the pattern of tests/test_device_count.py."""
    from metamdbg_tpu.count.kminmers import _count_unique_rows_host
    from metamdbg_tpu.kernels.count_jax import count_unique_rows_device

    rows = _rows(3000, k, vocab, seed=k * 7 + (vocab % 97))
    rows = np.concatenate([rows, rows[::5]])   # repeats
    gu, gc = kcount.count_unique_rows(_t(rows))
    for want_u, want_c in (_count_unique_rows_host(rows),
                           count_unique_rows_device(rows)):
        np.testing.assert_array_equal(gu.numpy(), want_u)
        np.testing.assert_array_equal(gc.numpy(), want_c)


def test_sort_rows_lex_is_stable():
    rows = _rows(500, 3, 2, seed=1)
    order = kcount.sort_rows_lex(_t(rows)).numpy()
    want = np.lexsort(tuple(rows[:, j] for j in range(2, -1, -1)))
    np.testing.assert_array_equal(order, want)


def _reads(seed, n=300, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab if i % 3 else 100000,
                         size=int(rng.integers(0, 60))).astype(np.uint32)
            for i in range(n)]


@pytest.mark.parametrize("min_abundance", [0, 3])
def test_count_kminmers_matches_jax_package(min_abundance):
    from metamdbg_tpu.count import kminmers as jkm

    reads = _reads(21, n=200, vocab=40)
    want = jkm.count_kminmers(reads, 4, min_abundance,
                              max_table_bytes=1 << 40)
    got = pkm.count_kminmers(reads, 4, CPU, min_abundance,
                             max_table_bytes=1 << 40)
    assert want["rescued_rows"].shape[0] > 0 or min_abundance > 1
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


def test_bounded_count_matches_monolithic():
    reads = _reads(12)
    mono = pkm.count_kminmers(reads, 4, CPU, max_table_bytes=1 << 40)
    bounded = pkm.count_kminmers(reads, 4, CPU, max_table_bytes=2048)
    for key in mono:
        assert torch.equal(mono[key], bounded[key]), key


def test_rescue_matches_jax_package():
    from metamdbg_tpu.count import kminmers as jkm

    reads = _reads(21, n=200, vocab=40)
    rows, read_ids, _, offsets = jkm.batch_extract_kminmers(reads, 4)
    uniq, counts = jkm.count_unique_rows(rows)
    solid = counts > 1
    want = jkm._rescue(rows, read_ids, offsets, uniq[solid], counts[solid],
                       4)
    prows, pids, _, poffs = pkm.batch_extract_kminmers(reads, 4, CPU)
    np.testing.assert_array_equal(prows.numpy(), rows)
    np.testing.assert_array_equal(pids.numpy(), read_ids)
    np.testing.assert_array_equal(poffs.numpy(), offsets)
    got = pkm._rescue(prows, pids, poffs, _t(uniq[solid]),
                      _t(counts[solid]), 4)
    assert want.shape[0] > 0
    np.testing.assert_array_equal(got.numpy(), want)


def _u64_pairs(a):
    """(N, 2) u64 -> two int64 tensors of the same bits."""
    b = np.ascontiguousarray(a, np.uint64).view(np.int64)
    return torch.from_numpy(b[:, 0].copy()), torch.from_numpy(b[:, 1].copy())


def test_pair_table_unsigned_order_and_collisions():
    """Keys above 2^63 sort after the others; runs of equal h1 (64-bit
    collisions) are searched on h2; misses get the default."""
    from metamdbg_tpu.count.kminmers import _searchsorted_pairs

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 64, size=(4000, 2), dtype=np.uint64)
    keys[:300, 0] = keys[0, 0]          # a long run of one h1
    keys[300:310, 0] = (1 << 64) - 1
    keys[310:320, 0] = 1 << 63
    keys = np.unique(keys, axis=0)
    vals = torch.arange(keys.shape[0])
    perm = rng.permutation(keys.shape[0])
    table = pkm.PairTable(*_u64_pairs(keys[perm]), vals[perm])
    np.testing.assert_array_equal(table.h1.numpy().view(np.uint64),
                                  keys[:, 0])
    q = np.concatenate([keys[rng.integers(0, keys.shape[0], 500)],
                        rng.integers(0, 1 << 64, size=(200, 2),
                                     dtype=np.uint64)])
    q[-50:, 0] = keys[0, 0]
    idx = table.searchsorted(*_u64_pairs(q)).numpy()
    np.testing.assert_array_equal(idx, _searchsorted_pairs(keys, q))
    got, hit = table.lookup(*_u64_pairs(q), -1)
    want_hit = (keys[np.minimum(idx, keys.shape[0] - 1)] == q).all(axis=1)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(want_hit, idx, -1))


def test_refined_overlay_matches_dict_build():
    """The vectorized overlay equals the JAX package's dict build
    (RefinedAbundanceIndex.build), last setter and zeroer included."""
    from metamdbg_tpu.count import refined as jrefined

    rng = np.random.default_rng(17)
    k_prev = 4
    nodes = [(rng.integers(0, 30, size=int(rng.integers(k_prev, 12)))
              .astype(np.uint32), 2 * i) for i in range(60)]
    refined = {i: int(rng.choice([1, 1, 2, 5, 9])) for i in range(0, 60, 2)}
    # base keys: some of the nodes' own windows (so zeroers find them) and
    # random ones, with counts of 1 that are skipped
    from metamdbg_tpu.utils.hashing import murmur128_u32rows
    from metamdbg_tpu.count.kminmers import normalize_rows
    own = np.concatenate([np.lib.stride_tricks.sliding_window_view(s, k_prev)
                          for s, _ in nodes[:30]])
    h1, h2 = murmur128_u32rows(normalize_rows(own)[0])
    base = np.unique(np.stack([h1, h2], axis=1), axis=0)
    base = np.concatenate([base, rng.integers(0, 1 << 64, size=(50, 2),
                                              dtype=np.uint64)])
    counts = rng.integers(1, 6, size=base.shape[0]).astype(np.uint32)

    want = jrefined.RefinedAbundanceIndex.build(base, counts, nodes, refined,
                                                k_prev)
    got = prefined.RefinedAbundanceIndex.build(base, counts, nodes, refined,
                                               k_prev, CPU)
    np.testing.assert_array_equal(got.table.h1.numpy().view(np.uint64),
                                  want.keys[:, 0])
    np.testing.assert_array_equal(got.table.h2.numpy().view(np.uint64),
                                  want.keys[:, 1])
    np.testing.assert_array_equal(got.table.values.numpy(), want.values)
    assert (want.values == 0).any() and (want.values > 1).any()

    rows = np.concatenate([np.lib.stride_tricks.sliding_window_view(
        s, k_prev + 1) for s, _ in nodes if s.shape[0] > k_prev])
    np.testing.assert_array_equal(
        got.refined_abundance_rows(_t(rows), k_prev).numpy(),
        want.refined_abundance_rows(np.ascontiguousarray(rows), k_prev))


def test_first_occurrence_wins_ties():
    """The multiplex k-min-mer table keeps each key's first value, in input
    order, with planted repeats of one key at other values."""
    from metamdbg_tpu_torch.graph.multiplex import first_occurrence_table

    rng = np.random.default_rng(23)
    keys = rng.integers(0, 1 << 64, size=(300, 2), dtype=np.uint64)
    keys = keys[rng.integers(0, 300, size=2000)]   # repeats
    keys[:5, 0] = (1 << 64) - 1                    # above 2^63
    vals = rng.integers(2, 100, size=2000)
    table = first_occurrence_table(*_u64_pairs(keys), torch.from_numpy(vals))
    first = {}
    for key, v in zip(map(tuple, keys.tolist()), vals.tolist()):
        first.setdefault(key, v)
    want = sorted(first.items())
    got = list(zip(zip(table.h1.numpy().view(np.uint64).tolist(),
                       table.h2.numpy().view(np.uint64).tolist()),
                   table.values.tolist()))
    assert got == want


@pytest.mark.gpu
def test_count_cuda_matches_cpu():
    """K2 on the card against the same function on CPU tensors, on a
    (2^20, 5) table with repeats and values with the top bit set."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    rows = _rows(1 << 20, 5, 1 << 32, seed=3)
    rows[1::3] = rows[::3][:rows[1::3].shape[0]]
    want_u, want_c = kcount.count_unique_rows(_t(rows))
    got_u, got_c = kcount.count_unique_rows(_t(rows).cuda())
    assert torch.equal(got_u.cpu(), want_u)
    assert torch.equal(got_c.cpu(), want_c)
