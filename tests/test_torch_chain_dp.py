"""Kernel K4 (metamdbg_tpu_torch/kernels/chain_dp.py), the correction read
mapper's chain DP, against the JAX package on the CPU: its XLA scan
(kernels/chain_jax.chain_dp_device), its native twins
(native/sketch.cpp:chain_corr_batch for the DP, chain_mapper_batch for the
chains and their scores) and its Python chainer
(correction/mapper.chain_read_pair). The CUDA kernel is held against the
plain version where a GPU is present.

Inputs come from chip_smoke.chain_dp_groups, made with numpy from a seed:
noisy collinear groups on both strands, noise anchors and planted
equal-score ties. Scores are compared as f32 bits, everything else
exactly: tolerance 0. The JAX package is imported inside the tests that use
it, so that the GPU test runs where JAX is not installed:
``python -m pytest tests/test_torch_chain_dp.py -m gpu``.
"""

import ctypes

import numpy as np
import pytest
import torch

from chip_smoke import chain_dp_groups
from metamdbg_tpu_torch.kernels import chain_dp as k4

# the kernel's edges: a long group's 32-lane team and its two register
# slots (bands 32 and 64), a band past both; warps of 32 threads, tiles of
# 256 anchors staged in spans of 384
BANDS = (1, 10, 31, 32, 33, 62, 64, 65, 125, 300)
TEAM_EDGES = (7, 8, 9, 15, 16, 17, 31, 32, 33)
TILE_EDGES = (255, 256, 257, 383, 384, 385, 2047, 2048, 2049)


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _lengths(seed, n, hi):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0, 1, 2, 3, 10, 11, 63, 64, 65], TEAM_EDGES,
                           rng.integers(3, hi, n)])


def _check_against_jax(arrays, got, band):
    from metamdbg_tpu.kernels.chain_jax import chain_dp_device

    ref, q, rev, _, offs = arrays
    n = offs[1:] - offs[:-1]
    P, A = n.shape[0], int(n.max())
    pad = [np.zeros((P, A), dt) for dt in (np.int64, np.int64, bool)]
    for g in range(P):
        for x, flat in zip(pad, (ref, q, rev)):
            x[g, :n[g]] = flat[offs[g]:offs[g + 1]]
    j_scores, j_parents, j_best = chain_dp_device(*pad, n, band)
    assert np.array_equal(got.best_index.numpy(), j_best)
    scores, parents = got.scores.numpy(), got.parents.numpy()
    for g in range(P):
        a, b = offs[g], offs[g + 1]
        assert np.array_equal(scores[a:b].view(np.int32),
                              j_scores[g, :n[g]].view(np.int32)), g
        assert np.array_equal(parents[a:b], j_parents[g, :n[g]]), g


def _native_dp(arrays, band):
    """native/sketch.cpp:chain_corr_batch over every group in one call."""
    from metamdbg_tpu.sketch import native_sketch

    lib = native_sketch._load()
    ref, q, rev, _, offs = arrays
    n, n_groups = ref.shape[0], offs.shape[0] - 1
    scores = np.zeros(n, np.float32)
    parents = np.zeros(n, np.int32)
    best = np.zeros(n_groups, np.int32)
    rv = rev.astype(np.uint8)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    lib.chain_corr_batch(
        ptr(ref, ctypes.c_int64), ptr(q, ctypes.c_int64),
        ptr(rv, ctypes.c_uint8), ptr(offs, ctypes.c_int64),
        np.int32(n_groups), np.int32(band), ctypes.c_float(k4.CHAIN_W),
        np.int64(k4.CHAIN_MAX_DIST), np.int64(k4.CHAIN_MAX_GAP),
        ptr(scores, ctypes.c_float), ptr(parents, ctypes.c_int32),
        ptr(best, ctypes.c_int32), np.int32(1))
    return scores, parents, best


def _check_against_native(arrays, got, band):
    from metamdbg_tpu.sketch import native_sketch

    scores, parents, best = _native_dp(arrays, band)
    assert np.array_equal(got.scores.numpy().view(np.int32),
                          scores.view(np.int32))
    assert np.array_equal(got.parents.numpy(), parents)
    assert np.array_equal(got.best_index.numpy(), best)

    ref, q, rev, q_idx, offs = arrays
    g_scores, pos_offs, positions = native_sketch.chain_mapper_batch(
        ref, q, rev, q_idx.astype(np.int64), offs, band, k4.CHAIN_W,
        k4.CHAIN_MAX_DIST, k4.CHAIN_MAX_GAP, n_threads=1)
    assert np.array_equal(got.chain_score.numpy(), g_scores)
    chain_len, chain_pos = got.chain_len.numpy(), got.chain_pos.numpy()
    for g in range(offs.shape[0] - 1):
        if g_scores[g] == k4.INT32_MIN:
            continue
        want = positions[pos_offs[g]:pos_offs[g + 1]]
        assert chain_len[g] == want.shape[0], g
        assert np.array_equal(chain_pos[offs[g]:offs[g] + chain_len[g]],
                              want), g


def _check_against_mapper(arrays, got, band):
    """correction/mapper.chain_read_pair, group by group."""
    from metamdbg_tpu.correction import mapper

    ref, q, rev, q_idx, offs = arrays
    chain_len, chain_pos = got.chain_len.numpy(), got.chain_pos.numpy()
    chain_score = got.chain_score.numpy()
    for g in range(offs.shape[0] - 1):
        a, b = offs[g], offs[g + 1]
        want = mapper.chain_read_pair(ref[a:b], q[a:b], rev[a:b],
                                      q_idx[a:b], band) if b > a else None
        if want is None:
            assert chain_score[g] == k4.INT32_MIN, g
            continue
        assert chain_score[g] == want[0], g
        assert np.array_equal(chain_pos[a:a + chain_len[g]],
                              want[1].astype(np.int32)), g
        assert np.all(chain_pos[a + chain_len[g]:b] == -1), g


@pytest.mark.parametrize("band", BANDS)
def test_reference_matches_jax(band):
    """Both strands, noise, ties, lengths 0-200, against the XLA scan."""
    arrays = chain_dp_groups(_lengths(band, 120, 200), seed=band + 1)
    got = k4.chain_dp(*_tensors(arrays), band)
    _check_against_jax(arrays, got, band)


@pytest.mark.parametrize("band", BANDS)
def test_reference_matches_native_and_mapper(band):
    """The DP against chain_corr_batch; chains, their scores and positions
    against chain_mapper_batch and mapper.chain_read_pair."""
    arrays = chain_dp_groups(_lengths(band + 20, 120, 200), seed=band + 21)
    got = k4.chain_dp(*_tensors(arrays), band)
    _check_against_native(arrays, got, band)
    _check_against_mapper(arrays, got, band)


def test_planted_ties_pick_the_nearer_predecessor():
    """Every third group ends in A, B, C where C's candidates from A and B
    are equal: C's parent is B (the first strictly greater scanning j down
    from i - 1), in the plain version as in the host DP."""
    lengths = _lengths(3, 30, 40)
    arrays = chain_dp_groups(lengths, seed=4)
    got = k4.chain_dp(*_tensors(arrays), 62)
    offs = arrays[4]
    for g in range(0, lengths.shape[0], 3):
        c = int(offs[g + 1]) - 1
        assert int(got.parents[c]) == c - offs[g] - 1, g
        assert float(got.scores[c]) == 20.0 + 19.0, g


def test_group_above_4096_anchors():
    """One group longer than the JAX package's largest bucket (which it
    sends to the host): the plain version agrees with all three."""
    arrays = chain_dp_groups([5000, 4097, 7], seed=5)
    got = k4.chain_dp(*_tensors(arrays), 62)
    assert int(got.chain_len.max()) > 1000
    _check_against_jax(arrays, got, 62)
    _check_against_native(arrays, got, 62)
    _check_against_mapper(arrays, got, 62)


@pytest.mark.parametrize("band", (62, 300))
def test_tile_edge_lengths(band):
    """Groups of a tile's and a span's length and one either side, between
    short ones: the plain version agrees with all three."""
    rng = np.random.default_rng(band)
    lengths = np.concatenate([rng.integers(3, 30, 20), TILE_EDGES,
                              rng.integers(0, 30, 20)])
    arrays = chain_dp_groups(lengths, seed=band + 7)
    got = k4.chain_dp(*_tensors(arrays), band)
    _check_against_jax(arrays, got, band)
    _check_against_native(arrays, got, band)
    _check_against_mapper(arrays, got, band)


def test_unsorted_chain_positions():
    """A chain whose q_idx values are not monotone along it (no real read
    gives one) still comes back with its positions ascending."""
    ref = np.array([0, 100, 200, 300, 400], np.int64)
    q = ref + 7
    q_idx = np.array([3, 0, 4, 1, 2], np.int32)
    arrays = (ref, q, np.zeros(5, bool), q_idx, np.array([0, 5], np.int64))
    got = k4.chain_dp(*_tensors(arrays), 62)
    assert got.chain_len.tolist() == [5]
    assert got.chain_pos.tolist() == [0, 1, 2, 3, 4]
    # 2 * 5 - 1 - |q_idx(best) - q_idx(root)| = 9 - |2 - 3|
    assert got.chain_score.tolist() == [8]
    _check_against_mapper(arrays, got, 62)


def test_wrapper_checks_its_inputs():
    arrays = chain_dp_groups([5, 6], seed=8)
    ref, q, rev, q_idx, offs = _tensors(arrays)
    with pytest.raises(ValueError, match="int64"):
        k4.chain_dp(ref.int(), q, rev, q_idx, offs, 62)
    with pytest.raises(ValueError, match="int32"):
        k4.chain_dp(ref, q, rev, q_idx.long(), offs, 62)
    with pytest.raises(ValueError, match="bool"):
        k4.chain_dp(ref, q, rev.to(torch.uint8), q_idx, offs, 62)
    with pytest.raises(ValueError, match="offsets"):
        k4.chain_dp(ref, q, rev, q_idx, offs[:-1], 62)
    with pytest.raises(ValueError, match="offsets"):
        k4.chain_dp(ref, q, rev, q_idx, offs.flip(0).contiguous(), 62)
    with pytest.raises(ValueError, match="offsets"):
        k4.chain_dp(ref, q, rev, q_idx, offs.int(), 62)
    with pytest.raises(ValueError, match="band"):
        k4.chain_dp(ref, q, rev, q_idx, offs, 0)
    for bad in (1 << 31, 1 << 30, -1):
        big = ref.clone()
        big[3] = bad
        with pytest.raises(ValueError, match="2\\^30"):
            k4.chain_dp(big, q, rev, q_idx, offs, 62)
        with pytest.raises(ValueError, match="2\\^30"):
            k4.chain_dp(ref, big, rev, q_idx, offs, 62)
    meta = [t.to("meta") for t in (ref, q, rev, q_idx, offs)]
    with pytest.raises(ValueError, match="device"):
        k4.chain_dp(*meta, 62)
    with pytest.raises(ValueError, match="one device"):
        k4.chain_dp(ref, q, rev, q_idx, meta[4], 62)
    empty = [x[:0] for x in (ref, q, rev, q_idx)]
    got = k4.chain_dp(*empty, torch.zeros(1, dtype=torch.int64), 62)
    assert got.scores.shape == got.chain_pos.shape == (0,)
    assert got.best_index.shape == got.chain_len.shape == (0,)
    assert k4.launches == 0


@pytest.mark.gpu
def test_cuda_kernel_matches_reference():
    """The CUDA kernel against the plain version on the card at every band
    of the CPU tests, with groups at the team and tile edges and longer
    than a span: scores' f32 bits and every other output identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    arrays = chain_dp_groups(np.concatenate([_lengths(9, 3000, 200),
                                             TILE_EDGES, [6000]]), seed=10)
    for band in BANDS:
        got = k4.chain_dp(*_tensors(arrays, "cuda"), band)
        torch.cuda.synchronize()
        want = k4.chain_dp_reference(
            *[t.to(torch.int32) if t.dtype == torch.int64 else t
              for t in _tensors(arrays[:4], "cuda")],
            torch.from_numpy(arrays[4]).cuda(), band)
        assert torch.equal(got.scores.view(torch.int32),
                           want.scores.view(torch.int32))
        for name in ("parents", "best_index", "chain_len", "chain_score",
                     "chain_pos"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
