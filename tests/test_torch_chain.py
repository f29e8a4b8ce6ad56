"""Kernel K3 (metamdbg_tpu_torch/kernels/chain.py), the read-vs-contig
chain DP, against the JAX package on the CPU: its XLA scan
(kernels/chain_jax.chain_contig_device) and its host DP
(basespace/contig_mapper._chain), and the port's copy of that host DP.
The CUDA kernel is held against the plain version where a GPU is present.

Inputs come from chip_smoke.chain_groups, made with numpy from a seed:
noisy collinear groups on both strands, noise anchors, base-space gaps
that reach the 5000 bp cap, and planted equal-score ties. Scores are
compared as f32 bits, parents and best indexes exactly: tolerance 0. The
JAX package is imported inside the tests that use it, so that the GPU test
runs where JAX is not installed:
``python -m pytest tests/test_torch_chain.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import chain_groups
from metamdbg_tpu_torch.basespace import contig_mapper
from metamdbg_tpu_torch.kernels import chain as kchain

AVG_DIST = float(1.0 / np.float32(0.005))  # the asm default: 200.0
# group lengths at the kernel's edges: its band of 10 in 16-byte gap rows,
# warps of 32, tiles of 1,024 anchors staged in spans of 2,048
LENGTH_CASES = {"short": (0, 1, 2, 3, 0, 1, 2),
                "team": (9, 10, 11, 15, 16, 17, 31, 32, 33),
                "tile": (1023, 1024, 1025, 2047, 2048, 2049)}


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _lengths(seed, n, hi):
    rng = np.random.default_rng(seed)
    return np.concatenate([[2, 3, 10, 11, 64, 65],
                           rng.integers(2, hi, n)])


def _host_chain(chain, arrays, g, avg_dist):
    """One group through a host DP: (score, interval) or None."""
    ref, q, q_bp, rev, offs = arrays
    a, b = offs[g], offs[g + 1]
    if a == b:
        return None
    bp = np.zeros(int(q[a:b].max()) + 1, np.int64)
    bp[q[a:b]] = q_bp[a:b]
    return chain((ref[a:b].astype(np.int64), q[a:b].astype(np.int64),
                  rev[a:b]), bp, avg_dist)


def _interval(parents, offs, best, g):
    if best[g] < 0:
        return None
    out, idx = [], int(best[g])
    while idx != -1:
        out.append(idx)
        idx = int(parents[offs[g] + idx])
    return out[::-1]


def _check_against_host(arrays, got, avg_dist):
    from metamdbg_tpu.basespace import contig_mapper as jmapper

    scores, parents, best = (x.numpy() for x in got)
    offs = arrays[4]
    for g in range(offs.shape[0] - 1):
        interval = _interval(parents, offs, best, g)
        for chain in (jmapper._chain, contig_mapper._chain):
            want = _host_chain(chain, arrays, g, avg_dist)
            if want is None:
                assert interval is None or len(interval) < 2, g
                continue
            assert interval == want[1], g
            assert scores[offs[g] + best[g]] == np.float32(want[0]), g


def _check_against_jax(arrays, got, d_r_max):
    from metamdbg_tpu.kernels.chain_jax import chain_contig_device

    ref, q, q_bp, rev, offs = arrays
    n = offs[1:] - offs[:-1]
    P, A = n.shape[0], int(n.max())
    pad = [np.zeros((P, A), dt) for dt in (np.int64, np.int64, np.int64,
                                           bool)]
    for g in range(P):
        for x, flat in zip(pad, (ref, q, q_bp, rev)):
            x[g, :n[g]] = flat[offs[g]:offs[g + 1]]
    j_scores, j_parents, j_best = chain_contig_device(
        *pad, n, kchain.BAND, d_r_max, kchain.W, kchain.MAX_GAP,
        kchain.BP_CAP)
    scores, parents, best = (x.numpy() for x in got)
    assert np.array_equal(best, j_best)
    for g in range(P):
        a, b = offs[g], offs[g + 1]
        assert np.array_equal(scores[a:b].view(np.int32),
                              j_scores[g, :n[g]].view(np.int32)), g
        assert np.array_equal(parents[a:b], j_parents[g, :n[g]]), g


def test_reference_matches_jax_and_host():
    """Both strands, noise, ties, lengths 2-300 at the asm's avg_dist."""
    arrays = chain_groups(_lengths(1, 150, 300), seed=2)
    d_r_max = contig_mapper._d_r_max(AVG_DIST)
    got = kchain.chain_contig(*_tensors(arrays), d_r_max)
    _check_against_jax(arrays, got, d_r_max)
    _check_against_host(arrays, got, AVG_DIST)


@pytest.mark.parametrize("case", sorted(LENGTH_CASES))
def test_edge_lengths(case):
    """Groups at the kernel's edges, each at an index that holds no planted
    tie, between short groups: the plain version agrees with the XLA scan,
    and with both host DPs up to the team edges (their Python loops take
    minutes over tile-long groups)."""
    rng = np.random.default_rng(len(case))
    lengths = [3]
    for k in range(0, len(LENGTH_CASES[case]), 2):
        lengths += [*LENGTH_CASES[case][k:k + 2], 3]
    lengths = np.concatenate([rng.integers(2, 40, 15), lengths])
    arrays = chain_groups(lengths, seed=11)
    d_r_max = contig_mapper._d_r_max(AVG_DIST)
    got = kchain.chain_contig(*_tensors(arrays), d_r_max)
    _check_against_jax(arrays, got, d_r_max)
    if case != "tile":
        _check_against_host(arrays, got, AVG_DIST)


def test_planted_ties_pick_the_nearer_predecessor():
    """Every third group ends in A, B, C where C's candidates from A and B
    are equal: C's parent is B (the first strictly greater scanning j down
    from i - 1), in the plain version as in the host DP."""
    lengths = _lengths(3, 30, 40)
    arrays = chain_groups(lengths, seed=4)
    scores, parents, _ = kchain.chain_contig(
        *_tensors(arrays), contig_mapper._d_r_max(AVG_DIST))
    offs = arrays[4]
    for g in range(0, lengths.shape[0], 3):
        c = int(offs[g + 1]) - 1
        assert int(parents[c]) == c - offs[g] - 1, g
        assert float(scores[c]) == 20.0 + 19.0, g


def test_group_above_4096_anchors():
    """One group longer than the JAX package's largest bucket (which it
    sends to the host DP): the plain version agrees with both."""
    arrays = chain_groups([5000, 4097, 7], seed=5)
    d_r_max = contig_mapper._d_r_max(AVG_DIST)
    got = kchain.chain_contig(*_tensors(arrays), d_r_max)
    _check_against_jax(arrays, got, d_r_max)
    _check_against_host(arrays, got, AVG_DIST)


@pytest.mark.parametrize("avg_dist", [AVG_DIST, 40.0,
                                      float(1.0 / np.float32(0.007)),
                                      333.3333, 5000.0, 5001.0])
def test_d_r_max(avg_dist):
    """`_d_r_max` is the JAX package's, the largest d_r with
    d_r * avg_dist <= 5000 in f64, and chaining with it agrees with the
    host DP's f64 test."""
    from metamdbg_tpu.basespace import contig_mapper as jmapper

    t = contig_mapper._d_r_max(avg_dist)
    assert t == jmapper._d_r_max(avg_dist)
    assert t * avg_dist <= 5000.0 < (t + 1) * avg_dist
    arrays = chain_groups(_lengths(6, 20, 80), seed=7)
    got = kchain.chain_contig(*_tensors(arrays), t)
    _check_against_host(arrays, got, avg_dist)


def test_wrapper_checks_its_inputs():
    arrays = chain_groups([5, 6], seed=8)
    ref, q, q_bp, rev, offs = _tensors(arrays)
    with pytest.raises(ValueError, match="int32"):
        kchain.chain_contig(ref.long(), q, q_bp, rev, offs, 25)
    with pytest.raises(ValueError, match="offsets"):
        kchain.chain_contig(ref, q, q_bp, rev, offs[:-1], 25)
    with pytest.raises(ValueError, match="offsets"):
        kchain.chain_contig(ref, q, q_bp, rev, offs.flip(0).contiguous(), 25)
    empty = [x[:0] for x in (ref, q, q_bp, rev)]
    scores, parents, best = kchain.chain_contig(
        *empty, torch.zeros(1, dtype=torch.int64), 25)
    assert scores.shape == parents.shape == best.shape == (0,)


@pytest.mark.gpu
def test_cuda_kernel_matches_reference():
    """The CUDA kernel against the plain version on the card: scores' f32
    bits, parents and best indexes identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    edges = [x for case in sorted(LENGTH_CASES) for x in LENGTH_CASES[case]]
    arrays = chain_groups(np.concatenate([_lengths(9, 2000, 300), edges,
                                          [6000]]), seed=10)
    d_r_max = contig_mapper._d_r_max(AVG_DIST)
    got = kchain.chain_contig(*_tensors(arrays, "cuda"), d_r_max)
    torch.cuda.synchronize()
    want = kchain.chain_contig_reference(*_tensors(arrays, "cuda"), d_r_max)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
