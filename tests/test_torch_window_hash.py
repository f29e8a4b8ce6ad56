"""Kernel KW (metamdbg_tpu_torch/kernels/window_hash.py) and the torch
murmur128 twin it rests on, against the JAX package's three versions of
the operation on the CPU: numpy (count/kminmers.normalize_rows +
utils/hashing.murmur128_u32rows), native SIMD (sketch/native_sketch
window_hash_batch / row_hash_batch) and XLA
(parallel/count_table._window_hash_pairs). The CUDA kernel is held
against the plain version where a GPU is present.

Inputs are made with numpy from a seed, with palindromic windows and
values near 2^32 - 1 planted. All outputs are integers: tolerance 0. The
JAX package is imported inside the tests that use it, so that the GPU
tests run where JAX is not installed:
``python -m pytest tests/test_torch_window_hash.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from metamdbg_tpu_torch.kernels import window_hash as kw
from metamdbg_tpu_torch.utils import hashing

WIDTHS = list(range(2, 21)) + [61]


def _stream(n, seed, high=1 << 30):
    """u32 minimizers < 2^30 with values near 2^32 - 1 and palindromes
    (of widths 2..21 and 61) planted."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, high, size=n, dtype=np.uint64).astype(np.uint32)
    near = rng.integers(0, n, size=n // 50)
    cat[near] = (1 << 32) - 1 - rng.integers(0, 3, size=near.shape[0])
    for w in list(range(2, 22)) + [61]:
        for s in rng.integers(0, n - w, size=4):
            h = w // 2
            cat[s + w - h:s + w] = cat[s:s + h][::-1].copy()
    # runs of one value: palindromes whose first mismatch is deep inside
    cat[100:180] = 7
    return cat


def _u64(t):
    return t.numpy().view(np.uint64)


def _t(cat):
    return torch.from_numpy(cat.astype(np.int64))


def test_stream_has_palindromes():
    cat = _stream(4096, seed=1)
    for w in (2, 5, 16, 61):
        win = np.lib.stride_tricks.sliding_window_view(cat, w)
        assert (win == win[:, ::-1]).all(axis=1).sum() >= 4, w


@pytest.mark.parametrize("k", list(range(1, 21)) + [61])
def test_murmur128_matches_jax_package(k):
    """Every tail case k % 4 in {0, 1, 2, 3}, including len&15 == 12."""
    from metamdbg_tpu.utils import hashing as jhashing

    rng = np.random.default_rng(k)
    rows = rng.integers(0, 1 << 32, size=(300, k), dtype=np.uint64) \
        .astype(np.uint32)
    rows[:8] = (1 << 32) - 1
    rows[8:16] = 0
    for seed in (0, 7):
        got = [_u64(h) for h in hashing.murmur128_u32rows(
            torch.from_numpy(rows.astype(np.int64)), seed=seed)]
        want = jhashing.murmur128_u32rows(rows, seed=seed)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for r in range(0, 300, 37):
        h1, h2 = jhashing.murmur128_u32row_scalar(rows[r].tolist())
        g = hashing.murmur128_u32rows(torch.from_numpy(
            rows[r].astype(np.int64)))
        assert (int(_u64(g[0])[0]), int(_u64(g[1])[0])) == (h1, h2)


@pytest.mark.parametrize("w", WIDTHS)
def test_normalized_windows_match_jax_package(w):
    """normalize=True against normalize_rows + murmur128_u32rows and
    against the native fused sweep, every window of the stream."""
    from metamdbg_tpu.count.kminmers import normalize_rows as jnormalize
    from metamdbg_tpu.sketch import native_sketch
    from metamdbg_tpu.utils import hashing as jhashing

    cat = _stream(6000, seed=w)
    starts = np.arange(cat.shape[0] - w + 1, dtype=np.int64)
    got = [_u64(h) for h in kw.hash_windows(_t(cat), torch.from_numpy(starts),
                                            w, normalize=True)]
    win = np.lib.stride_tricks.sliding_window_view(cat, w)
    want = jhashing.murmur128_u32rows(jnormalize(win)[0])
    native = native_sketch.window_hash_batch(cat, starts, w)
    assert native is not None
    for g, a, b in zip(got, want, native):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)
    norm, rev = kw.normalize_rows(_t(np.ascontiguousarray(win)))
    jnorm, jrev = jnormalize(win)
    np.testing.assert_array_equal(norm.numpy(), jnorm)
    np.testing.assert_array_equal(rev.numpy(), jrev)


@pytest.mark.parametrize("w", WIDTHS)
def test_raw_rows_match_jax_package(w):
    """normalize=False: raw rows as mdbg._row_hash_keys and row_hash_batch
    hash them (a palindrome and its reverse are the same bytes; a
    non-palindrome and its reverse hash differently)."""
    from metamdbg_tpu.graph import mdbg as jmdbg
    from metamdbg_tpu.sketch import native_sketch

    cat = _stream(3000, seed=100 + w)
    rows = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(cat, w)[::3])
    got = [_u64(h) for h in kw.hash_rows(_t(rows))]
    want = jmdbg._row_hash_keys(rows)
    native = native_sketch.row_hash_batch(rows)
    np.testing.assert_array_equal(got[0], want[:, 0])
    np.testing.assert_array_equal(got[1], want[:, 1])
    np.testing.assert_array_equal(got[0], native[0])
    np.testing.assert_array_equal(got[1], native[1])
    rev = [_u64(h) for h in kw.hash_rows(_t(rows[:, ::-1].copy()))]
    pal = (rows == rows[:, ::-1]).all(axis=1)
    assert pal.any() and (~pal).any()
    assert (rev[0][pal] == got[0][pal]).all()
    assert (rev[0][~pal] != got[0][~pal]).all()


def test_matches_xla_window_hash_pairs():
    """Against the XLA sweep of the sharded count table on the JAX CPU
    backend, recombining its u32 halves."""
    from metamdbg_tpu.parallel.count_table import _window_hash_pairs

    k = 7
    rng = np.random.default_rng(3)
    lens = rng.integers(k, 90, size=12)
    mins = np.zeros((12, 96), np.uint32)
    cat = _stream(int(lens.sum()) + 200, seed=4)
    off = 0
    for r, n in enumerate(lens):
        mins[r, :n] = cat[off:off + n]
        off += n
    h1lo, h1hi, h2lo, h2hi, valid = (np.asarray(x) for x in
                                     _window_hash_pairs(mins, lens.astype(
                                         np.int32), k))
    starts = np.nonzero(valid.reshape(-1))[0]
    nw = valid.shape[1]
    flat_starts = (starts // nw) * mins.shape[1] + starts % nw
    got = [_u64(h) for h in kw.hash_windows(
        _t(mins.reshape(-1)), torch.from_numpy(flat_starts), k, True)]
    for g, lo, hi in ((got[0], h1lo, h1hi), (got[1], h2lo, h2hi)):
        want = (lo.reshape(-1)[starts].astype(np.uint64)
                | (hi.reshape(-1)[starts].astype(np.uint64) << np.uint64(32)))
        np.testing.assert_array_equal(g, want)


def test_per_window_widths():
    """One width per start equals one call per width."""
    cat = _t(_stream(2000, seed=8))
    rng = np.random.default_rng(9)
    widths = torch.from_numpy(rng.integers(1, 40, size=500))
    starts = torch.from_numpy(rng.integers(0, 2000 - 40, size=500))
    for normalize in (False, True):
        g1, g2 = kw.hash_windows(cat, starts, widths, normalize)
        for w in torch.unique(widths).tolist():
            sel = widths == w
            w1, w2 = kw.hash_windows(cat, starts[sel].contiguous(), w,
                                     normalize)
            assert torch.equal(g1[sel], w1) and torch.equal(g2[sel], w2)


def test_wrapper_checks_and_cpu_route():
    cat = torch.arange(100, dtype=torch.int64)
    kw.reset_counts()
    kw.hash_windows(cat, torch.arange(10), 5, True)
    assert kw.launches == 0
    with pytest.raises(ValueError, match="outside"):
        kw.hash_windows(cat, torch.tensor([96]), 5, True)
    with pytest.raises(ValueError, match="int64"):
        kw.hash_windows(cat.to(torch.int32), torch.arange(3), 5, True)
    with pytest.raises(ValueError, match=">= 1"):
        kw.hash_windows(cat, torch.arange(3), 0, True)
    h1, h2 = kw.hash_windows(cat, torch.zeros(0, dtype=torch.int64), 5, True)
    assert h1.shape == h2.shape == (0,)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [4, 5, 6, 7, 16, 61])
def test_cuda_kernel_matches_reference(w):
    """The CUDA kernel against the plain version on the card, both modes,
    fixed and per-window widths: bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    cat = _t(_stream(1 << 16, seed=40 + w)).cuda()
    starts = torch.arange(cat.numel() - w + 1, device="cuda")
    for normalize in (True, False):
        got = kw.hash_windows(cat, starts, w, normalize)
        torch.cuda.synchronize()
        want = kw.hash_windows_reference(cat, starts, w, normalize)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    widths = torch.randint(1, w + 1, starts.shape, device="cuda")
    got = kw.hash_windows(cat, starts, widths, True)
    want = kw.hash_windows_reference(cat, starts, widths, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
