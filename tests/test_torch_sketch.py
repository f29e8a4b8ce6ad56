"""Kernel K1 (metamdbg_tpu_torch/kernels/sketch.py): the plain torch version
against the JAX package's sketchers on the CPU, and the CUDA kernel against
the plain version where a GPU is present.

Inputs are made with numpy from a seed. All outputs are integers, so every
comparison is exact (tolerance 0). The JAX package is imported inside the
tests that use it, so that the GPU test runs where JAX is not installed:
``python -m pytest tests/test_torch_sketch.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from metamdbg_tpu_torch.kernels import sketch as ksketch


def _tiles(n, L, seed, bad_rate=0.003, l=15):
    """Random base codes with ~0.3% bad bases and separator runs of l-1
    code-4 bases, as the tile packer lays them out."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[rng.random((n, L)) < bad_rate] = 4
    for r in range(n):
        for s in rng.integers(0, L - l, size=6):
            codes[r, s:s + l - 1] = 4
    return codes


def _tandem_row(L, l, density, cap, seed):
    """A row of one 6-base period repeated: when a window of the period is
    selected, the row selects ~L/6 windows, more than `cap`."""
    rng = np.random.default_rng(seed)
    while True:
        row = np.resize(rng.integers(0, 4, size=6, dtype=np.uint8), L)
        ref = ksketch.sketch_tiles_reference(torch.from_numpy(row[None]), l,
                                             density, 1)
        if int(ref[3][0]) > cap:
            return row


def _jax_compact(codes, l, density, cap):
    from metamdbg_tpu.kernels import sketch as jsketch

    packed, bad_packed = jsketch.pack_codes(codes)
    lens = np.full(codes.shape[0], codes.shape[1], np.int32)
    res = jsketch.sketch_batch_compact_packed(packed, bad_packed, lens, l,
                                              density, cap)
    return [np.asarray(res[k]) for k in
            ("positions", "values", "directions", "counts")]


# the kernel's layout: each thread owns 16 consecutive windows, each block
# of a row's cluster 2,048
THREAD_SPAN, BLOCK_SEGMENT = 16, 2048


@pytest.mark.parametrize("density", [0.005, 0.025, 0.1])
def test_reference_matches_xla_compact(density):
    """(a) The plain version equals sketch_batch_compact_packed (pack_codes
    input, no row trim) on a (16, 16384) tile, column for column, at the
    main path's three densities (read selection, the correction re-sketch,
    toBasespace's overlaps). Row 3 holds only separators."""
    l, L = 15, 16384
    codes = _tiles(16, L, seed=21)
    codes[3] = 4
    cap = ksketch.compact_cap(L - l + 1, density)
    want = _jax_compact(codes, l, density, cap)
    got = ksketch.sketch_tiles_reference(torch.from_numpy(codes), l, density,
                                         cap)
    assert want[3].sum() > 0 and want[3][3] == 0
    for name, g, w in zip(("positions", "values", "directions", "counts"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if density == 0.1:
        # selections on both sides of thread-span and block-segment edges
        pos = np.concatenate([want[0][r, :min(want[3][r], cap)]
                              for r in range(16)])
        for span in (THREAD_SPAN, BLOCK_SEGMENT):
            assert (pos % span == 0).any() and (pos % span == span - 1).any()


def test_reference_even_l_palindromes():
    """At even l an l-mer can equal its own reverse complement; then
    fwd == rev and the direction must be 1 (ties go to the reverse)."""
    l, L, density = 16, 2048, 0.1
    rng = np.random.default_rng(22)
    codes = _tiles(4, L, seed=23, l=l)
    for r in range(4):
        for s in rng.integers(0, L - 2 * l, size=40):
            half = rng.integers(0, 4, size=l // 2, dtype=np.uint8)
            codes[r, s:s + l] = np.concatenate([half, (half ^ 2)[::-1]])
    cap = L - l + 1
    want = _jax_compact(codes, l, density, cap)
    got = ksketch.sketch_tiles_reference(torch.from_numpy(codes), l, density,
                                         cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the palindromes were really hit
    c = codes.astype(np.uint64)
    hit_palindrome = False
    for r in range(4):
        for p, d in zip(want[0][r, :want[3][r]], want[2][r, :want[3][r]]):
            w = c[r, p:p + l]
            if np.array_equal(w, (w ^ 2)[::-1]):
                assert d == 1
                hit_palindrome = True
    assert hit_palindrome


def test_reference_matches_pallas_interpret():
    """(b) The Pallas kernel in interpret mode at (8, 1024): the same
    selection (inside the Pallas row trim) and the same values and
    directions on the selected windows."""
    import jax.numpy as jnp

    from metamdbg_tpu.kernels.sketch_pallas import sketch_batch_pallas

    l, density = 15, 0.05
    rng = np.random.default_rng(24)
    n, L = 8, 1024
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[rng.random((n, L)) < 0.003] = 4
    lengths = np.full(n, L, np.int32)
    b = sketch_batch_pallas(jnp.asarray(codes), jnp.asarray(lengths), l=l,
                            density=density, interpret=True)
    sel_p = np.asarray(b["selected"])

    nk = L - l + 1
    pos, vals, dirs, counts = (x.numpy() for x in
                               ksketch.sketch_tiles_reference(
                                   torch.from_numpy(codes), l, density, nk))
    sel = np.zeros((n, nk), bool)
    v_full = np.zeros((n, nk), np.uint32)
    d_full = np.zeros((n, nk), np.uint8)
    for r in range(n):
        p = pos[r, :counts[r]]
        sel[r, p] = True
        v_full[r, p] = vals[r, :counts[r]]
        d_full[r, p] = dirs[r, :counts[r]]
    x = np.arange(nk)[None, :]
    sel &= (x >= 1) & (x < lengths[:, None] - l)
    assert sel.sum() > 0
    np.testing.assert_array_equal(sel, sel_p)
    np.testing.assert_array_equal(v_full[sel], np.asarray(b["values"])[sel])
    np.testing.assert_array_equal(d_full[sel],
                                  np.asarray(b["directions"])[sel])


def test_overflow_rows_return_every_window():
    """(c) A tandem-repeat row whose count exceeds cap: the wrapper runs it
    again with cap = nk and returns every selected window."""
    l, L, density = 15, 16384, 0.005
    nk = L - l + 1
    codes = _tiles(4, L, seed=25)
    cap = ksketch.compact_cap(nk, density)
    codes[2] = _tandem_row(L, l, density, cap, seed=26)
    res = ksketch.sketch_tiles(torch.from_numpy(codes), l, density, cap)
    full = ksketch.sketch_tiles_reference(torch.from_numpy(codes), l,
                                          density, nk)
    counts = res.counts.numpy()
    assert counts[2] > cap
    assert res.overflow_rows.tolist() == [2]
    np.testing.assert_array_equal(counts, full[3].numpy())
    m = counts[2]
    for got, want in zip(res.overflow, full[:3]):
        np.testing.assert_array_equal(got[0, :m].numpy(),
                                      want[2, :m].numpy())
    for r in (0, 1, 3):
        m = counts[r]
        assert m <= cap
        for got, want in zip((res.positions, res.values, res.directions),
                             full[:3]):
            np.testing.assert_array_equal(got[r, :m].numpy(),
                                          want[r, :m].numpy())


@pytest.mark.parametrize("bad", [
    dict(dtype=torch.int32), dict(shape=(16,)), dict(l=17), dict(cap=0),
    dict(transposed=True)])
def test_wrapper_rejects_bad_input(bad):
    shape = bad.get("shape", (4, 64))
    codes = torch.zeros(shape, dtype=bad.get("dtype", torch.uint8))
    if bad.get("transposed"):
        codes = torch.zeros((64, 4), dtype=torch.uint8).t()
    with pytest.raises(ValueError):
        ksketch.sketch_tiles(codes, bad.get("l", 15), 0.005,
                             bad.get("cap", 8))


def test_cpu_route_counts_no_launch():
    ksketch.reset_counts()
    ksketch.sketch_tiles(torch.from_numpy(_tiles(2, 1024, seed=27)), 15,
                         0.025, 64)
    assert ksketch.launches == 0 and ksketch.overflow_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("l,density", [(15, 0.005), (15, 0.025), (16, 0.05),
                                       (15, 0.1), (13, 0.1)])
def test_cuda_kernel_matches_reference(l, density):
    """(d) The CUDA kernel against the plain version on the card, with bad
    bases, separators, a row of separators only and one overflow row:
    bit-identical on every selected window and count. l = 15 runs the
    kernel's compile-time l, 13 and 16 its run-time l."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    L = 16384
    nk = L - l + 1
    codes = _tiles(64, L, seed=28, l=l)
    cap = ksketch.compact_cap(nk, density)
    codes[5] = _tandem_row(L, l, density, cap, seed=29)
    codes[9] = 4
    dev = torch.from_numpy(codes).cuda()
    res = ksketch.sketch_tiles(dev, l, density, cap)
    torch.cuda.synchronize()
    ref = ksketch.sketch_tiles(torch.from_numpy(codes), l, density, cap)
    np.testing.assert_array_equal(res.counts.cpu().numpy(),
                                  ref.counts.numpy())
    assert res.overflow_rows.tolist() == ref.overflow_rows.tolist() == [5]
    counts = ref.counts.numpy()
    for got, want in zip((res.positions, res.values, res.directions),
                         (ref.positions, ref.values, ref.directions)):
        g, w = got.cpu().numpy(), want.numpy()
        for r in range(codes.shape[0]):
            m = min(counts[r], cap)
            np.testing.assert_array_equal(g[r, :m], w[r, :m])
    m = counts[5]
    for got, want in zip(res.overflow, ref.overflow):
        np.testing.assert_array_equal(got[0, :m].cpu().numpy(),
                                      want[0, :m].numpy())
