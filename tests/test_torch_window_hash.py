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
# the ladder's widest plane (w = 123) and wider: ~w/4 murmur rounds per
# window, on one thread each
WIDE = [123, 300, 1000]


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


@pytest.mark.parametrize("w", WIDTHS + WIDE)
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


def _jax_hashes(cat, starts, widths, normalize):
    """The JAX package's numpy hash of each window, width by width."""
    from metamdbg_tpu.count.kminmers import normalize_rows as jnormalize
    from metamdbg_tpu.utils import hashing as jhashing

    h1 = np.zeros(starts.shape[0], np.uint64)
    h2 = np.zeros_like(h1)
    for w in np.unique(widths).tolist():
        sel = np.flatnonzero(widths == w)
        win = cat[starts[sel, None] + np.arange(w)]
        if normalize:
            win = jnormalize(win)[0]
        h1[sel], h2[sel] = jhashing.murmur128_u32rows(win)
    return h1, h2


def _unitigs(seed, n, max_w):
    """Back-to-back sequences of 1..max_w words (the deterministic order's
    shape: one window per whole sequence) and their starts and widths. The
    widths take at most 40 values: the plain version runs once per
    distinct width."""
    rng = np.random.default_rng(seed)
    widths = rng.choice(np.unique(np.geomspace(1, max_w, 40).astype(int)),
                        size=n)
    widths[:3] = (max_w, max_w - 1, 1)
    rng.shuffle(widths)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    return _stream(int(widths.sum()) + 64, seed), starts, widths


@pytest.mark.parametrize("shape", ["unitigs_5000", "narrow_unitigs"])
def test_per_window_widths_match_jax_package(shape):
    """Per-window widths up to 5,000 words (whole unitigs, disjoint and
    back to back) against the JAX package's numpy hash, both modes."""
    max_w, n = (5000, 24) if shape == "unitigs_5000" else (40, 600)
    cat, starts, widths = _unitigs(11, n, max_w)
    for normalize in (False, True):
        got = [_u64(h) for h in kw.hash_windows(
            _t(cat), torch.from_numpy(starts), torch.from_numpy(widths),
            normalize)]
        want = _jax_hashes(cat, starts, widths, normalize)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _layout(name, seed):
    """Starts in a layout the kernel handles on a path of its own:
    `disjoint`, row slices as hash_rows makes them (starts = i*k + first);
    `unsorted`, every window of a stream in a shuffled order."""
    rng = np.random.default_rng(seed)
    if name == "disjoint":
        k, first, w = 24, 1, 22
        cat = _stream(3000 * k, seed)
        starts = np.arange(3000, dtype=np.int64) * k + first
        return cat, starts, w
    w = 17
    cat = _stream(20000, seed)
    starts = rng.permutation(cat.shape[0] - w + 1).astype(np.int64)
    return cat, starts, w


@pytest.mark.parametrize("layout", ["disjoint", "unsorted"])
def test_start_layouts_match_jax_package(layout):
    cat, starts, w = _layout(layout, seed=12)
    widths = np.full(starts.shape[0], w)
    for normalize in (False, True):
        got = [_u64(h) for h in kw.hash_windows(
            _t(cat), torch.from_numpy(starts), w, normalize)]
        want = _jax_hashes(cat, starts, widths, normalize)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _range_case(kind, n=100, w=5):
    """Windows that end exactly at the stream's end, and the same with one
    window one word past it."""
    starts = torch.arange(n - w + 1)
    if kind == "fixed":
        width = w
    else:
        width = torch.full_like(starts, w)
        width[::7] = 1
    past = starts.clone()
    past[len(past) // 2] = n - w + 1
    return width, starts, past


@pytest.mark.parametrize("kind", ["fixed", "per_window"])
def test_range_check_raises_one_past_the_end(kind):
    cat = torch.arange(100, dtype=torch.int64)
    width, starts, past = _range_case(kind)
    kw.hash_windows(cat, starts, width, True)
    with pytest.raises(ValueError, match="outside"):
        kw.hash_windows(cat, past, width, True)
    with pytest.raises(ValueError, match="outside"):
        kw.hash_windows(cat, torch.tensor([-1]), 5, False)
    if kind == "per_window":
        bad = width.clone()
        bad[3] = 0
        with pytest.raises(ValueError, match=">= 1"):
            kw.hash_windows(cat, starts, bad, True)


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


# -- the segmented mode: every window of each sequence of a stream ----------

SEGMENT_CASES = ["w1", "w2", "w3", "w4", "w5", "w16", "w123", "mixed"]


def _seqs(seed, n, w):
    """Reads-like sequences for width w: empty ones, ones shorter than w,
    of exactly w words and longer, cut from a stream whose words reach
    2^32 - 1 (half of them set the int32 carriage's sign bit), every third
    long enough one opening with a palindromic window."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3 * w + 8, size=n)
    lens[:4] = (0, w - 1, w, w + 1)
    rng.shuffle(lens)
    cat = _stream(int(lens.sum()) + 64, seed, high=1 << 32)
    seqs = np.split(cat[:lens.sum()], np.cumsum(lens)[:-1])
    for s in seqs[::3]:
        if s.shape[0] >= w:
            h = w // 2
            s[w - h:w] = s[:h][::-1].copy()
    return seqs


def _jax_segment(seqs, w, normalize):
    """The JAX package's hash of every w-window of each sequence, in
    sequence then position order, and the window offsets: numpy
    (normalize_rows + murmur128_u32rows, or raw rows), and for normalized
    windows also the XLA sweep on padded rows + lengths
    (parallel/count_table._window_hash_pairs), which must agree."""
    from metamdbg_tpu.count.kminmers import normalize_rows as jnormalize
    from metamdbg_tpu.parallel.count_table import _window_hash_pairs
    from metamdbg_tpu.utils import hashing as jhashing

    lens = np.array([s.shape[0] for s in seqs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(np.maximum(lens - w + 1, 0))])
    wins = [np.lib.stride_tricks.sliding_window_view(s, w)
            for s in seqs if s.shape[0] >= w]
    if not wins:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64), offsets
    win = np.concatenate(wins)
    if normalize:
        win = jnormalize(win)[0]
    h1, h2 = jhashing.murmur128_u32rows(np.ascontiguousarray(win))
    if normalize:
        rows = np.zeros((len(seqs), max(int(lens.max()), w)), np.uint32)
        for r, s in enumerate(seqs):
            rows[r, :s.shape[0]] = s
        out = [np.asarray(x) for x in _window_hash_pairs(
            rows, lens.astype(np.int32), w)]
        valid = out[4]
        for h, lo, hi in ((h1, out[0], out[1]), (h2, out[2], out[3])):
            xla = (lo[valid].astype(np.uint64)
                   | (hi[valid].astype(np.uint64) << np.uint64(32)))
            np.testing.assert_array_equal(xla, h)
    return h1, h2, offsets


def _segment_request(case, device="cpu"):
    """(segments, the host sequences and (width, normalize) of each); the
    second stream of "mixed" is moved to `device`."""
    if case != "mixed":
        w = int(case[1:])
        seqs = _seqs(20 + w, 40, w)
        st = kw.Stream(seqs)
        return [kw.Segment(st, w, True), kw.Segment(st, w, False, 3, 37),
                kw.Segment(st, w, True, 5, 5)], [
            (seqs, w, True), (seqs[3:37], w, False), ([], w, True)]
    a, b = _seqs(30, 60, 16), _seqs(31, 25, 123)
    short = [s[:3] for s in a[:10]]  # every sequence shorter than w = 4
    on_device = kw.Stream(b).to(device)
    host = kw.Stream(a + short)
    spec = [(host, 1, False, 0, 60), (on_device, 123, True, 0, 25),
            (host, 16, True, 10, 50), (host, 4, True, 60, 70),
            (on_device, 5, False, 2, 20), (host, 2, True, 7, 7),
            (host, 3, True, 0, 70)]
    seqs_of = {id(host): a + short, id(on_device): b}
    return ([kw.Segment(st, w, nz, lo, hi) for st, w, nz, lo, hi in spec],
            [(seqs_of[id(st)][lo:hi], w, nz) for st, w, nz, lo, hi in spec])


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segments_match_jax_package(case):
    """The segmented mode (every window of each sequence named by its
    stream, one request for several segments) against the JAX package's
    hashes of the same windows, and against the explicit-starts mode on
    the same stream: sequences shorter than w and empty ones, empty
    segments, words >= 2^31, palindromic windows, widths 1-5, 16 and 123,
    and segments of several widths, normalize on and off, over a host
    stream and one moved to the device, in one request."""
    segments, want = _segment_request(case)
    got = kw.hash_segments(segments, "cpu")
    assert len(got) == len(want)
    for (h1, h2, offsets), (seqs, w, normalize) in zip(got, want):
        j1, j2, joff = _jax_segment(seqs, w, normalize)
        np.testing.assert_array_equal(_u64(h1), j1)
        np.testing.assert_array_equal(_u64(h2), j2)
        np.testing.assert_array_equal(offsets.numpy(), joff)
        if j1.shape[0]:
            cat = np.concatenate(seqs).astype(np.int64)
            lens = np.array([s.shape[0] for s in seqs])
            starts = np.concatenate([
                o + np.arange(max(n - w + 1, 0))
                for o, n in zip(np.cumsum(lens) - lens, lens)])
            e1, e2 = kw.hash_windows(torch.from_numpy(cat),
                                     torch.from_numpy(starts), w, normalize)
            assert torch.equal(e1, h1) and torch.equal(e2, h2)
    assert any(int(g[0].numel()) == 0 for g in got)  # an empty segment


def test_segment_checks_raise_before_launch():
    st = kw.Stream([np.arange(10, dtype=np.uint32)])
    for bad in (kw.Segment(st, 0), kw.Segment(st, True),
                kw.Segment(st, 3, lo=1, hi=2 + len(st)),
                kw.Segment(st, 3, lo=1, hi=0)):
        with pytest.raises(ValueError):
            kw.hash_segments([bad], "cpu")
    with pytest.raises(ValueError, match="Stream"):
        kw.hash_segments([kw.Segment([np.arange(4)], 2)], "cpu")
    with pytest.raises(ValueError, match="no window hash kernel"):
        kw.hash_segments([kw.Segment(st, 3)], "meta")
    kw.reset_counts()
    (h1, _, off), = kw.hash_segments([kw.Segment(st, 3)], "cpu")
    assert h1.shape == (8,) and off.tolist() == [0, 8] and kw.launches == 0


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _same(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("w", [4, 5, 6, 7, 16, 61] + WIDE + [4000])
def test_cuda_kernel_matches_reference(w):
    """The CUDA kernel against the plain version on the card, both modes,
    fixed and per-window widths: bit-identical."""
    _need_gpu()
    cat = _t(_stream(1 << 16, seed=40 + w)).cuda()
    # w = 4000: the plain version hashes 2,048 windows of it
    n = cat.numel() - w + 1 if w <= 1000 else 2048
    starts = torch.arange(n, device="cuda")
    for normalize in (True, False):
        got = kw.hash_windows(cat, starts, w, normalize)
        torch.cuda.synchronize()
        want = kw.hash_windows_reference(cat, starts, w, normalize)
        assert _same(got, want)
    if w <= 61:
        widths = torch.randint(1, w + 1, starts.shape, device="cuda")
    else:
        # the plain version's cost grows with the distinct widths' sum
        choices = torch.tensor(sorted({1, 2, 3, 5, w // 3, w // 2, w - 1,
                                       w}), device="cuda")
        widths = choices[torch.randint(0, choices.numel(), starts.shape,
                                       device="cuda")]
    got = kw.hash_windows(cat, starts, widths, True)
    want = kw.hash_windows_reference(cat, starts, widths, True)
    assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["unitigs_5000", "narrow_unitigs"])
def test_cuda_per_window_widths(shape):
    """Whole unitigs up to 5,000 words: the kernel against the plain
    version on the card, both modes."""
    _need_gpu()
    max_w, n = (5000, 600) if shape == "unitigs_5000" else (40, 20000)
    cat, starts, widths = (torch.from_numpy(x.astype(np.int64)).cuda()
                           for x in _unitigs(13, n, max_w))
    for normalize in (False, True):
        got = kw.hash_windows(cat, starts, widths, normalize)
        want = kw.hash_windows_reference(cat, starts, widths, normalize)
        assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["disjoint", "unsorted"])
def test_cuda_start_layouts(layout):
    _need_gpu()
    cat, starts, w = _layout(layout, seed=14)
    cat, starts = _t(cat).cuda(), torch.from_numpy(starts).cuda()
    for normalize in (False, True):
        got = kw.hash_windows(cat, starts, w, normalize)
        want = kw.hash_windows_reference(cat, starts, w, normalize)
        assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fixed", "per_window"])
def test_cuda_range_check_raises(kind):
    _need_gpu()
    cat = torch.arange(100, dtype=torch.int64, device="cuda")
    width, starts, past = _range_case(kind)
    if not isinstance(width, int):
        width = width.cuda()
    got = kw.hash_windows(cat, starts.cuda(), width, True)
    assert _same(got, kw.hash_windows_reference(cat, starts.cuda(), width,
                                                True))
    with pytest.raises(ValueError, match="outside"):
        kw.hash_windows(cat, past.cuda(), width, True)
    if kind == "per_window":
        bad = width.clone()
        bad[3] = 0
        with pytest.raises(ValueError, match=">= 1"):
            kw.hash_windows(cat, starts.cuda(), bad, True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_cuda_segments_match_reference(case):
    """The segmented kernel against its plain version on the card, on the
    same requests as the CPU test: bit-identical, one launch a request."""
    _need_gpu()
    segments, _ = _segment_request(case, "cuda")
    kw.reset_counts()
    got = kw.hash_segments(segments, "cuda")
    assert kw.launches == 1
    segs, n_total, table = kw._prepare(segments, "cuda")
    out = kw._launch_segments(segs, n_total, table)
    torch.cuda.synchronize()
    assert torch.equal(out, kw.hash_segments_reference(segs, n_total))
    assert torch.equal(torch.cat([g[0] for g in got]), out[:n_total])
    assert torch.equal(torch.cat([g[1] for g in got]), out[n_total:])
