"""Kernel KW: canonical k-min-mer hashing of windows of a minimizer stream.

`hash_windows(cat, starts, w, normalize)` is the wrapper: on CUDA tensors
it launches the hand-written kernel in csrc/window_hash.cu (built by
kernels/build.py) or raises; on CPU tensors it runs
`hash_windows_reference`, the plain torch version in this module. Both
compute, for each start s, the window cat[s:s+w] (u32 values carried in an
int64 stream), made canonical when `normalize` (lexicographic min of it and
its reverse; a tie takes the reverse), hashed with MurmurHash3_x64_128,
seed 0, as 4*w little-endian bytes. Outputs are (h1, h2), int64 tensors
holding the u64 bits.

It is the port of what the JAX package computes three ways: in numpy
(count/kminmers.normalize_rows + utils/hashing.murmur128_u32rows), in
native SIMD (native/sketch.cpp:window_hash_batch, row_hash_batch) and in
XLA (parallel/count_table.py:_window_hash_pairs).

`w` is an int, or a 1-D int64 tensor with one width per start (the
variable-length unitig sequences of the deterministic order). A window
outside `cat` raises, on either device: the kernel checks each window
itself and sets a flag word that the wrapper reads after the outputs, the
one wait for the card per call; the plain version checks with torch ops.
`launches` counts kernel launches; the plain version counts nothing.
"""

import ctypes
import itertools
import random

import torch

from ..utils import hashing
from . import build

launches = 0

_SOURCES = ("window_hash.cu",)
# plain version: cap on the gathered (windows, w) elements per chunk
_BATCH_ELEMS = 8 << 20


def reset_counts():
    global launches
    launches = 0


def normalize_rows(windows: torch.Tensor):
    """KmerVec::normalize over rows: lexicographic min(row, reversed row).

    Ties (palindromes) pick the reversed copy (src/Commons.hpp:886-916).
    Returns (normalized rows, is_reversed bool); the twin of
    metamdbg_tpu/count/kminmers.py:normalize_rows.
    """
    n, k = windows.shape
    rev = windows.flip(1)
    neq = windows != rev
    first = torch.where(neq.any(dim=1), neq.to(torch.uint8).argmax(dim=1),
                        k - 1)[:, None]
    is_reversed = ~(windows.gather(1, first) < rev.gather(1, first))[:, 0]
    return torch.where(is_reversed[:, None], rev, windows), is_reversed


def _reference_fixed(cat, starts, w: int, normalize: bool):
    n = starts.shape[0]
    h1 = torch.empty(n, dtype=torch.int64, device=cat.device)
    h2 = torch.empty_like(h1)
    step = max(_BATCH_ELEMS // w, 1)
    ar = torch.arange(w, device=cat.device)
    for a in range(0, n, step):
        wins = cat[starts[a:a + step, None] + ar] & 0xFFFFFFFF
        if normalize:
            wins = normalize_rows(wins)[0]
        h1[a:a + step], h2[a:a + step] = hashing.murmur128_u32rows(wins)
    return h1, h2


def hash_windows_reference(cat: torch.Tensor, starts: torch.Tensor, w,
                           normalize: bool):
    """Plain torch version: gather the windows, normalise them with torch
    ops, hash them with utils/hashing.murmur128_u32rows."""
    if isinstance(w, int):
        return _reference_fixed(cat, starts, w, normalize)
    h1 = torch.empty(starts.shape[0], dtype=torch.int64, device=cat.device)
    h2 = torch.empty_like(h1)
    for width in torch.unique(w).tolist():
        sel = torch.nonzero(w == width).flatten()
        h1[sel], h2[sel] = _reference_fixed(cat, starts[sel], width,
                                            normalize)
    return h1, h2


def _lib() -> ctypes.CDLL:
    return _bind(build.load("window_hash", _SOURCES))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares window_hash.cu's C interface on a loaded library."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.window_hash_launch.argtypes = [vp, i64, vp, vp, i64, ctypes.c_int,
                                       ctypes.c_int, vp, i64, vp]
    lib.window_hash_launch.restype = ctypes.c_int
    lib.window_hash_error_string.argtypes = [ctypes.c_int]
    lib.window_hash_error_string.restype = ctypes.c_char_p
    return lib


def _enqueue(cat, starts, w, normalize: bool, out: torch.Tensor,
             token: int = 0):
    """Launches the kernel into `out`, (2n + 1,) int64: h1, h2, then the
    flag word, which the kernel sets to token + 1 if a window reaches
    outside the stream and to token + 2 if a width is below 1, and leaves
    alone otherwise. Does not wait for the card."""
    global launches
    lib = _lib()
    n = starts.shape[0]
    widths = None if isinstance(w, int) else w
    with torch.cuda.device(cat.device):
        stream = torch.cuda.current_stream(cat.device).cuda_stream
        err = lib.window_hash_launch(
            cat.data_ptr(), cat.numel(), starts.data_ptr(),
            None if widths is None else widths.data_ptr(), n,
            w if widths is None else 0, int(normalize), out.data_ptr(),
            token, stream)
    if err != 0:
        raise RuntimeError("window hash kernel launch failed: "
                           + lib.window_hash_error_string(err).decode())
    launches += 1


# One token per launch: the flag word of a fresh output holds whatever the
# allocator left there, which is a token + 1 or + 2 of this launch only if
# this launch wrote it (the tokens are distinct and spaced by 4).
_tokens = itertools.count(4 * random.getrandbits(48) + 4, 4)


def _launch(cat: torch.Tensor, starts: torch.Tensor, w, normalize: bool):
    n = starts.shape[0]
    out = torch.empty(2 * n + 1, dtype=torch.int64, device=cat.device)
    token = next(_tokens)
    _enqueue(cat, starts, w, normalize, out, token)
    flag = int(out[2 * n]) - token  # the one wait for the card
    if flag == 2:
        raise ValueError("window widths must be >= 1")
    if flag == 1:
        raise ValueError(f"windows reach outside the stream of "
                         f"{cat.numel()}")
    return out[:n], out[n:2 * n]


def _check_range(cat, starts, w):
    """The range check of the plain version; the kernel makes its own."""
    if not isinstance(w, int) and w.numel() and int(w.min()) < 1:
        raise ValueError("window widths must be >= 1")
    lo, hi = torch.stack([starts.min(), (starts + w).max()]).tolist()
    if lo < 0 or hi > cat.numel():
        raise ValueError(f"windows reach outside the stream: [{lo}, {hi}) "
                         f"of {cat.numel()}")


def hash_windows(cat: torch.Tensor, starts: torch.Tensor, w,
                 normalize: bool):
    """(h1, h2) of the window of width `w` at each of `starts` in `cat`, on
    the tensors' device. A window outside `cat`, or a width below 1,
    raises ValueError."""
    for name, t in (("cat", cat), ("starts", starts)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d int64 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if starts.device != cat.device:
        raise ValueError("cat and starts must lie on one device")
    if isinstance(w, int):
        if w < 1:
            raise ValueError(f"window width must be >= 1, got {w}")
    elif (w.dtype != torch.int64 or w.shape != starts.shape
          or not w.is_contiguous() or w.device != cat.device):
        raise ValueError("per-window widths must be a contiguous int64 "
                         "tensor shaped like starts, on its device")
    if starts.numel() == 0:
        return starts.clone(), starts.clone()
    if cat.device.type == "cuda":
        return _launch(cat, starts, w, normalize)
    if cat.device.type == "cpu":
        _check_range(cat, starts, w)
        return hash_windows_reference(cat, starts, w, normalize)
    raise ValueError(f"no window hash kernel for device {cat.device}")


def hash_rows(rows: torch.Tensor, first: int = 0, width: int | None = None):
    """(h1, h2) of the raw slice rows[:, first:first+width] (whole rows by
    default) of each row of an (N, k) int64 table of u32 values: the port
    of murmur128_u32rows over a row table, through `hash_windows`."""
    rows = rows.contiguous()
    n, k = rows.shape
    starts = torch.arange(n, dtype=torch.int64, device=rows.device) * k
    return hash_windows(rows.view(-1), starts + first,
                        k - first if width is None else width,
                        normalize=False)
