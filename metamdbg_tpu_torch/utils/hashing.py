"""MurmurHash3 in torch, on int64 bit patterns: the minimizer selection
hash and the 128-bit k-min-mer identity hash.

The minimizer test of the reference (src/utils/kmer/Kmer.hpp:1421,1434) is
``double(MurmurHash3_x64_128(key, 8, seed=42).low64) < double(float(d)) *
double(2^64 - 1)``; a k-min-mer's identity is MurmurHash3_x64_128 of its
u32 minimizers, seed 0 (src/Commons.hpp:956-969). CPU torch has no
unsigned 64-bit shifts or compares, so a u64 lives here as the int64 with
the same bits:

- multiply and add wrap in int64 exactly as in uint64;
- a logical right shift is an arithmetic shift with the sign bits masked
  off (`lsr`);
- an unsigned compare flips the sign bit of both sides first (`u64_lt`).

The same functions run on CUDA tensors; they are the plain versions the
sketch kernel (csrc/sketch.cu) and the window hash kernel
(csrc/window_hash.cu) are held against.
"""

import functools

import torch

_SIGN = -(1 << 63)


def as_i64(x: int) -> int:
    """A u64 constant as the Python int of the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_C1 = as_i64(0x87C37B91114253D5)
_C2 = as_i64(0x4CF5AD432745937F)
_F1 = as_i64(0xFF51AFD7ED558CCD)
_F2 = as_i64(0xC4CEB9FE1A85EC53)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns, 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lsr(x, 64 - r)


def fmix64(k: torch.Tensor) -> torch.Tensor:
    k = k ^ lsr(k, 33)
    k = k * _F1
    k = k ^ lsr(k, 33)
    k = k * _F2
    return k ^ lsr(k, 33)


def murmur64_u64key(keys: torch.Tensor, seed: int = 42) -> torch.Tensor:
    """Low 64 bits of MurmurHash3_x64_128 of each 8-byte key.

    `keys` and the result are int64 bit patterns of u64 values; the twin of
    metamdbg_tpu/utils/hashing.py:murmur64_u64key (MurmurHash3.cpp:246-322
    for len=8: no blocks, an 8-byte tail, k2 untouched).
    """
    keys = keys.to(torch.int64)
    k1 = keys * _C1
    k1 = rotl(k1, 31)
    k1 = k1 * _C2
    h1 = k1 ^ as_i64(seed ^ 8)
    h2 = as_i64(seed ^ 8)
    h1 = h1 + h2
    h2 = h1 + h2
    return fmix64(h1) + fmix64(h2)


def _murmur_k1(k1: torch.Tensor) -> torch.Tensor:
    return rotl(k1 * _C1, 31) * _C2


def _murmur_k2(k2: torch.Tensor) -> torch.Tensor:
    return rotl(k2 * _C2, 33) * _C1


def murmur128_u32rows(rows: torch.Tensor, seed: int = 0):
    """MurmurHash3_x64_128_original over rows of u32 values, each row hashed
    as its 4*k little-endian bytes (KmerVec::hash128, src/Commons.hpp:956-969).

    `rows` is (N, k) (or (k,)) holding u32 values in any integer dtype; the
    result is (h1, h2), int64 bit patterns of the two u64 halves. The twin
    of metamdbg_tpu/utils/hashing.py:murmur128_u32rows, including its tail
    order for k % 4 == 3 (k2 takes the third tail word before k1 takes the
    first two).
    """
    if rows.dim() == 1:
        rows = rows[None, :]
    r = rows.to(torch.int64) & 0xFFFFFFFF
    n, k = r.shape
    h1 = torch.full((n,), as_i64(seed), dtype=torch.int64, device=r.device)
    h2 = h1.clone()
    for b in range(k // 4):
        j = 4 * b
        h1 = h1 ^ _murmur_k1(r[:, j] | (r[:, j + 1] << 32))
        h1 = (rotl(h1, 27) + h2) * 5 + 0x52DCE729
        h2 = h2 ^ _murmur_k2(r[:, j + 2] | (r[:, j + 3] << 32))
        h2 = (rotl(h2, 31) + h1) * 5 + 0x38495AB5
    base = 4 * (k // 4)
    rem = k % 4
    if rem == 3:
        h2 = h2 ^ _murmur_k2(r[:, base + 2])
    if rem >= 1:
        k1 = r[:, base]
        if rem >= 2:
            k1 = k1 | (r[:, base + 1] << 32)
        h1 = h1 ^ _murmur_k1(k1)
    h1 = h1 ^ (4 * k)
    h2 = h2 ^ (4 * k)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = fmix64(h1)
    h2 = fmix64(h2)
    h1 = h1 + h2
    return h1, h2 + h1


def u64_lt(x: torch.Tensor, t: int) -> torch.Tensor:
    """Unsigned ``x < t`` for int64 bit patterns x and a Python int
    0 <= t <= 2^64."""
    if t >= 1 << 64:
        return torch.ones_like(x, dtype=torch.bool)
    return (x ^ _SIGN) < (as_i64(t) ^ _SIGN)


@functools.lru_cache(maxsize=None)
def _exact_u64_threshold(density: float) -> int:
    """Smallest u64 t such that for all u64 h < t: double(h) < bound, and for
    all h >= t: double(h) >= bound — i.e. the integer cut making
    ``h < t`` equivalent to ``double(h) < bound``. Cached: the 64-step
    search costs ~0.1 ms of Python, once per density.
    """
    import numpy as np

    bound = float(np.float64(np.float32(density)) * np.float64(np.uint64(0xFFFFFFFFFFFFFFFF)))
    # double(h) is monotone non-decreasing in h, so the predicate
    # double(h) < bound is a prefix property; binary search the cut.
    lo_, hi_ = 0, 1 << 64
    while lo_ < hi_:
        mid = (lo_ + hi_) // 2
        if float(np.uint64(mid).astype(np.float64)) < bound:
            lo_ = mid + 1
        else:
            hi_ = mid
    return lo_


def minimizer_is_selected(values: torch.Tensor, density: float) -> torch.Tensor:
    """Universe-hash minimizer test on canonical l-mer values (int64)."""
    h = murmur64_u64key(values, seed=42)
    return u64_lt(h, _exact_u64_threshold(density))
