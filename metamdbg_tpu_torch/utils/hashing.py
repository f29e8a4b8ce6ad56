"""MurmurHash3 minimizer selection in torch, on int64 bit patterns.

The minimizer test of the reference (src/utils/kmer/Kmer.hpp:1421,1434) is
``double(MurmurHash3_x64_128(key, 8, seed=42).low64) < double(float(d)) *
double(2^64 - 1)``. CPU torch has no unsigned 64-bit shifts or compares, so
a u64 lives here as the int64 with the same bits:

- multiply and add wrap in int64 exactly as in uint64;
- a logical right shift is an arithmetic shift with the sign bits masked
  off (`lsr`);
- an unsigned compare flips the sign bit of both sides first (`u64_lt`).

The same functions run on CUDA tensors; they are the plain versions the
sketch kernel (csrc/sketch.cu) is held against.
"""

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


def u64_lt(x: torch.Tensor, t: int) -> torch.Tensor:
    """Unsigned ``x < t`` for int64 bit patterns x and a Python int
    0 <= t <= 2^64."""
    if t >= 1 << 64:
        return torch.ones_like(x, dtype=torch.bool)
    return (x ^ _SIGN) < (as_i64(t) ^ _SIGN)


def _exact_u64_threshold(density: float) -> int:
    """Smallest u64 t such that for all u64 h < t: double(h) < bound, and for
    all h >= t: double(h) >= bound — i.e. the integer cut making
    ``h < t`` equivalent to ``double(h) < bound``.
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
