"""Minimizer selection (universe/FracMinHash sampling), host golden path.

Matches MinimizerParser::parse (src/utils/kmer/Kmer.hpp:1373-1456):
- canonical k-mers of the (possibly RLE'd) read,
- positions [1, nkmers-2] only (one k-mer trimmed at each end, _trimBps=1),
- selected iff ``double(MurmurHash3_x64_128(value, 8, 42)) < density * 2^64``,
- repetitive-minimizer blacklist applied on the *k-mer value*,
- emitted value is the canonical k-mer value truncated to u32 (MinimizerType),
  position is the k-mer index in the RLE'd read, direction from the canonical
  choice.

Invalid windows carry value 2^64-1 whose seed-42 hash (0xb6a8...) exceeds any
density bound < 0.7, so they are never selected — same effective behavior as
the reference's "max value skipped" comment.
"""

import numpy as np

from ..constants import MINIMIZER_DTYPE
from ..utils.hashing import minimizer_is_selected
from . import kmers as _kmers


def select_minimizers(codes: np.ndarray, bad: np.ndarray, l: int, density: float,
                      repetitive: np.ndarray | None = None, trim: int = 1):
    """Returns (minimizers u32, positions u32, directions u8).

    ``repetitive``: optional sorted u32 array of blacklisted minimizer values
    (repetitiveMinimizers.bin, ReadSelection.hpp:497-561).
    ``trim``: positions trimmed at each end (MinimizerParser::_trimBps,
    default 1; GenerateGfa's LoadUnitigsFunctor sets 0,
    src/graph/GenerateGfa.hpp:366).

    Production host path is the native batch sketcher (native/sketch.cpp,
    bit-identical — tests/test_sketch.py); the numpy path below is the
    golden reference and import-failure fallback.
    """
    from . import native_sketch
    if native_sketch.available():
        res = native_sketch.sketch_batch_native(
            [np.asarray(codes, np.uint8)], [np.asarray(bad, bool)], l,
            density, repetitive, trim, n_threads=1)
        if res is not None:
            vals, pos, dirs = res[0]
            return vals.astype(MINIMIZER_DTYPE), pos, dirs
    return select_minimizers_numpy(codes, bad, l, density, repetitive, trim)


def select_minimizers_numpy(codes: np.ndarray, bad: np.ndarray, l: int,
                            density: float,
                            repetitive: np.ndarray | None = None,
                            trim: int = 1):
    """Numpy golden path (the parity oracle for native + device twins)."""
    values, directions, _ = _kmers.canonical_kmers(codes, bad, l)
    nk = values.shape[0]
    if nk == 0:
        return (np.zeros(0, MINIMIZER_DTYPE), np.zeros(0, np.uint32),
                np.zeros(0, np.uint8))

    sel = minimizer_is_selected(values, density)
    if trim:
        sel[:trim] = False
        sel[-trim:] = False  # trim 1 each end (Kmer.hpp:1362,1395)

    if repetitive is not None and repetitive.size > 0:
        vals32 = values.astype(MINIMIZER_DTYPE)
        idx = np.searchsorted(repetitive, vals32)
        idx = np.minimum(idx, repetitive.size - 1)
        sel &= repetitive[idx] != vals32

    pos = np.flatnonzero(sel).astype(np.uint32)
    return values[pos].astype(MINIMIZER_DTYPE), pos, directions[pos]
