"""2-bit base codes and canonical k-mers (KmerModel, src/utils/kmer/Kmer.hpp:458-835).

base code = ``(ascii >> 1) & 3`` => A=0, C=1, T=2, G=3; the "bad char" bit
is ``(ascii >> 3) & 1`` (true for N and most non-ACGT) (Kmer.hpp:462). The
canonical l-mers of the minimizer sketch are computed by the sketch kernel
and its plain version (kernels/sketch.py); `canonical_kmers` is the host
numpy form the base-space contig filters use (tiling.py), a copy of
metamdbg_tpu/sketch/kmers.py:canonical_kmers.
"""

import numpy as np

_U64 = np.uint64
INVALID_KMER = _U64(0xFFFFFFFFFFFFFFFF)


def base_codes(seq_bytes: np.ndarray):
    """(codes u8, bad bool) from ascii bytes."""
    seq_bytes = np.asarray(seq_bytes, dtype=np.uint8)
    codes = (seq_bytes >> 1) & np.uint8(3)
    bad = ((seq_bytes >> 3) & np.uint8(1)).astype(bool)
    return codes, bad


def canonical_kmers(codes: np.ndarray, bad: np.ndarray, l: int):
    """All length-l windows: (values u64, directions u8, valid bool).

    values[i] = canonical kmer of codes[i:i+l] (ties pick the reverse,
    Kmer.hpp:427); INVALID_KMER where the window holds a bad char. Empty
    arrays when the sequence is shorter than l.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    nk = codes.shape[0] - l + 1
    if nk <= 0:
        e = np.zeros(0, dtype=_U64)
        return e, np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=bool)

    c64 = codes.astype(_U64)
    comp64 = _U64(2) ^ c64  # comp_NT = {2,3,0,1} == code ^ 2
    fwd = np.zeros(nk, dtype=_U64)
    rev = np.zeros(nk, dtype=_U64)
    for j in range(l):
        fwd |= c64[j: j + nk] << _U64(2 * (l - 1 - j))
        rev |= comp64[j: j + nk] << _U64(2 * j)

    invalid = np.convolve(np.asarray(bad, dtype=np.int32),
                          np.ones(l, dtype=np.int32), mode="valid") > 0

    choice_rev = ~(fwd < rev)
    values = np.where(choice_rev, rev, fwd)
    directions = choice_rev.astype(np.uint8)
    values = np.where(invalid, INVALID_KMER, values)
    return values, directions, ~invalid
