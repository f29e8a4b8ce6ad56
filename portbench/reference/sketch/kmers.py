"""Rolling canonical 2-bit k-mer model, vectorized (host golden path).

Matches KmerModel / KmerModelDirect (src/utils/kmer/Kmer.hpp:458-835):

- base code = ``(ascii >> 1) & 3`` => A=0, C=1, T=2, G=3; the "bad char" bit
  is ``(ascii >> 3) & 1`` (true for N and most non-ACGT) (Kmer.hpp:462).
- forward value rolls bases in from the right; reverse-complement value is
  the complement rolled from the left; canonical = numeric min with
  direction 0 when forward < revcomp else 1 (KmerCanonical::updateChoice,
  Kmer.hpp:427: ties pick the reverse slot).
- any window containing a bad char yields value ``2^64 - 1`` ("skipped as
  minimizer", Kmer.hpp:567,580).

Instead of rolling sequentially we compute all windows with an l-step
shift-accumulate over the whole sequence — identical values, batch-friendly,
and the same formulation the Pallas kernel uses on device.
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

    values[i] = canonical kmer of codes[i:i+l]; INVALID_KMER where the window
    holds a bad char. directions follow KmerCanonical::value(direction).
    Returns empty arrays when the sequence is shorter than l.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    nk = n - l + 1
    if nk <= 0:
        e = np.zeros(0, dtype=_U64)
        return e, np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=bool)

    c64 = codes.astype(_U64)
    comp64 = (_U64(2) ^ c64)  # comp_NT = {2,3,0,1} == code ^ 2
    fwd = np.zeros(nk, dtype=_U64)
    rev = np.zeros(nk, dtype=_U64)
    for j in range(l):
        fwd |= c64[j: j + nk] << _U64(2 * (l - 1 - j))
        rev |= comp64[j: j + nk] << _U64(2 * j)

    invalid = np.convolve(np.asarray(bad, dtype=np.int32), np.ones(l, dtype=np.int32),
                          mode="valid") > 0

    choice_rev = ~(fwd < rev)  # ties -> reverse slot (Kmer.hpp:427)
    values = np.where(choice_rev, rev, fwd)
    directions = choice_rev.astype(np.uint8)
    values = np.where(invalid, INVALID_KMER, values)
    return values, directions, ~invalid


def direct_kmers(codes: np.ndarray, bad: np.ndarray, l: int):
    """Forward-only windows (KmerModelDirect.iterate, Kmer.hpp:774-835)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    nk = n - l + 1
    if nk <= 0:
        return np.zeros(0, dtype=_U64), np.zeros(0, dtype=bool)
    c64 = codes.astype(_U64)
    fwd = np.zeros(nk, dtype=_U64)
    for j in range(l):
        fwd |= c64[j: j + nk] << _U64(2 * (l - 1 - j))
    invalid = np.convolve(np.asarray(bad, dtype=np.int32), np.ones(l, dtype=np.int32),
                          mode="valid") > 0
    fwd = np.where(invalid, INVALID_KMER, fwd)
    return fwd, ~invalid
