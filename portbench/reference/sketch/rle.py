"""Homopolymer-compression (RLE) of reads, vectorized.

Mirrors EncoderRLE (src/Commons.hpp:4159-4203): with compression on, each
homopolymer run is collapsed to one base and ``rle_positions[j]`` records the
original start index of run ``j``; one extra trailing entry holds the original
sequence length. With compression off, the sequence is unchanged and
``rle_positions = arange(n)`` (no trailing entry — the reference keeps the
same asymmetry).
"""

import numpy as np


def rle_encode(seq_bytes: np.ndarray, use_homopolymer_compression: bool):
    """seq_bytes: (n,) uint8 ascii. Returns (rle_bytes, rle_positions[u64])."""
    seq_bytes = np.asarray(seq_bytes, dtype=np.uint8)
    n = seq_bytes.shape[0]
    if not use_homopolymer_compression:
        return seq_bytes, np.arange(n, dtype=np.uint64)
    if n == 0:
        return seq_bytes, np.zeros(0, dtype=np.uint64)
    run_start = np.empty(n, dtype=bool)
    run_start[0] = True
    np.not_equal(seq_bytes[1:], seq_bytes[:-1], out=run_start[1:])
    starts = np.flatnonzero(run_start)
    rle = seq_bytes[starts]
    positions = np.empty(starts.shape[0] + 1, dtype=np.uint64)
    positions[:-1] = starts
    positions[-1] = n
    return rle, positions
