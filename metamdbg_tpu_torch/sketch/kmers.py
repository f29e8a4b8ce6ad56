"""2-bit base codes (KmerModel, src/utils/kmer/Kmer.hpp:458-835).

base code = ``(ascii >> 1) & 3`` => A=0, C=1, T=2, G=3; the "bad char" bit
is ``(ascii >> 3) & 1`` (true for N and most non-ACGT) (Kmer.hpp:462). The
canonical l-mers themselves are computed by the sketch kernel and its plain
version (kernels/sketch.py).
"""

import numpy as np


def base_codes(seq_bytes: np.ndarray):
    """(codes u8, bad bool) from ascii bytes."""
    seq_bytes = np.asarray(seq_bytes, dtype=np.uint8)
    codes = (seq_bytes >> 1) & np.uint8(3)
    bad = ((seq_bytes >> 3) & np.uint8(1)).astype(bool)
    return codes, bad
