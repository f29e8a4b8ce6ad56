"""Length statistics matching the reference's exact conventions."""

import numpy as np


def compute_n50(lengths: np.ndarray) -> int:
    """Commons::computeN50 (src/Commons.hpp:2291-2322).

    Note the reference's exact (slightly unusual) convention: lengths sorted
    descending, cumulative sums computed, then both arrays reversed; N50 is
    the first (ascending-order) length whose reversed-cumulative value is
    below half the total, defaulting to the largest length.
    """
    lengths = np.asarray(lengths, dtype=np.uint32)
    if lengths.size == 0:
        return 0
    desc = np.sort(lengths)[::-1]
    cumul = np.cumsum(desc.astype(np.uint64))
    asc = desc[::-1]
    cum_rev = cumul[::-1]
    half = int(cumul[-1]) // 2
    below = np.flatnonzero(cum_rev < half)
    if below.size:
        return int(asc[below[0]])
    return int(asc[-1])


def compute_mean_length(lengths: np.ndarray) -> int:
    """Commons::computeMeanLength (src/Commons.hpp:2324-2336): long-double
    mean truncated to integer."""
    lengths = np.asarray(lengths, dtype=np.uint32)
    if lengths.size == 0:
        return 0
    return int(np.longdouble(lengths.sum(dtype=np.uint64)) / np.longdouble(lengths.size))


def compute_median(values: np.ndarray):
    values = np.asarray(values)
    if values.size == 0:
        return 0
    s = np.sort(values)
    return s[values.size // 2]
