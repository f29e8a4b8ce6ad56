"""Palindromic k-min-mer purging (HiFi / skip-correction path).

Matches Commons::purgePalindrome (src/Commons.hpp:1617-1723): repeatedly scan
k = firstK .. lastK-1 over the read's non-banned minimizer positions; the
first window of k consecutive (skipping banned) minimizers that is a
palindrome — first floor(k/2) values equal to the reversed last floor(k/2)
(KmerVec::isPalindrome, src/Commons.hpp:918-921) — gets its FIRST position
banned and the whole scan restarts. Surviving minimizers are returned.

A vectorized pre-check handles the overwhelmingly common case (no repeated
minimizer value within lastK-1 positions => no palindrome possible at any k)
so the exact sequential algorithm only runs on the rare candidate reads.
"""

import numpy as np


def _is_palindrome(window: np.ndarray) -> bool:
    half = window.shape[0] // 2
    return bool(np.array_equal(window[:half], window[::-1][:half]))


def _has_close_duplicate(minimizers: np.ndarray, max_dist: int) -> bool:
    n = minimizers.shape[0]
    if n < 2:
        return False
    order = np.argsort(minimizers, kind="stable")
    sorted_vals = minimizers[order]
    same = sorted_vals[1:] == sorted_vals[:-1]
    if not same.any():
        return False
    # any equal pair within max_dist positions? check adjacent-in-sorted pairs
    # of equal value only (sufficient: palindrome outer pair is an equal pair)
    d = np.abs(order[1:] - order[:-1])
    if (same & (d <= max_dist)).any():
        return True
    # equal values may be non-adjacent in sorted order within runs; check runs
    run_breaks = np.flatnonzero(~same)
    start = 0
    for b in np.append(run_breaks, n - 1):
        if b > start:
            pos = np.sort(order[start: b + 1])
            if (np.diff(pos) <= max_dist).any():
                return True
        start = b + 1
    return False


def purge_palindrome(minimizers: np.ndarray, first_k: int, last_k: int) -> np.ndarray:
    minimizers = np.asarray(minimizers)
    n = minimizers.shape[0]
    if n < first_k or not _has_close_duplicate(minimizers, last_k - 1):
        return minimizers

    banned = np.zeros(n, dtype=bool)
    while True:
        has_palindrome = False
        for k in range(first_k, last_k):
            alive = np.flatnonzero(~banned)
            if alive.shape[0] < k:
                continue
            vals = minimizers[alive]
            # all k-windows at once; candidates must have equal outermost
            # pair, then the first (lowest i) full half-palindrome wins —
            # identical to the sequential scan's first hit
            win = np.lib.stride_tricks.sliding_window_view(vals, k)
            half = k // 2
            cand = np.flatnonzero(win[:, 0] == win[:, k - 1])
            if cand.size == 0:
                continue
            w = win[cand]
            ok = (w[:, :half] == w[:, ::-1][:, :half]).all(axis=1)
            hits = cand[ok]
            if hits.size:
                banned[alive[hits[0]]] = True
                has_palindrome = True
                break
        if not has_palindrome:
            break
    return minimizers[~banned]
