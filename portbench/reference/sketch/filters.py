"""Read filters: trinucleotide complexity (DUST-like) and quality model.

Matches ReadSelectionFunctor (src/readSelection/ReadSelection.hpp:869-920,
1171-1369):
- complexity: direct trinucleotide k-mers over the ORIGINAL sequence,
  windows of 64 k-mers stepping 32 (incomplete tail windows ignored);
  window score = sum_t c_t*(c_t-1)/2 / 61; read score = mean over windows;
  score > 5 => drop the read's minimizers (record still written, empty).
- mean read quality: phred -> error-rate float table
  (Utils::transformQuality, src/Commons.hpp:2338), long-double sum,
  ``-10*log10(mean_error)``; reads below --min-read-quality are dropped.
- per-minimizer quality: min base quality over the minimizer's original-
  coordinate span [rle_pos[p], rle_pos[p+l]) (ReadSelection.hpp:1302-1321);
  reads without quality strings get quality 1 per minimizer.
"""

import ctypes
import ctypes.util

import numpy as np

from ..constants import COMPLEXITY_STEP, COMPLEXITY_WINDOW
from . import kmers as _kmers

# The reference computes the read quality with C float math
# (``-10.0f * log10(float)`` resolves to log10f); numpy's float32 log10
# differs from glibc's log10f by 1 ulp on some inputs, so we call libm for
# the scalar per-read value to keep byte parity of the record files.
_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.log10f.restype = ctypes.c_float
_libm.log10f.argtypes = [ctypes.c_float]

# float32 phred->error table, indexed by raw quality byte (ReadSelection.hpp:101-104)
_QUAL_TABLE = np.zeros(256, dtype=np.float32)
for _q in range(33, 128):
    _QUAL_TABLE[_q] = np.float32(10.0) ** np.float32(-(_q - 33) / 10.0)


def sequence_complexity(seq_bytes: np.ndarray, w: int = COMPLEXITY_WINDOW,
                        step: int = COMPLEXITY_STEP) -> float:
    """DUST-like trinucleotide score (ReadSelection.hpp:1171-1228).

    Returns NaN when the read has no complete window (the reference's 0/0);
    callers treat NaN as "keep" since NaN > 5 is false.
    """
    codes, bad = _kmers.base_codes(seq_bytes)
    kvals, valid = _kmers.direct_kmers(codes, bad, 3)
    nk = kvals.shape[0]
    if nk < w:
        return float("nan")
    l = w - 2
    starts = np.arange(0, nk, step)
    starts = starts[starts + w <= nk]
    if starts.size == 0:
        return float("nan")
    # windows x 64 counts via bincount over (window_id * 64 + kmer)
    win_ids = np.repeat(np.arange(starts.size), w)
    offs = (starts[:, None] + np.arange(w)[None, :]).ravel()
    kk = kvals[offs]
    ok = valid[offs]
    flat = win_ids[ok] * 64 + kk[ok].astype(np.int64)
    counts = np.bincount(flat, minlength=starts.size * 64).reshape(starts.size, 64)
    counts = counts.astype(np.float64)
    scores = (counts * (counts - 1.0) / 2.0).sum(axis=1) / (l - 1.0)
    return float(scores.mean())


def mean_read_quality(qual_bytes: np.ndarray) -> float:
    """float32 mean read quality (ReadSelection.hpp:870-879)."""
    qual_bytes = np.asarray(qual_bytes, dtype=np.uint8)
    if qual_bytes.size == 0:
        return float("nan")
    # sequential long-double accumulation in read order (cumsum is ordered;
    # np.sum's pairwise order could round differently at the f32 boundary)
    err_sum = np.cumsum(_QUAL_TABLE[qual_bytes].astype(np.longdouble))[-1]
    mean_err = np.float32(err_sum / qual_bytes.size)
    log10f = np.float32(_libm.log10f(ctypes.c_float(float(mean_err))))
    return float(np.float32(np.float32(-10.0) * log10f))


def minimizer_min_qualities(qual_bytes: np.ndarray, rle_positions: np.ndarray,
                            positions: np.ndarray, l: int) -> np.ndarray:
    """u8 min quality per minimizer span (ReadSelection.hpp:1135,1302-1321)."""
    positions = np.asarray(positions, dtype=np.int64)
    if qual_bytes is None or np.asarray(qual_bytes).size == 0:
        return np.ones(positions.shape[0], dtype=np.uint8)
    qual_bytes = np.asarray(qual_bytes, dtype=np.uint8)
    q = qual_bytes.astype(np.int32) - 33
    rp = np.asarray(rle_positions, dtype=np.int64)
    starts = rp[positions]
    ends = rp[positions + l]
    # span minimum via one reduceat over interleaved (start, end-1) bounds:
    # segment 2i covers [start_i, end_i-1) (reduceat returns q[start] when
    # the pair is equal, i.e. a length-1 span), then fold in q[end_i-1].
    out = np.full(positions.shape[0], 255, dtype=np.uint8)
    nz = np.flatnonzero(ends > starts)
    if nz.size:
        s = starts[nz]
        e = ends[nz]
        inds = np.empty(2 * nz.size, np.int64)
        inds[0::2] = s
        inds[1::2] = e - 1
        red = np.minimum.reduceat(q, inds)[0::2]
        out[nz] = np.minimum(red, q[e - 1]).astype(np.uint8)
    return out
