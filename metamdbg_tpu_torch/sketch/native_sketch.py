"""ctypes binding to the native read filters (native/sketch.cpp
read_filters_batch): trinucleotide complexity and mean read quality.

Complexity (ReadSelection.hpp:869-920,1171-1228): direct trinucleotide
k-mers over the original sequence, windows of 64 stepping 32, window score
sum_t c_t*(c_t-1)/2 / 61, read score the mean over windows (NaN without a
complete window). Mean quality: long-double sum of the error table, then
``-10*log10f(mean)``; NaN for reads without qualities.
"""

import ctypes
import os

import numpy as np

from ..io import native


def _lib() -> ctypes.CDLL:
    lib = native.load_library("libsketch.so")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.read_filters_batch.argtypes = [
        u8p, i64p, u8p, i64p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32]
    lib.read_filters_batch.restype = ctypes.c_int64
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_filters_batch(seqs, quals, w: int, step: int,
                       qual_table: np.ndarray):
    """Returns (complexity f64[n], mean_quality f32[n]) for the reads, on
    every CPU core."""
    lib = _lib()
    n = len(seqs)
    soffs = np.zeros(n + 1, np.int64)
    qoffs = np.zeros(n + 1, np.int64)
    soffs[1:] = np.cumsum([s.shape[0] for s in seqs])
    qoffs[1:] = np.cumsum([q.shape[0] for q in quals])
    seq_cat = np.concatenate(seqs) if n else np.zeros(0, np.uint8)
    qual_cat = np.concatenate(quals) if qoffs[-1] else np.zeros(1, np.uint8)
    out_c = np.zeros(n, np.float64)
    out_q = np.zeros(n, np.float32)
    qt = np.ascontiguousarray(qual_table, np.float32)
    lib.read_filters_batch(
        _ptr(seq_cat, ctypes.c_uint8), _ptr(soffs, ctypes.c_int64),
        _ptr(qual_cat, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        np.int32(n), np.int64(w), np.int64(step),
        _ptr(qt, ctypes.c_float), _ptr(out_c, ctypes.c_double),
        _ptr(out_q, ctypes.c_float), np.int32(os.cpu_count() or 1))
    return out_c, out_q
