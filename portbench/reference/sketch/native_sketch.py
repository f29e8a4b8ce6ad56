"""ctypes binding to the native host batch sketcher (native/sketch.cpp).

The host path for minimizer selection, bit-identical to the numpy
version (sketch/minimizers.py).
"""

import ctypes
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger("portbench.reference")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                           "native")
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("METAMDBG_TPU_NO_NATIVE_SKETCH"):
        return None
    so = os.path.join(_NATIVE_DIR, "libsketch.so")
    src = os.path.join(_NATIVE_DIR, "sketch.cpp")
    if not os.path.exists(so) or (os.path.exists(src) and
                                  os.path.getmtime(src) > os.path.getmtime(so)):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libsketch.so"],
                           check=True, capture_output=True)
        except Exception as e:  # pragma: no cover - toolchain always present
            log.warning("native sketch build failed: %s", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:  # pragma: no cover
        log.warning("native sketch load failed: %s", e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sketch_reads.argtypes = [
        u8p, i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        u32p, ctypes.c_int64, ctypes.c_int32,
        u32p, u32p, u8p, i64p, ctypes.c_int64, ctypes.c_int32]
    lib.sketch_reads.restype = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.chain_batch.argtypes = [
        i64p, i64p, i64p, u8p, i64p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
        f32p, i32p, i32p, ctypes.c_int32]
    lib.chain_batch.restype = ctypes.c_int64
    lib.chain_corr_batch.argtypes = [
        i64p, i64p, u8p, i64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
        f32p, i32p, i32p, ctypes.c_int32]
    lib.chain_corr_batch.restype = ctypes.c_int64
    lib.chain_mapper_batch.argtypes = [
        i64p, i64p, u8p, i64p, i64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
        i32p, i64p, u32p, ctypes.c_int32]
    lib.chain_mapper_batch.restype = ctypes.c_int64
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.read_filters_batch.argtypes = [
        u8p, i64p, u8p, i64p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, f32p, f64p, f32p, ctypes.c_int32]
    lib.read_filters_batch.restype = ctypes.c_int64
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.window_hash_batch.argtypes = [
        u32p, i64p, ctypes.c_int64, ctypes.c_int32, u64p, u64p,
        ctypes.c_int32]
    lib.window_hash_batch.restype = ctypes.c_int64
    lib.row_hash_batch.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int32, u64p, u64p, ctypes.c_int32]
    lib.row_hash_batch.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def row_hash_batch(rows: np.ndarray, n_threads: int | None = None):
    """Plain murmur128 of (N, w) u32 rows, seed 0 (native/sketch.cpp
    row_hash_batch; utils/hashing.murmur128_u32rows is the oracle).
    Returns (h1 u64, h2 u64) or None."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.uint32)
    n, w = rows.shape
    if n_threads is None:
        n_threads = 1 if n < 65536 else (os.cpu_count() or 1)
    h1 = np.empty(n, np.uint64)
    h2 = np.empty(n, np.uint64)
    lib.row_hash_batch(
        _ptr(rows, ctypes.c_uint32), np.int64(n), np.int32(w),
        _ptr(h1, ctypes.c_uint64), _ptr(h2, ctypes.c_uint64),
        np.int32(n_threads))
    return h1, h2


def window_hash_batch(cat: np.ndarray, starts: np.ndarray, w: int,
                      n_threads: int | None = None):
    """hash128 of the normalized w-window at each start of the flat u32
    stream (native/sketch.cpp window_hash_batch — fused KmerVec::normalize
    + MurmurHash3_x64_128_original; utils/hashing.murmur128_u32rows over
    normalize_rows is the oracle). Returns (h1 u64, h2 u64) or None."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    cat = np.ascontiguousarray(cat, np.uint32)
    starts = np.ascontiguousarray(starts, np.int64)
    n = starts.shape[0]
    h1 = np.empty(n, np.uint64)
    h2 = np.empty(n, np.uint64)
    lib.window_hash_batch(
        _ptr(cat, ctypes.c_uint32), _ptr(starts, ctypes.c_int64),
        np.int64(n), np.int32(w), _ptr(h1, ctypes.c_uint64),
        _ptr(h2, ctypes.c_uint64), np.int32(n_threads))
    return h1, h2


def read_filters_batch(seqs, quals, w: int, step: int,
                       qual_table: np.ndarray, n_threads: int | None = None):
    """Batched complexity + mean-quality filters (native/sketch.cpp
    read_filters_batch; sketch/filters.py is the oracle). Returns
    (complexity f64[n], mean_quality f32[n]) or None when unavailable.
    Empty quality arrays yield NaN mean quality like the Python path."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n = len(seqs)
    soffs = np.zeros(n + 1, np.int64)
    qoffs = np.zeros(n + 1, np.int64)
    for i in range(n):
        soffs[i + 1] = soffs[i] + seqs[i].shape[0]
        q = quals[i]
        qoffs[i + 1] = qoffs[i] + (q.shape[0] if q is not None else 0)
    seq_cat = np.empty(int(soffs[-1]), np.uint8)
    qual_cat = np.empty(int(qoffs[-1]), np.uint8)
    for i in range(n):
        seq_cat[soffs[i]:soffs[i + 1]] = seqs[i]
        q = quals[i]
        if q is not None and q.shape[0]:
            qual_cat[qoffs[i]:qoffs[i + 1]] = q
    if qual_cat.shape[0] == 0:
        qual_cat = np.zeros(1, np.uint8)
    out_c = np.zeros(n, np.float64)
    out_q = np.zeros(n, np.float32)
    qt = np.ascontiguousarray(qual_table, np.float32)
    lib.read_filters_batch(
        _ptr(seq_cat, ctypes.c_uint8), _ptr(soffs, ctypes.c_int64),
        _ptr(qual_cat, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        np.int32(n), np.int64(w), np.int64(step),
        _ptr(qt, ctypes.c_float), _ptr(out_c, ctypes.c_double),
        _ptr(out_q, ctypes.c_float), np.int32(n_threads))
    return out_c, out_q


def chain_corr_single(ref_pos, q_pos, is_rev, band: int, w: float,
                      max_dist: int, max_gap: int):
    """One correction-chainer DP group (native/sketch.cpp chain_corr_batch,
    MinimizerChainer semantics — see correction/chainer.chain_dp, whose
    numpy implementation remains the oracle). Returns
    (scores f32, parents i64, best_index) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = ref_pos.shape[0]
    offsets = np.array([0, n], np.int64)
    rp = np.ascontiguousarray(ref_pos, np.int64)
    qp = np.ascontiguousarray(q_pos, np.int64)
    rv = np.ascontiguousarray(is_rev, np.uint8)
    scores = np.zeros(n, np.float32)
    parents = np.zeros(n, np.int32)
    best_idx = np.zeros(1, np.int32)
    lib.chain_corr_batch(
        _ptr(rp, ctypes.c_int64), _ptr(qp, ctypes.c_int64),
        _ptr(rv, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        np.int32(1), np.int32(band), ctypes.c_float(w),
        np.int64(max_dist), np.int64(max_gap),
        _ptr(scores, ctypes.c_float), _ptr(parents, ctypes.c_int32),
        _ptr(best_idx, ctypes.c_int32), np.int32(1))
    return scores, parents.astype(np.int64), int(best_idx[0])


_I32_MIN = -2147483648


def chain_mapper_batch(ref_pos, q_pos, is_rev, q_idx, offsets, band: int,
                       w: float, max_dist: int, max_gap: int,
                       n_threads: int | None = None):
    """Batched mapper chaining: DP + backtrack + ascending match-position
    extraction for many anchor groups in one call (native/sketch.cpp
    chain_mapper_batch; correction/mapper.chain_read_pair is the oracle).
    Arrays are the concatenated groups, offsets[n_groups+1] delimits.
    Returns (scores i32 with INT32_MIN for groups without a >=3-anchor
    chain, pos_offsets i64[n_groups+1], positions u32) or None."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n_groups = offsets.shape[0] - 1
    rp = np.ascontiguousarray(ref_pos, np.int64)
    qp = np.ascontiguousarray(q_pos, np.int64)
    rv = np.ascontiguousarray(is_rev, np.uint8)
    qi = np.ascontiguousarray(q_idx, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    scores = np.empty(n_groups, np.int32)
    pos_offsets = np.zeros(n_groups + 1, np.int64)
    positions = np.empty(int(offs[-1]), np.uint32)
    lib.chain_mapper_batch(
        _ptr(rp, ctypes.c_int64), _ptr(qp, ctypes.c_int64),
        _ptr(rv, ctypes.c_uint8), _ptr(qi, ctypes.c_int64),
        _ptr(offs, ctypes.c_int64), np.int32(n_groups), np.int32(band),
        ctypes.c_float(w), np.int64(max_dist), np.int64(max_gap),
        _ptr(scores, ctypes.c_int32), _ptr(pos_offsets, ctypes.c_int64),
        _ptr(positions, ctypes.c_uint32), np.int32(n_threads))
    return scores, pos_offsets, positions


def chain_batch_native(groups, avg_dist: float, band: int, w: float,
                       max_gap: int, max_span_bp: int,
                       n_threads: int | None = None):
    """Batch anchor-chaining DP (native/sketch.cpp chain_batch).

    groups: list of (ref_pos i64, q_pos i64, q_bp i64, is_rev bool) arrays.
    Returns (best_idx i32[n_groups], [parents i32 per group]) or None when
    the library is unavailable. Bit-identical to
    basespace/contig_mapper._chain (tests/test_basespace.py).
    """
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n = len(groups)
    offsets = np.zeros(n + 1, np.int64)
    for i, (rp, _, _, _) in enumerate(groups):
        offsets[i + 1] = offsets[i] + rp.shape[0]
    total = int(offsets[-1])
    ref_pos = np.empty(total, np.int64)
    q_pos = np.empty(total, np.int64)
    q_bp = np.empty(total, np.int64)
    is_rev = np.empty(total, np.uint8)
    for i, (rp, qp, qb, rv) in enumerate(groups):
        a, b = offsets[i], offsets[i + 1]
        ref_pos[a:b] = rp
        q_pos[a:b] = qp
        q_bp[a:b] = qb
        is_rev[a:b] = rv
    best_scores = np.zeros(n, np.float32)
    best_idx = np.zeros(n, np.int32)
    parents = np.zeros(total, np.int32)
    lib.chain_batch(
        _ptr(ref_pos, ctypes.c_int64), _ptr(q_pos, ctypes.c_int64),
        _ptr(q_bp, ctypes.c_int64), _ptr(is_rev, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64), np.int32(n),
        ctypes.c_double(avg_dist), np.int32(band), ctypes.c_float(w),
        np.int64(max_gap), np.int64(max_span_bp),
        _ptr(best_scores, ctypes.c_float), _ptr(best_idx, ctypes.c_int32),
        _ptr(parents, ctypes.c_int32), np.int32(n_threads))
    return best_idx, [parents[offsets[i]:offsets[i + 1]] for i in range(n)]


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def sketch_batch_native(codes_list, bad_list, l: int, density: float,
                        repetitive: np.ndarray | None = None, trim: int = 1,
                        n_threads: int | None = None):
    """Sketch many reads; returns [(minimizers u32, positions u32,
    directions u8)] in input order, or None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n = len(codes_list)
    offsets = np.zeros(n + 1, np.int64)
    for i, c in enumerate(codes_list):
        offsets[i + 1] = offsets[i] + c.shape[0]
    total_bases = int(offsets[-1])
    cat = np.empty(total_bases, np.uint8)
    for i, c in enumerate(codes_list):
        seg = cat[offsets[i]:offsets[i + 1]]
        np.copyto(seg, c)
        b = bad_list[i]
        if b is not None and b.any():
            seg[b] = 4

    # double(float(density)) * double(2^64-1) (Kmer.hpp:1352,1421)
    bound = float(np.float64(np.float32(density))
                  * np.float64(np.uint64(0xFFFFFFFFFFFFFFFF)))
    if repetitive is not None and repetitive.size:
        rep = np.ascontiguousarray(repetitive, np.uint32)
        rep_ptr = _ptr(rep, ctypes.c_uint32)
        n_rep = rep.shape[0]
    else:
        rep_ptr = ctypes.POINTER(ctypes.c_uint32)()
        n_rep = 0

    cap = int(total_bases * max(density, 1e-9) * 4) + 1024
    while True:
        out_vals = np.empty(cap, np.uint32)
        out_pos = np.empty(cap, np.uint32)
        out_dirs = np.empty(cap, np.uint8)
        out_offs = np.zeros(n + 1, np.int64)
        r = lib.sketch_reads(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            np.int32(n), np.int32(l), ctypes.c_double(bound), rep_ptr,
            np.int64(n_rep), np.int32(trim),
            _ptr(out_vals, ctypes.c_uint32), _ptr(out_pos, ctypes.c_uint32),
            _ptr(out_dirs, ctypes.c_uint8), _ptr(out_offs, ctypes.c_int64),
            np.int64(cap), np.int32(n_threads))
        if r >= 0:
            break
        cap = int(-r)

    out = []
    for i in range(n):
        a, b = out_offs[i], out_offs[i + 1]
        out.append((out_vals[a:b].copy(), out_pos[a:b].copy(),
                    out_dirs[a:b].copy()))
    return out
