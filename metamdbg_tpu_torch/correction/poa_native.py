"""ctypes binding to the native batch read-correction engine
(native/poa_correct.cpp).

Per read: anchor chaining against its aligned reads, minimizer-POA
consensus and overlap trim. `correct_reads_batch` packs the work once and
runs it in ranges of reads, one engine call per range on `n_threads`
Python threads (utils/threadmap.py). The port of
metamdbg_tpu/correction/poa_native.py, loaded through io/native.py; there
is no Python fallback: a library that cannot be built or loaded raises.
"""

import ctypes

import numpy as np

from ..io import native
from ..kernels.chain_dp import CHAIN_MAX_DIST, CHAIN_MAX_GAP, CHAIN_W
from ..utils import threadmap
from .mapper import MIN_READ_MINIMIZERS

_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = native.load_library("libpoacorrect.so")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.correct_reads_batch.argtypes = [
            u32p, u32p, u8p, u8p, i64p, i64p, ctypes.c_int32,
            i32p, ctypes.c_int32, u32p, i64p,
            ctypes.c_double, ctypes.c_int32, ctypes.c_float, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
            u32p, i64p, ctypes.c_int64, ctypes.c_int32]
        lib.correct_reads_batch.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


class ReadSetBuffers:
    """Concatenated high-density read set, built once and reused across
    partitions."""

    def __init__(self, high_reads):
        n = len(high_reads)
        counts = np.fromiter((r.minimizers.shape[0] for r in high_reads),
                             np.int64, n)
        self.read_offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=self.read_offs[1:])
        total = int(self.read_offs[-1])
        self.mins = np.empty(total, np.uint32)
        self.pos = np.empty(total, np.uint32)
        self.dirs = np.empty(total, np.uint8)
        self.quals = np.empty(total, np.uint8)
        self.read_lens = np.fromiter((r.read_length for r in high_reads),
                                     np.int64, n)
        for i, r in enumerate(high_reads):
            a, b = self.read_offs[i], self.read_offs[i + 1]
            self.mins[a:b] = r.minimizers
            self.pos[a:b] = r.positions
            self.dirs[a:b] = r.directions
            self.quals[a:b] = r.qualities
        self.n_reads = n


_ptr = native.ptr


def correct_reads_batch(buffers: ReadSetBuffers, work, align_lists, params,
                        min_identity: float, min_overlap_length: int,
                        band: int, n_threads: int):
    """Run the native engine over `work` (read indexes); returns a list of
    corrected-minimizer arrays in work order."""
    lib = _load()
    n_work = len(work)
    work_arr = np.asarray(work, np.int32)
    with threadmap.packing("correction"):
        acounts = np.fromiter((len(align_lists[ri]) for ri in work),
                              np.int64, n_work)
        aligned_offs = np.zeros(n_work + 1, np.int64)
        np.cumsum(acounts, out=aligned_offs[1:])
        aligned_cat = np.empty(int(aligned_offs[-1]), np.uint32)
        for i, ri in enumerate(work):
            aligned_cat[aligned_offs[i]:aligned_offs[i + 1]] = align_lists[ri]

    # double(float(density)) * double(2^64-1) (Kmer.hpp:1421,1434)
    density_bound = float(np.float64(np.float32(params.density_assembly))
                          * np.float64(np.uint64(0xFFFFFFFFFFFFFFFF)))
    read_mins = (buffers.read_offs[work_arr + 1]
                 - buffers.read_offs[work_arr]).astype(np.int64)

    def correct_range(r):
        # aligned_offs holds absolute offsets into aligned_cat: a range
        # moves only the per-read pointers; its outputs are its own
        lo, hi = r
        cap = int(read_mins[lo:hi].sum()) * 2 + 1024
        for _attempt in range(2):
            out_mins = np.empty(cap, np.uint32)
            out_offs = np.zeros(hi - lo + 1, np.int64)
            rc = lib.correct_reads_batch(
                _ptr(buffers.mins, ctypes.c_uint32),
                _ptr(buffers.pos, ctypes.c_uint32),
                _ptr(buffers.dirs, ctypes.c_uint8),
                _ptr(buffers.quals, ctypes.c_uint8),
                _ptr(buffers.read_offs, ctypes.c_int64),
                _ptr(buffers.read_lens, ctypes.c_int64),
                ctypes.c_int32(buffers.n_reads),
                _ptr(work_arr, ctypes.c_int32, lo), ctypes.c_int32(hi - lo),
                _ptr(aligned_cat, ctypes.c_uint32),
                _ptr(aligned_offs, ctypes.c_int64, lo),
                ctypes.c_double(density_bound),
                ctypes.c_int32(MIN_READ_MINIMIZERS),
                ctypes.c_float(np.float32(min_identity)),
                ctypes.c_int64(min_overlap_length),
                ctypes.c_int32(band), ctypes.c_int32(params.minimizer_size),
                ctypes.c_float(CHAIN_W), ctypes.c_int64(CHAIN_MAX_DIST),
                ctypes.c_int64(CHAIN_MAX_GAP),
                _ptr(out_mins, ctypes.c_uint32),
                _ptr(out_offs, ctypes.c_int64), ctypes.c_int64(cap),
                ctypes.c_int32(1))
            if rc >= 0:
                return [out_mins[out_offs[i]:out_offs[i + 1]].copy()
                        for i in range(hi - lo)]
            cap = -rc
        raise RuntimeError("correct_reads_batch capacity retry failed")

    # the engine's own loop pulled 4 reads at a time (schedule(dynamic, 4))
    return [m for part in threadmap.thread_map(
        correct_range, threadmap.ranges(n_work, n_threads, 4), n_threads)
        for m in part]
