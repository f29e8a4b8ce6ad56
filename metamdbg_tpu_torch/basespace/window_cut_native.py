"""ctypes binding to the native batch window-cutting engine
(native/window_cut.cpp).

`window_cut_batch` computes the read-interval cuts at window boundaries for
a batch of read-vs-contig alignments, packed once and run in ranges of
alignments, one engine call per range on `n_threads` Python threads
(utils/threadmap.py). The port of
metamdbg_tpu/basespace/window_cut_native.py, loaded through io/native.py;
there is no Python fallback (the JAX package's oracle,
polisher.find_breaking_points, is not ported)."""

import ctypes

import numpy as np

from ..io import native
from ..utils import threadmap

_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = native.load_library("libwindowcut.so")
        u8pp = ctypes.POINTER(ctypes.c_void_p)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.window_cut_batch.argtypes = [
            u8pp, i64p, u8pp, i64p, i64p, i64p, i64p, i64p, i64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i32p, ctypes.c_int32]
        lib.window_cut_batch.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


_ptr = native.ptr


def window_cut_batch(items, contigs, window_len: int, align_l: int,
                     nw_max_m: int, n_threads: int = 1):
    """items: list of (read_seq uint8 array, alignment) where alignment has
    .anchors (q, t int64 ascending), .contig_index/.contig_start/.contig_end.
    contigs: cid -> uint8 array. Returns per item
    (first_q, last_q, first_t, last_t int64 arrays, n_dropped)."""
    lib = _load()
    n = len(items)
    if n == 0:
        return []

    with threadmap.packing("cut"):
        read_ptrs = np.empty(n, np.uintp)
        contig_ptrs = np.empty(n, np.uintp)
        read_lens = np.empty(n, np.int64)
        contig_lens = np.empty(n, np.int64)
        t_begin = np.empty(n, np.int64)
        t_end = np.empty(n, np.int64)
        anchor_offs = np.zeros(n + 1, np.int64)
        cap_offs = np.zeros(n + 1, np.int64)
        for i, (seq, al) in enumerate(items):
            anchor_offs[i + 1] = anchor_offs[i] + al.anchors[0].shape[0]
            cap_offs[i + 1] = cap_offs[i] + int(al.contig_end) \
                // window_len + 2
        aq = np.empty(int(anchor_offs[-1]), np.int64)
        at = np.empty(int(anchor_offs[-1]), np.int64)
        # keep contiguous copies alive for the duration of the calls
        keep_alive = []
        for i, (seq, al) in enumerate(items):
            seq = np.ascontiguousarray(seq, np.uint8)
            contig = contigs[al.contig_index]
            keep_alive.append(seq)
            read_ptrs[i] = seq.ctypes.data
            contig_ptrs[i] = contig.ctypes.data
            read_lens[i] = seq.shape[0]
            contig_lens[i] = contig.shape[0]
            t_begin[i] = al.contig_start
            t_end[i] = al.contig_end
            a, b = anchor_offs[i], anchor_offs[i + 1]
            aq[a:b] = al.anchors[0]
            at[a:b] = al.anchors[1]

    def cut_range(r):
        # anchor_offs holds absolute offsets into aq/at: a range moves only
        # the per-alignment pointers; its outputs are its own
        lo, hi = r
        cap = int(cap_offs[hi] - cap_offs[lo])
        out_offs = np.zeros(hi - lo + 1, np.int64)
        out_fq = np.empty(cap, np.int64)
        out_lq = np.empty(cap, np.int64)
        out_ft = np.empty(cap, np.int64)
        out_lt = np.empty(cap, np.int64)
        out_dropped = np.zeros(hi - lo, np.int32)
        rc = lib.window_cut_batch(
            _ptr(read_ptrs, ctypes.c_void_p, lo),
            _ptr(read_lens, ctypes.c_int64, lo),
            _ptr(contig_ptrs, ctypes.c_void_p, lo),
            _ptr(contig_lens, ctypes.c_int64, lo), _ptr(aq, ctypes.c_int64),
            _ptr(at, ctypes.c_int64), _ptr(anchor_offs, ctypes.c_int64, lo),
            _ptr(t_begin, ctypes.c_int64, lo),
            _ptr(t_end, ctypes.c_int64, lo), np.int32(hi - lo),
            np.int32(window_len), np.int32(align_l), np.int64(nw_max_m),
            _ptr(out_offs, ctypes.c_int64), _ptr(out_fq, ctypes.c_int64),
            _ptr(out_lq, ctypes.c_int64), _ptr(out_ft, ctypes.c_int64),
            _ptr(out_lt, ctypes.c_int64), _ptr(out_dropped, ctypes.c_int32),
            np.int32(1))
        # validate the exact-capacity contract: a C-side change emitting
        # more fragments than the Python bound would have already
        # overflowed the heap buffers; fail loudly rather than corrupt
        if rc != int(out_offs[-1]) or rc > cap:
            raise RuntimeError(
                f"window_cut_batch emitted {rc} fragments "
                f"(offsets say {int(out_offs[-1])}, capacity {cap})")
        out = []
        for i in range(hi - lo):
            a, b = int(out_offs[i]), int(out_offs[i + 1])
            out.append((out_fq[a:b], out_lq[a:b], out_ft[a:b], out_lt[a:b],
                        int(out_dropped[i])))
        return out

    # the engine's own loop pulled 16 alignments at a time
    out = [cut for part in threadmap.thread_map(
        cut_range, threadmap.ranges(n, n_threads, 16), n_threads)
        for cut in part]
    del keep_alive
    return out
