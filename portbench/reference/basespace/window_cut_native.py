"""ctypes binding to the native batch window-cutting engine
(native/window_cut.cpp).

One call computes the read-interval cuts at window boundaries for a batch
of read-vs-contig alignments (OpenMP across alignments) — the hot inner
machinery of basespace/polisher.find_breaking_points, which remains the
pure-Python oracle (bit-identical, tests/test_window_cut.py)."""

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
    if os.environ.get("METAMDBG_TPU_HOST_WINDOW_CUT"):
        return None
    so = os.path.join(_NATIVE_DIR, "libwindowcut.so")
    src = os.path.join(_NATIVE_DIR, "window_cut.cpp")
    if not os.path.exists(so) or (os.path.exists(src) and
                                  os.path.getmtime(src) > os.path.getmtime(so)):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libwindowcut.so"],
                           check=True, capture_output=True)
        except Exception as e:  # pragma: no cover - toolchain always present
            log.warning("native window_cut build failed: %s", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:  # pragma: no cover
        log.warning("native window_cut load failed: %s", e)
        return None
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


def available() -> bool:
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def window_cut_batch(items, contigs, window_len: int, align_l: int,
                     nw_max_m: int, n_threads: int | None = None):
    """items: list of (read_seq uint8 array, alignment) where alignment has
    .anchors (q, t int64 ascending), .contig_index/.contig_start/.contig_end.
    contigs: cid -> uint8 array. Returns per item
    (first_q, last_q, first_t, last_t int64 arrays, n_dropped) or None when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n = len(items)
    if n == 0:
        return []

    read_ptrs = (ctypes.c_void_p * n)()
    contig_ptrs = (ctypes.c_void_p * n)()
    read_lens = np.empty(n, np.int64)
    contig_lens = np.empty(n, np.int64)
    t_begin = np.empty(n, np.int64)
    t_end = np.empty(n, np.int64)
    anchor_offs = np.zeros(n + 1, np.int64)
    cap = 0
    for i, (seq, al) in enumerate(items):
        anchor_offs[i + 1] = anchor_offs[i] + al.anchors[0].shape[0]
        cap += int(al.contig_end) // window_len + 2
    aq = np.empty(int(anchor_offs[-1]), np.int64)
    at = np.empty(int(anchor_offs[-1]), np.int64)
    # keep contiguous copies alive for the duration of the call
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

    out_offs = np.zeros(n + 1, np.int64)
    out_fq = np.empty(cap, np.int64)
    out_lq = np.empty(cap, np.int64)
    out_ft = np.empty(cap, np.int64)
    out_lt = np.empty(cap, np.int64)
    out_dropped = np.zeros(n, np.int32)
    rc = lib.window_cut_batch(
        read_ptrs, _ptr(read_lens, ctypes.c_int64), contig_ptrs,
        _ptr(contig_lens, ctypes.c_int64), _ptr(aq, ctypes.c_int64),
        _ptr(at, ctypes.c_int64), _ptr(anchor_offs, ctypes.c_int64),
        _ptr(t_begin, ctypes.c_int64), _ptr(t_end, ctypes.c_int64),
        np.int32(n), np.int32(window_len), np.int32(align_l),
        np.int64(nw_max_m), _ptr(out_offs, ctypes.c_int64),
        _ptr(out_fq, ctypes.c_int64), _ptr(out_lq, ctypes.c_int64),
        _ptr(out_ft, ctypes.c_int64), _ptr(out_lt, ctypes.c_int64),
        _ptr(out_dropped, ctypes.c_int32), np.int32(n_threads))
    # validate the exact-capacity contract (ADVICE r4): a C-side change
    # emitting more fragments than the Python bound would have already
    # overflowed the heap buffers — fail loudly rather than corrupt
    if rc != int(out_offs[-1]) or rc > cap:
        raise RuntimeError(
            f"window_cut_batch emitted {rc} fragments "
            f"(offsets say {int(out_offs[-1])}, capacity {cap})")
    del keep_alive
    out = []
    for i in range(n):
        a, b = int(out_offs[i]), int(out_offs[i + 1])
        out.append((out_fq[a:b], out_lq[a:b], out_ft[a:b], out_lt[a:b],
                    int(out_dropped[i])))
    return out
