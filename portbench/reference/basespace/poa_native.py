"""ctypes binding to the native POA window-consensus engine (native/poa.cpp).

One call polishes a batch of windows (OpenMP across windows), playing the
role of ContigPolisher's spoa loop (src/toBasespace/ContigPolisher.hpp:
2135-2250,2587-2704). Sequences are ascii bytes; the engine only compares
codes for equality so no encoding is needed.
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
    so = os.path.join(_NATIVE_DIR, "libpoa.so")
    src = os.path.join(_NATIVE_DIR, "poa.cpp")
    if not os.path.exists(so) or (os.path.exists(src) and
                                  os.path.getmtime(src) > os.path.getmtime(so)):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libpoa.so"],
                           check=True, capture_output=True)
        except Exception as e:  # pragma: no cover - toolchain always present
            log.warning("native POA build failed: %s", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:  # pragma: no cover
        log.warning("native POA load failed: %s", e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.poa_polish_windows.argtypes = [
        ctypes.c_int32, u8p, i64p, i32p, i64p, u8p, i64p, u8p, u8p,
        i32p, i32p, u8p, i64p, i32p, u32p, ctypes.c_int32]
    lib.poa_polish_windows.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def polish_windows(windows, n_threads: int | None = None):
    """windows: list of (backbone bytes, fragments) where fragments is a list
    of (seq bytes, qual bytes|None, pos_start int, pos_end int) ALREADY in
    spoa insertion order (sorted by (posStart, hash),
    ContigPolisher.hpp:2489-2494). Windows with < 2 fragments must be
    handled by the caller (the engine is still correct for them, but the
    reference short-circuits to the backbone, hpp:2475-2485).

    Returns a list of (consensus bytes, coverages uint32 array).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native POA engine unavailable (g++ build failed); "
            "the polisher requires native/libpoa.so")
    if n_threads is None:
        n_threads = os.cpu_count() or 1

    n = len(windows)
    backbones = b"".join(w[0] for w in windows)
    backbone_offs = np.zeros(n + 1, np.int64)
    frag_counts = np.zeros(n, np.int32)
    window_frag_start = np.zeros(n, np.int64)
    frag_chunks = []
    qual_chunks = []
    has_qual = []
    pos_start = []
    pos_end = []
    out_offs = np.zeros(n + 1, np.int64)
    total_frag = 0
    for i, (bb, frags) in enumerate(windows):
        backbone_offs[i + 1] = backbone_offs[i] + len(bb)
        frag_counts[i] = len(frags)
        window_frag_start[i] = total_frag
        total_frag += len(frags)
        max_out = 2 * len(bb) + 64
        for (seq, qual, ps, pe) in frags:
            frag_chunks.append(seq)
            qual_chunks.append(qual if qual is not None else b"\x00" * len(seq))
            has_qual.append(1 if qual is not None else 0)
            ps = max(0, min(int(ps), len(bb) - 1))
            pe = max(ps, min(int(pe), len(bb) - 1))
            pos_start.append(ps)
            pos_end.append(pe)
            max_out += len(seq)  # worst-case growth bound
        out_offs[i + 1] = out_offs[i] + max_out

    frag_offs = np.zeros(total_frag + 1, np.int64)
    for j, s in enumerate(frag_chunks):
        frag_offs[j + 1] = frag_offs[j] + len(s)
    frags_buf = np.frombuffer(b"".join(frag_chunks), np.uint8) \
        if frag_chunks else np.zeros(0, np.uint8)
    quals_buf = np.frombuffer(b"".join(qual_chunks), np.uint8) \
        if qual_chunks else np.zeros(0, np.uint8)
    backbones_buf = np.frombuffer(backbones, np.uint8) if backbones \
        else np.zeros(0, np.uint8)

    has_qual = np.asarray(has_qual, np.uint8) if has_qual \
        else np.zeros(0, np.uint8)
    pos_start = np.asarray(pos_start, np.int32) if pos_start \
        else np.zeros(0, np.int32)
    pos_end = np.asarray(pos_end, np.int32) if pos_end \
        else np.zeros(0, np.int32)

    out_seq = np.zeros(int(out_offs[-1]), np.uint8)
    out_cov = np.zeros(int(out_offs[-1]), np.uint32)
    out_len = np.zeros(n, np.int32)

    # window_frag_start indexes into frag-level arrays; frag_offs passed with
    # per-window base so the engine sees local offsets
    lib.poa_polish_windows(
        n, _ptr(backbones_buf, ctypes.c_uint8),
        _ptr(backbone_offs, ctypes.c_int64),
        _ptr(frag_counts, ctypes.c_int32),
        _ptr(window_frag_start, ctypes.c_int64),
        _ptr(frags_buf, ctypes.c_uint8), _ptr(frag_offs, ctypes.c_int64),
        _ptr(quals_buf, ctypes.c_uint8), _ptr(has_qual, ctypes.c_uint8),
        _ptr(pos_start, ctypes.c_int32), _ptr(pos_end, ctypes.c_int32),
        _ptr(out_seq, ctypes.c_uint8), _ptr(out_offs, ctypes.c_int64),
        _ptr(out_len, ctypes.c_int32), _ptr(out_cov, ctypes.c_uint32),
        int(n_threads))

    out = []
    for i in range(n):
        a, ln = int(out_offs[i]), int(out_len[i])
        out.append((out_seq[a:a + ln].tobytes(), out_cov[a:a + ln].copy()))
    return out
