"""ctypes bindings to the native host-IO library (native/fastio.cpp).

Builds on demand with make (g++ + zlib, both baked into the image) and
falls back to the pure-Python parser transparently when the toolchain is
unavailable. Exposes batch decoding into flat numpy buffers — the host side
of the device input pipeline.
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
    so = os.path.join(_NATIVE_DIR, "libfastio.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except Exception as exc:  # toolchain missing: fall back to python
            log.debug("native fastio unavailable: %s", exc)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.fastio_open.restype = ctypes.c_void_p
    lib.fastio_open.argtypes = [ctypes.c_char_p]
    lib.fastio_close.argtypes = [ctypes.c_void_p]
    lib.fastio_next_batch.restype = ctypes.c_int64
    lib.fastio_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def iter_read_batches(paths, max_reads: int = 4096,
                      max_bases: int = 64 << 20):
    """Yields (seq_buf u8, qual_buf u8, lengths i64, has_qual u8) flat
    batches across one or more fasta/fastq[.gz] files, decoded natively."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastio library not available")
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    seq_buf = np.empty(max_bases, np.uint8)
    qual_buf = np.empty(max_bases, np.uint8)
    lengths = np.empty(max_reads, np.int64)
    has_qual = np.empty(max_reads, np.uint8)
    for path in paths:
        handle = lib.fastio_open(str(path).encode())
        if not handle:
            raise FileNotFoundError(path)
        try:
            while True:
                n = lib.fastio_next_batch(
                    handle, max_reads, max_bases,
                    seq_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    qual_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    has_qual.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                if n <= 0:
                    break
                total = int(lengths[:n].sum())
                yield (seq_buf[:total].copy(), qual_buf[:total].copy(),
                       lengths[:n].copy(), has_qual[:n].copy())
        finally:
            lib.fastio_close(handle)
