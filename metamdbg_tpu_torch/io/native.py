"""ctypes bindings to the repo's host C++ libraries (native/).

`native/` sits beside both packages; the port keeps its own bindings to it
and builds its libraries itself, all of them, before the first stage runs
(`build_all`). A library is compiled with the flags of native/Makefile
when it is missing or older than its source, once, under a file lock
(parallel test workers may all ask at once). Where the compiler has no OpenMP runtime (g++ without
libgomp), it is compiled without -fopenmp: every OpenMP use in native/ is
guarded by `#ifdef _OPENMP`, so the library is the same code on one
thread. There is no Python fallback: a library that cannot be built or
loaded raises.
"""

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]
# native/Makefile's recipes: library -> (source, built -fopenmp, link flags)
RECIPES = {
    "libfastio.so": ("fastio.cpp", False, ["-lz"]),
    "libsketch.so": ("sketch.cpp", True, []),
    "libpoa.so": ("poa.cpp", True, []),
    "libpoacorrect.so": ("poa_correct.cpp", True, []),
    "libwindowcut.so": ("window_cut.cpp", True, []),
    "liboverlap.so": ("overlap.cpp", True, []),
}

_LIBS: dict = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")


def openmp_available() -> bool:
    """Whether the compiler can link a shared library with -fopenmp."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    probe = os.path.join(BUILD_DIR, "openmp_probe.so")
    proc = subprocess.run(
        [_cxx(), "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-o", probe,
         "-"], input="int f() { return 0; }\n", capture_output=True,
        text=True)
    return proc.returncode == 0


def compile_library(name: str, out: str, openmp: bool):
    """native/<source> -> `out`, with native/Makefile's flags."""
    source, uses_openmp, libs = RECIPES[name]
    cmd = [_cxx(), *CXXFLAGS, *(["-fopenmp"] if openmp and uses_openmp
                                else []),
           "-shared", "-o", out + ".tmp", os.path.join(NATIVE_DIR, source),
           *libs]
    _run(cmd)
    os.replace(out + ".tmp", out)


def _stale(name: str) -> bool:
    so = os.path.join(NATIVE_DIR, name)
    src = os.path.join(NATIVE_DIR, RECIPES[name][0])
    return not os.path.exists(so) or \
        os.path.getmtime(src) > os.path.getmtime(so)


def build_all():
    """Build every library of native/ that is missing or out of date."""
    if not any(_stale(n) for n in RECIPES):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stale = [n for n in RECIPES if _stale(n)]
        if stale:
            openmp = openmp_available()
            for name in stale:
                compile_library(name, os.path.join(NATIVE_DIR, name), openmp)


def ptr(arr: np.ndarray, ctype, first: int = 0):
    """A ctypes pointer to arr[first]: an engine call on a range of a
    packed batch gets its per-item arrays from the range's first item."""
    return ctypes.cast(arr.ctypes.data + first * arr.itemsize,
                       ctypes.POINTER(ctype))


def load_library(name: str) -> ctypes.CDLL:
    """Load native/<name>, building native/ first where needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(os.path.join(NATIVE_DIR, name))
        _LIBS[name] = lib
    return lib


def _fastio() -> ctypes.CDLL:
    lib = load_library("libfastio.so")
    lib.fastio_open.restype = ctypes.c_void_p
    lib.fastio_open.argtypes = [ctypes.c_char_p]
    lib.fastio_close.argtypes = [ctypes.c_void_p]
    lib.fastio_next_batch.restype = ctypes.c_int64
    lib.fastio_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
    return lib


def iter_read_batches(paths, max_reads: int = 4096,
                      max_bases: int = 64 << 20):
    """Yields (seq_buf u8, qual_buf u8, lengths i64, has_qual u8) flat
    batches across one or more fasta/fastq[.gz] files, decoded natively."""
    lib = _fastio()
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    seq_buf = np.empty(max_bases, np.uint8)
    qual_buf = np.empty(max_bases, np.uint8)
    lengths = np.empty(max_reads, np.int64)
    has_qual = np.empty(max_reads, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for path in paths:
        handle = lib.fastio_open(str(path).encode())
        if not handle:
            raise FileNotFoundError(path)
        try:
            while True:
                n = lib.fastio_next_batch(
                    handle, max_reads, max_bases,
                    seq_buf.ctypes.data_as(u8p), qual_buf.ctypes.data_as(u8p),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    has_qual.ctypes.data_as(u8p))
                if n <= 0:
                    break
                total = int(lengths[:n].sum())
                yield (seq_buf[:total].copy(), qual_buf[:total].copy(),
                       lengths[:n].copy(), has_qual[:n].copy())
        finally:
            lib.fastio_close(handle)
