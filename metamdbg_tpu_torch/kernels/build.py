"""Builds the port's CUDA sources (csrc/) with nvcc and loads them with ctypes.

Each library is a plain C interface compiled for Hopper into
`metamdbg_tpu_torch/_build/`, at first use, under a name keyed by a hash
of its sources, the shared headers (csrc/*.cuh) and the flags, so an
edited source or header is rebuilt and a built one is reused. A file
lock makes concurrent first uses build once. nvcc is found through
$CUDA_HOME, then $PATH, then the toolkit's default prefix.
Nothing is built when a module is imported, and a build that fails raises.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict = {}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def headers() -> list:
    """The shared headers in csrc/ (*.cuh), which any source may include."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def library_path(name: str, sources) -> str:
    """Where lib<name> built from `sources` (file names in csrc/) lives; the
    name's hash covers the headers too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*sources, *headers()]:
        with open(os.path.join(CSRC_DIR, s), "rb") as f:
            h.update(s.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, sources) -> str:
    """Compile lib<name> unless it is already built; returns its path."""
    out = library_path(name, sources)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = out + ".tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               *[os.path.join(CSRC_DIR, s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building lib{name}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>, once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name, sources))
        _LOADED[name] = lib
    return lib
