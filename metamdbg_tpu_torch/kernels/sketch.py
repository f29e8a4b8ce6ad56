"""Kernel K1: minimizer sketch of packed read tiles, with in-row compaction.

`sketch_tiles` is the wrapper: on a CUDA tensor it launches the hand-written
kernel in csrc/sketch.cu (built by kernels/build.py) or raises; on a CPU
tensor it runs `sketch_tiles_reference`, the plain torch version in this
module. Both compute what the JAX package's tile path computes
(metamdbg_tpu/kernels/sketch.py:sketch_batch_compact_packed with trim=0,
and the Pallas kernel sketch_pallas.py:_sketch_kernel): per row, the
ascending positions of the selected windows with their canonical u32
values and directions, the first `cap` of them, and the true count.

Rows whose count exceeds `cap` (tandem repeats of a selected l-mer) are run
again, on their own, with cap = nk, so every selected window comes back.

`launches` counts kernel launches (overflow relaunches included) and
`overflow_launches` the relaunches alone; the plain version counts nothing.
"""

import ctypes
from typing import NamedTuple

import torch

from ..utils import hashing
from . import build

launches = 0
overflow_launches = 0

_SOURCES = ("sketch.cu",)
_MAX_L = 16


class TileSketch(NamedTuple):
    positions: torch.Tensor    # i32 (n, cap): ascending window starts
    values: torch.Tensor       # u32 (n, cap): canonical l-mer values
    directions: torch.Tensor   # u8 (n, cap): 1 where the reverse was taken
    counts: torch.Tensor       # i32 (n,): selected windows per row
    overflow_rows: torch.Tensor  # i64 (m,): rows with counts > cap
    overflow: tuple            # (positions, values, directions), (m, nk)


def reset_counts():
    global launches, overflow_launches
    launches = 0
    overflow_launches = 0


def compact_cap(nk: int, density: float) -> int:
    """Per-row capacity: ~2.5x the expected selection count, rounded up to
    a multiple of 128 (metamdbg_tpu/kernels/sketch.py:compact_cap)."""
    cap = int(nk * density * 2.5) + 32
    cap = (cap + 127) // 128 * 128
    return min(nk, cap)


def sketch_tiles_reference(codes: torch.Tensor, l: int, density: float,
                           cap: int):
    """Plain torch version. codes: u8 (n, L). Returns (positions i32,
    values u32, directions u8, counts i32); past a row's count the columns
    hold what the JAX stable sort leaves there (position nk, the values of
    unselected windows)."""
    n, L = codes.shape
    nk = L - l + 1
    c = codes.to(torch.int64)
    bad = c >= 4
    base = torch.where(bad, 0, c)
    comp = base ^ 2
    fwd = torch.zeros((n, nk), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    invalid = torch.zeros((n, nk), dtype=torch.bool, device=codes.device)
    for j in range(l):
        fwd |= base[:, j:j + nk] << (2 * (l - 1 - j))
        rev |= comp[:, j:j + nk] << (2 * j)
        invalid |= bad[:, j:j + nk]
    choice_rev = ~(fwd < rev)                      # ties -> reverse
    values = torch.where(choice_rev, rev, fwd)
    selected = hashing.minimizer_is_selected(values, density) & ~invalid

    pos = torch.arange(nk, dtype=torch.int64, device=codes.device)
    key = torch.where(selected, pos, nk)
    key_s, order = torch.sort(key, dim=1, stable=True)
    order = order[:, :cap]
    return (key_s[:, :cap].to(torch.int32),
            values.gather(1, order).to(torch.uint32),
            choice_rev.gather(1, order).to(torch.uint8),
            selected.sum(dim=1, dtype=torch.int32))


def _lib() -> ctypes.CDLL:
    return _bind(build.load("sketch", _SOURCES))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares sketch.cu's C interface on a loaded library."""
    vp = ctypes.c_void_p
    lib.sketch_tiles_launch.argtypes = [
        vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, vp]
    lib.sketch_tiles_launch.restype = ctypes.c_int
    lib.sketch_error_string.argtypes = [ctypes.c_int]
    lib.sketch_error_string.restype = ctypes.c_char_p
    return lib


def _enqueue(codes: torch.Tensor, l: int, density: float, cap: int, out):
    """Launches the kernel into `out` = (positions, values, dirs, counts),
    allocated by the caller. Does not wait for the card."""
    global launches
    lib = _lib()
    n, L = codes.shape
    dev = codes.device
    t = hashing._exact_u64_threshold(density)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sketch_tiles_launch(
            codes.data_ptr(), n, L, l, min(t, (1 << 64) - 1),
            int(t >= 1 << 64), cap, *(x.data_ptr() for x in out), stream)
    if err != 0:
        raise RuntimeError("sketch kernel launch failed: "
                           + lib.sketch_error_string(err).decode())
    launches += 1


def _launch(codes: torch.Tensor, l: int, density: float, cap: int):
    n = codes.shape[0]
    dev = codes.device
    out = (torch.empty((n, cap), dtype=torch.int32, device=dev),
           torch.empty((n, cap), dtype=torch.uint32, device=dev),
           torch.empty((n, cap), dtype=torch.uint8, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev))
    _enqueue(codes, l, density, cap, out)
    return out


def sketch_tiles(codes: torch.Tensor, l: int, density: float,
                 cap: int) -> TileSketch:
    """Sketch a batch of u8 tiles (n, L), on the tensor's device."""
    global overflow_launches
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be a 2-d uint8 tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    nk = codes.shape[1] - l + 1
    if not 1 <= l <= _MAX_L or nk < 1 or not 1 <= cap <= nk:
        raise ValueError(f"bad sketch shape: l={l} L={codes.shape[1]} "
                         f"cap={cap}")
    if codes.device.type == "cuda":
        run = _launch
    elif codes.device.type == "cpu":
        run = sketch_tiles_reference
    else:
        raise ValueError(f"no sketch kernel for device {codes.device}")
    positions, values, dirs, counts = run(codes, l, density, cap)
    over = torch.nonzero(counts > cap).flatten()
    if over.numel():
        sub = codes.index_select(0, over).contiguous()
        if run is _launch:
            overflow_launches += 1
        full = run(sub, l, density, nk)[:3]
    else:
        full = tuple(x[:0] for x in (positions, values, dirs))
    return TileSketch(positions, values, dirs, counts, over, full)
