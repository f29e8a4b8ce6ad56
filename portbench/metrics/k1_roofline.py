"""Kernel K1 (the sketch kernel, `csrc/sketch.cu`): the least time its
launches in the window could take, over the time the device trace shows
them taking, in %.

The least time of a launch on (n, L) tiles is `k1_bound`: the larger of
its bytes at the memory's peak (the codes read once; positions, values,
directions and counts written once) and its operations on the INT32 and
FMA pipes (23 multiply-adds, 8 operations of either pipe and 29 of the
INT32 pipe a window). Its inputs are the counts each launch adds to the
program's span open around it (`sketch/batch.py`); within a span every
launch has the same row length, minimizer size and row capacity, and the
bound is linear in the rows, so a span's launches are bounded together.
The numbers are a copy of `chip_smoke.py`'s, kept here so that the
benchmark keeps its own count: an NVIDIA H100 SXM at 3.35 TB/s, 132 SMs
of 64 INT32 and 64 FMA lanes at 1.98 GHz.
"""

from ._spans import window_records

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
IMAD_OPS_PER_S = 132 * 64 * 1.98e9
K1_OPS = (23, 8, 29)          # a window: multiply-adds, either pipe, INT32
KERNEL = "sketch_tiles_kernel"


def bound(nbytes, int_ops, mul_ops=0, either_ops=0):
    """(seconds, what bounds it): the larger of the bytes' time at the
    memory's rate and the operations' time: the INT32 pipe's for INT32-only
    operations, the FMA pipe's for multiply-adds, both pipes' for all
    integer operations (adds and shifts go to whichever is free)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, mul_ops / IMAD_OPS_PER_S,
                (int_ops + mul_ops + either_ops)
                / (INT32_OPS_PER_S + IMAD_OPS_PER_S))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n, L, l, cap):
    """bound() of K1 on (n, L) tiles of minimizer size l with `cap`
    compacted slots a row."""
    nbytes, nk = n * L + n * cap * (4 + 4 + 1) + n * 4, n * (L - l + 1)
    mul, either, other = (nk * x for x in K1_OPS)
    return bound(nbytes, other, mul_ops=mul, either_ops=either)


def span_bound_s(counts) -> float:
    """The bound of the K1 launches a span counted, in seconds."""
    launches, rows = counts["k1_launches"], counts["k1_rows"]
    L = counts["k1_row_len"] // launches
    l = L + 1 - counts["k1_windows"] // rows
    return k1_bound(rows, L, l, counts["k1_cap"] // launches)[0]


def read(run):
    bound_s = sum(span_bound_s(r.counts) for r in window_records(run)
                  if r.counts.get("k1_rows"))
    device_s = sum(t - s for s, t, name in run.timeline.device
                   if KERNEL in name) / 1e9
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
