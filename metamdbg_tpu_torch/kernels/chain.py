"""Kernel K3: the read-vs-contig chain DP over ragged anchor groups.

`chain_contig` is the wrapper: on CUDA tensors it launches the hand-written
kernel in csrc/chain_contig.cu (built by kernels/build.py) or raises; on CPU
tensors it runs `chain_contig_reference`, the plain torch version in this
module. Both compute what the JAX package's XLA scan
metamdbg_tpu/kernels/chain_jax.py:_chainer_contig computes over padded
groups, and the host DP basespace/contig_mapper.py:_chain over one group:
the banded chain DP of ReadVsContigMapper (band 10, anchor weight 20, gap
cap 100, base-space spacing cap 5000, minimizer-space span cap d_r_max).

Groups are ragged: flat anchor arrays (ref_pos, q_pos, q_bp int32, is_rev
bool) sorted by (ref, query) inside each group, and int64 `offsets` of
length n_groups + 1. Outputs: scores (f32), parents (int32, group-local,
-1 for a chain start) per anchor, and best_index (int32) per group, the
first anchor with the maximum score if it is > 0, else -1.

`launches` counts kernel launches; the plain version counts nothing.
"""

import ctypes

import numpy as np
import torch

from . import build

launches = 0

_SOURCES = ("chain_contig.cu",)
BAND = 10           # the kernel's band is a compile-time constant
W = 20.0            # anchor weight
MAX_GAP = 100
BP_CAP = 5000


def reset_counts():
    global launches
    launches = 0


def _bucket_groups(lengths: np.ndarray):
    """Group indexes by the bit length of their anchor count, so that one
    long group does not pad every other: [(group indexes, max length)]."""
    keys = np.zeros(lengths.shape[0], np.int64)
    nz = lengths > 0
    keys[nz] = np.floor(np.log2(lengths[nz])).astype(np.int64) + 1
    out = []
    for key in np.unique(keys):
        idx = np.flatnonzero(keys == key)
        out.append((idx, int(lengths[idx].max())))
    return out


def chain_contig_reference(ref_pos, q_pos, q_bp, is_rev, offsets,
                           d_r_max: int):
    """Plain torch version: groups bucketed by length, padded to the
    bucket's longest group, and stepped anchor by anchor over the whole
    bucket at once, as the JAX scan steps its padded groups."""
    dev = ref_pos.device
    n = ref_pos.shape[0]
    n_groups = offsets.shape[0] - 1
    scores = torch.zeros(n, dtype=torch.float32, device=dev)
    parents = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_index = torch.full((n_groups,), -1, dtype=torch.int32, device=dev)
    offs = offsets.cpu().numpy()
    w = torch.tensor(W, dtype=torch.float32, device=dev)
    neg = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for idx, a_max in _bucket_groups(offs[1:] - offs[:-1]):
        if a_max == 0:
            continue
        g = torch.from_numpy(idx).to(dev)
        start = offsets[g]
        count = offsets[g + 1] - start
        col = torch.arange(a_max, device=dev)
        valid = col[None, :] < count[:, None]
        flat = torch.where(valid, start[:, None] + col[None, :], 0)

        def padded(x, fill):
            x = torch.where(valid, x.to(torch.int64)[flat], fill)
            pad = torch.full((x.shape[0], BAND), fill, dtype=torch.int64,
                             device=dev)
            return torch.cat([pad, x], dim=1)

        rp, qp, qb = padded(ref_pos, 0), padded(q_pos, 0), padded(q_bp, 0)
        rv = padded(is_rev, 2)  # 2 matches no strand: padding never chains
        sc = torch.zeros((idx.shape[0], BAND + a_max), dtype=torch.float32,
                         device=dev)
        par = torch.full((idx.shape[0], a_max), -1, dtype=torch.int32,
                         device=dev)
        band_j = torch.arange(BAND, device=dev)
        for i in range(a_max):
            cur = slice(i + BAND, i + BAND + 1)
            win = slice(i, i + BAND)
            rp_i, qp_i, qb_i, rv_i = rp[:, cur], qp[:, cur], qb[:, cur], \
                rv[:, cur]
            fwd = rv_i == 0
            d_r = rp_i - rp[:, win]
            d_q = torch.where(fwd, qp_i - qp[:, win], qp[:, win] - qp_i)
            gap = (d_r - d_q).abs()
            d_bp = torch.where(fwd, qb_i - qb[:, win], qb[:, win] - qb_i)
            order = torch.where(fwd, ~(qp_i < qp[:, win]),
                                ~(qp_i > qp[:, win]))
            ok = (rv[:, win] == rv_i) & (rp[:, win] != rp_i) & \
                (qp[:, win] != qp_i) & (d_r > 0) & (d_r <= d_r_max) & \
                (gap <= MAX_GAP) & (d_bp <= BP_CAP) & order
            cand = torch.where(ok, sc[:, win] + (w - gap.to(torch.float32)),
                               neg)
            best = cand.max(dim=1, keepdim=True).values
            # the first best scanning j down from i - 1 is the largest j
            best_j = torch.where(cand == best, band_j, -1).max(dim=1).values
            take = best[:, 0] > 0
            sc[:, i + BAND] = torch.where(take, best[:, 0], w)
            par[:, i] = torch.where(take, i - BAND + best_j, -1).to(
                torch.int32)
        sc = torch.where(valid, sc[:, BAND:], 0.0)
        top = sc.max(dim=1, keepdim=True).values
        first = torch.where(sc == top, col, a_max).min(dim=1).values
        best_index[g] = torch.where(top[:, 0] > 0, first, -1).to(torch.int32)
        scores[flat[valid]] = sc[valid]
        parents[flat[valid]] = par[valid]
    return scores, parents, best_index


def _lib() -> ctypes.CDLL:
    return _bind(build.load("chain_contig", _SOURCES))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares chain_contig.cu's C interface on a loaded library."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.chain_contig_launch.argtypes = [
        vp, vp, vp, vp, vp, i64, i64, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, vp, vp, vp, vp]
    lib.chain_contig_launch.restype = ctypes.c_int
    lib.chain_contig_error_string.argtypes = [ctypes.c_int]
    lib.chain_contig_error_string.restype = ctypes.c_char_p
    return lib


def _enqueue(ref_pos, q_pos, q_bp, is_rev, offsets, d_r_max: int, out):
    """Launches the kernel into `out` = (scores, parents, best_index),
    allocated by the caller. Does not wait for the card."""
    global launches
    lib = _lib()
    dev = ref_pos.device
    n_groups = offsets.shape[0] - 1
    rev = is_rev.view(torch.uint8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chain_contig_launch(
            ref_pos.data_ptr(), q_pos.data_ptr(), q_bp.data_ptr(),
            rev.data_ptr(), offsets.data_ptr(), n_groups, ref_pos.shape[0],
            d_r_max, W, MAX_GAP, BP_CAP, *(x.data_ptr() for x in out),
            stream)
    if err != 0:
        raise RuntimeError("chain kernel launch failed: "
                           + lib.chain_contig_error_string(err).decode())
    launches += 1


def _launch(ref_pos, q_pos, q_bp, is_rev, offsets, d_r_max: int):
    dev = ref_pos.device
    n_groups = offsets.shape[0] - 1
    out = (torch.empty(ref_pos.shape[0], dtype=torch.float32, device=dev),
           torch.empty(ref_pos.shape[0], dtype=torch.int32, device=dev),
           torch.empty(n_groups, dtype=torch.int32, device=dev))
    _enqueue(ref_pos, q_pos, q_bp, is_rev, offsets, d_r_max, out)
    return out


def chain_contig(ref_pos: torch.Tensor, q_pos: torch.Tensor,
                 q_bp: torch.Tensor, is_rev: torch.Tensor,
                 offsets: torch.Tensor, d_r_max: int):
    """(scores, parents, best_index) of every anchor group, on the tensors'
    device."""
    n = ref_pos.shape[0]
    for name, t, dt in (("ref_pos", ref_pos, torch.int32),
                        ("q_pos", q_pos, torch.int32),
                        ("q_bp", q_bp, torch.int32),
                        ("is_rev", is_rev, torch.bool)):
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d {dt} tensor of "
                             f"{n} anchors, got {t.dtype} {tuple(t.shape)}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 \
            or offsets.shape[0] < 1 or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous 1-d int64 tensor of "
                         "n_groups + 1 entries")
    dev = ref_pos.device
    if any(t.device != dev for t in (q_pos, q_bp, is_rev, offsets)):
        raise ValueError("all inputs must lie on one device")
    if not 0 <= d_r_max < 1 << 30:
        raise ValueError(f"d_r_max out of range: {d_r_max}")
    first, last = offsets[[0, -1]].tolist()
    if first != 0 or last != n or (offsets.shape[0] > 1 and bool(
            (offsets[1:] < offsets[:-1]).any())):
        raise ValueError("offsets must rise from 0 to the anchor count")
    if dev.type == "cuda":
        return _launch(ref_pos, q_pos, q_bp, is_rev, offsets, d_r_max)
    if dev.type == "cpu":
        return chain_contig_reference(ref_pos, q_pos, q_bp, is_rev, offsets,
                                      d_r_max)
    raise ValueError(f"no chain kernel for device {dev}")
