"""Kernel K4: the correction read mapper's chain DP over ragged anchor groups.

`chain_dp` is the wrapper: on CUDA tensors it launches the hand-written
kernel in csrc/chain_dp.cu (built by kernels/build.py) or raises; on CPU
tensors it runs `chain_dp_reference`, the plain torch version in this
module. Both compute what the JAX package's XLA scan
metamdbg_tpu/kernels/chain_jax.py:_chainer computes over padded groups, and
the host DP native/sketch.cpp:chain_mapper_batch over one group with its
backtrack: the banded chain DP of ReadMapper (anchor weight 20, distance
cap 5000, gap cap 100, a band set at run time), then the best chain's
query pair indexes and its score nb_matches - diff_q
(metamdbg_tpu/correction/mapper.py:78-99).

Groups are ragged: flat anchor arrays (ref_pos, q_pos int64 base-space
pair centres, is_rev bool, q_idx int32 query pair indexes) sorted by
(ref, query) inside each group, and int64 `offsets` of length
n_groups + 1. Outputs:
- per anchor: scores (f32) and parents (int32, group-local, -1 for a chain
  start), and chain_pos (int32): slot t of group g holds the t-th smallest
  q_idx of the group's best chain for t < chain_len[g], else -1;
- per group: best_index (int32), the first anchor with the maximum score if
  it is > 0, else -1; chain_len (int32), the best chain's anchor count (0
  without one); chain_score (int32), 2 * chain_len - 1 - |q_idx(best) -
  q_idx(root)|, or INT32_MIN for a chain of fewer than 3 anchors.

`launches` counts kernel launches; the plain version counts nothing.
"""

import ctypes
import dataclasses

import numpy as np
import torch

from . import build

launches = 0

_SOURCES = ("chain_dp.cu",)
CHAIN_W = 20.0            # MinimizerChainer.hpp:741
CHAIN_MAX_DIST = 5000     # MinimizerChainer.hpp:913
CHAIN_MAX_GAP = 100       # MinimizerChainer.hpp:924
INT32_MIN = -(1 << 31)
# positions lie in [0, POS_LIMIT), so that every difference the DP takes,
# d_r - d_q included, fits int32 as in the JAX scan
POS_LIMIT = 1 << 30


def reset_counts():
    global launches
    launches = 0


@dataclasses.dataclass
class ChainResult:
    scores: torch.Tensor        # f32 per anchor
    parents: torch.Tensor       # int32 per anchor
    best_index: torch.Tensor    # int32 per group
    chain_len: torch.Tensor     # int32 per group
    chain_score: torch.Tensor   # int32 per group
    chain_pos: torch.Tensor     # int32 per anchor


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


def _dp_reference(ref_pos, q_pos, is_rev, offsets, band: int):
    """The DP: groups bucketed by length, padded to the bucket's longest
    group, and stepped anchor by anchor over the whole bucket at once, as
    the JAX scan steps its padded groups."""
    dev = ref_pos.device
    n = ref_pos.shape[0]
    n_groups = offsets.shape[0] - 1
    scores = torch.zeros(n, dtype=torch.float32, device=dev)
    parents = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_index = torch.full((n_groups,), -1, dtype=torch.int32, device=dev)
    offs = offsets.cpu().numpy()
    w = torch.tensor(CHAIN_W, dtype=torch.float32, device=dev)
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
            pad = torch.full((x.shape[0], band), fill, dtype=torch.int64,
                             device=dev)
            return torch.cat([pad, x], dim=1)

        rp, qp = padded(ref_pos, 0), padded(q_pos, 0)
        rv = padded(is_rev, 2)  # 2 matches no strand: padding never chains
        sc = torch.zeros((idx.shape[0], band + a_max), dtype=torch.float32,
                         device=dev)
        par = torch.full((idx.shape[0], a_max), -1, dtype=torch.int32,
                         device=dev)
        band_j = torch.arange(band, device=dev)
        for i in range(a_max):
            cur = slice(i + band, i + band + 1)
            win = slice(i, i + band)
            rp_i, qp_i, rv_i = rp[:, cur], qp[:, cur], rv[:, cur]
            fwd = rv_i == 0
            d_r = rp_i - rp[:, win]
            d_q = torch.where(fwd, qp_i - qp[:, win], qp[:, win] - qp_i)
            gap = (d_r - d_q).abs()
            order = torch.where(fwd, ~(qp_i < qp[:, win]),
                                ~(qp_i > qp[:, win]))
            ok = (rv[:, win] == rv_i) & (rp[:, win] != rp_i) & \
                (qp[:, win] != qp_i) & (d_q <= CHAIN_MAX_DIST) & \
                (d_r <= CHAIN_MAX_DIST) & (d_r > 0) & \
                (gap <= CHAIN_MAX_GAP) & order
            cand = torch.where(ok, sc[:, win] + (w - gap.to(torch.float32)),
                               neg)
            best = cand.max(dim=1, keepdim=True).values
            # the first best scanning j down from i - 1 is the largest j
            best_j = torch.where(cand == best, band_j, -1).max(dim=1).values
            take = best[:, 0] > 0
            sc[:, i + band] = torch.where(take, best[:, 0], w)
            par[:, i] = torch.where(take, i - band + best_j, -1).to(
                torch.int32)
        sc = torch.where(valid, sc[:, band:], 0.0)
        top = sc.max(dim=1, keepdim=True).values
        first = torch.where(sc == top, col, a_max).min(dim=1).values
        best_index[g] = torch.where(top[:, 0] > 0, first, -1).to(torch.int32)
        scores[flat[valid]] = sc[valid]
        parents[flat[valid]] = par[valid]
    return scores, parents, best_index


def _backtrack_reference(q_idx, offsets, parents, best_index):
    """Every group's best chain, all groups stepped together from the best
    anchor to the chain's root: (chain_len, chain_score, chain_pos)."""
    dev = q_idx.device
    n_groups = offsets.shape[0] - 1
    start = offsets[:-1]
    chain_len = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    q_best = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    q_root = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    chain_pos = torch.full((q_idx.shape[0],), -1, dtype=torch.int32,
                           device=dev)
    groups = torch.nonzero(best_index >= 0).flatten()
    cur = best_index[groups].to(torch.int64)
    q_best[groups] = q_idx[start[groups] + cur].to(torch.int64)
    members_g, members_q = [], []
    while groups.numel():
        a = start[groups] + cur
        q = q_idx[a].to(torch.int64)
        members_g.append(groups)
        members_q.append(q)
        chain_len[groups] += 1
        q_root[groups] = q  # the last anchor written is the root
        cur = parents[a].to(torch.int64)
        live = cur >= 0
        groups, cur = groups[live], cur[live]
    if members_g:
        # each chain's q_idx ascending, into its group's own slice
        g, q = torch.cat(members_g), torch.cat(members_q)
        order = torch.sort(q, stable=True).indices
        order = order[torch.sort(g[order], stable=True).indices]
        g, q = g[order], q[order]
        rank = torch.arange(g.shape[0], device=dev) - \
            torch.searchsorted(g, g)
        chain_pos[start[g] + rank] = q.to(torch.int32)
    score = 2 * chain_len.to(torch.int64) - 1 - (q_best - q_root).abs()
    chain_score = torch.where(chain_len >= 3, score, INT32_MIN).to(
        torch.int32)
    return chain_len, chain_score, chain_pos


def chain_dp_reference(ref_pos, q_pos, is_rev, q_idx, offsets,
                       band: int) -> ChainResult:
    """Plain torch version of the kernel, on int32 positions."""
    scores, parents, best_index = _dp_reference(ref_pos, q_pos, is_rev,
                                                offsets, band)
    chain_len, chain_score, chain_pos = _backtrack_reference(
        q_idx, offsets, parents, best_index)
    return ChainResult(scores, parents, best_index, chain_len, chain_score,
                       chain_pos)


def _lib() -> ctypes.CDLL:
    return _bind(build.load("chain_dp", _SOURCES))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares chain_dp.cu's C interface on a loaded library."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.chain_dp_launch.argtypes = [
        vp, vp, vp, vp, vp, i64, i64, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp]
    lib.chain_dp_launch.restype = ctypes.c_int
    lib.chain_dp_error_string.argtypes = [ctypes.c_int]
    lib.chain_dp_error_string.restype = ctypes.c_char_p
    return lib


def _enqueue(ref_pos, q_pos, is_rev, q_idx, offsets, band: int,
             out: ChainResult):
    """Launches the kernel into `out`, allocated by the caller. Does not
    wait for the card."""
    global launches
    lib = _lib()
    dev = ref_pos.device
    n_groups = offsets.shape[0] - 1
    rev = is_rev.view(torch.uint8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chain_dp_launch(
            ref_pos.data_ptr(), q_pos.data_ptr(), rev.data_ptr(),
            q_idx.data_ptr(), offsets.data_ptr(), n_groups,
            ref_pos.shape[0], band, CHAIN_W, CHAIN_MAX_DIST, CHAIN_MAX_GAP,
            out.scores.data_ptr(),
            out.parents.data_ptr(), out.best_index.data_ptr(),
            out.chain_len.data_ptr(), out.chain_score.data_ptr(),
            out.chain_pos.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("chain_dp kernel launch failed: "
                           + lib.chain_dp_error_string(err).decode())
    launches += 1


def _launch(ref_pos, q_pos, is_rev, q_idx, offsets, band: int) -> ChainResult:
    dev = ref_pos.device
    n = ref_pos.shape[0]
    n_groups = offsets.shape[0] - 1

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)

    out = ChainResult(empty(n, torch.float32), empty(n, torch.int32),
                      empty(n_groups, torch.int32),
                      empty(n_groups, torch.int32),
                      empty(n_groups, torch.int32), empty(n, torch.int32))
    _enqueue(ref_pos, q_pos, is_rev, q_idx, offsets, band, out)
    return out


def chain_dp(ref_pos: torch.Tensor, q_pos: torch.Tensor,
             is_rev: torch.Tensor, q_idx: torch.Tensor,
             offsets: torch.Tensor, band: int) -> ChainResult:
    """The DP and the best chain of every anchor group, on the tensors'
    device. ref_pos and q_pos are int64 and must lie in [0, 2^30); the
    kernel and the plain version take them as int32."""
    n = ref_pos.shape[0]
    for name, t, dt in (("ref_pos", ref_pos, torch.int64),
                        ("q_pos", q_pos, torch.int64),
                        ("is_rev", is_rev, torch.bool),
                        ("q_idx", q_idx, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d {dt} tensor of "
                             f"{n} anchors, got {t.dtype} {tuple(t.shape)}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 \
            or offsets.shape[0] < 1 or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous 1-d int64 tensor of "
                         "n_groups + 1 entries")
    dev = ref_pos.device
    if any(t.device != dev for t in (q_pos, is_rev, q_idx, offsets)):
        raise ValueError("all inputs must lie on one device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no chain_dp kernel for device {dev}")
    if not 1 <= band < 1 << 20:
        raise ValueError(f"band out of range: {band}")
    first, last = offsets[[0, -1]].tolist()
    if first != 0 or last != n or (offsets.shape[0] > 1 and bool(
            (offsets[1:] < offsets[:-1]).any())):
        raise ValueError("offsets must rise from 0 to the anchor count")
    if n and not all(0 <= x < POS_LIMIT for x in torch.cat(
            [torch.stack(torch.aminmax(t)) for t in (ref_pos, q_pos)]
    ).tolist()):
        raise ValueError("positions must lie in [0, 2^30), so that their "
                         "differences fit int32")
    rp, qp = ref_pos.to(torch.int32), q_pos.to(torch.int32)
    if dev.type == "cuda":
        return _launch(rp, qp, is_rev, q_idx, offsets, band)
    return chain_dp_reference(rp, qp, is_rev, q_idx, offsets, band)
