"""ctypes binding to the native overlap/mapping engine (native/overlap.cpp).

One call maps a batch of pre-sketched queries against a SeqIndex (OpenMP
across queries) — the hot core of basespace/overlap.map_sketched, which
remains the pure-Python oracle (bit-identical chains,
tests/test_overlap_native.py)."""

import ctypes
import logging
import os
import subprocess
import threading

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
    if os.environ.get("METAMDBG_TPU_HOST_OVERLAP"):
        return None
    so = os.path.join(_NATIVE_DIR, "liboverlap.so")
    src = os.path.join(_NATIVE_DIR, "overlap.cpp")
    if not os.path.exists(so) or (os.path.exists(src) and
                                  os.path.getmtime(src) > os.path.getmtime(so)):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "liboverlap.so"],
                           check=True, capture_output=True)
        except Exception as e:  # pragma: no cover - toolchain always present
            log.warning("native overlap build failed: %s", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:  # pragma: no cover
        log.warning("native overlap load failed: %s", e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ovl_map_batch.argtypes = [
        u32p, i64p, i64p, u8p, ctypes.c_int64, i64p,
        u32p, i64p, u8p, i64p, i64p, ctypes.c_int32,
        i64p, ctypes.c_uint8, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        i64p, i64p, i64p, i64p, i64p, i64p, f64p, i32p, u8p,
        ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64, i64p,
        ctypes.c_int32]
    lib.ovl_map_batch.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class PairIndex:
    """Prebuilt single-target index (tid 0) with cached ctypes pointers —
    the per-(r1, r2) overlap_pair path calls map_pair tens of thousands of
    times per contig, so wrapper overhead matters."""

    __slots__ = ("ivals", "itids", "ipos", "idirs", "ni", "tlen",
                 "p_ivals", "p_itids", "p_ipos", "p_idirs", "p_tlen")

    def __init__(self, t_sketch, t_len):
        vals, pos, dirs = t_sketch
        order = np.argsort(vals, kind="stable")
        self.ivals = np.ascontiguousarray(vals[order], np.uint32)
        self.ipos = np.ascontiguousarray(pos[order], np.int64)
        self.idirs = np.ascontiguousarray(dirs[order], np.uint8)
        self.itids = np.zeros(self.ivals.shape[0], np.int64)
        self.ni = self.ivals.shape[0]
        self.tlen = np.array([t_len], np.int64)
        self.p_ivals = _ptr(self.ivals, ctypes.c_uint32)
        self.p_itids = _ptr(self.itids, ctypes.c_int64)
        self.p_ipos = _ptr(self.ipos, ctypes.c_int64)
        self.p_idirs = _ptr(self.idirs, ctypes.c_uint8)
        self.p_tlen = _ptr(self.tlen, ctypes.c_int64)


class _PairScratch:
    """Reusable output buffers + cached pointers for map_pair."""

    def __init__(self):
        self.chain_offs = np.zeros(2, np.int64)
        self.needed = np.zeros(2, np.int64)
        self.exclude = np.full(1, -1, np.int64)
        self.q_offs = np.zeros(2, np.int64)
        self.q_lens = np.zeros(1, np.int64)
        self.chain_cap = 0
        self.anchor_cap = 1 << 14
        self.aq = np.empty(self.anchor_cap, np.int64)
        self.at = np.empty(self.anchor_cap, np.int64)
        self._alloc_chains(64)
        self._grow_anchor_ptrs()

    def _alloc_chains(self, n):
        self.chain_cap = n
        self.qs = np.empty(n, np.int64)
        self.qe = np.empty(n, np.int64)
        self.ts = np.empty(n, np.int64)
        self.te = np.empty(n, np.int64)
        self.matches = np.empty(n, np.int64)
        self.identity = np.empty(n, np.float64)
        self.tid = np.empty(n, np.int32)
        self.rev = np.empty(n, np.uint8)
        self.anchor_offs = np.empty(n + 1, np.int64)
        self._fixed = dict(
            chain_offs=_ptr(self.chain_offs, ctypes.c_int64),
            qs=_ptr(self.qs, ctypes.c_int64),
            qe=_ptr(self.qe, ctypes.c_int64),
            ts=_ptr(self.ts, ctypes.c_int64),
            te=_ptr(self.te, ctypes.c_int64),
            matches=_ptr(self.matches, ctypes.c_int64),
            identity=_ptr(self.identity, ctypes.c_double),
            tid=_ptr(self.tid, ctypes.c_int32),
            rev=_ptr(self.rev, ctypes.c_uint8),
            anchor_offs=_ptr(self.anchor_offs, ctypes.c_int64),
            needed=_ptr(self.needed, ctypes.c_int64),
            exclude=_ptr(self.exclude, ctypes.c_int64),
            q_offs=_ptr(self.q_offs, ctypes.c_int64),
            q_lens=_ptr(self.q_lens, ctypes.c_int64))

    def _grow_anchor_ptrs(self):
        self.p_aq = _ptr(self.aq, ctypes.c_int64)
        self.p_at = _ptr(self.at, ctypes.c_int64)

    def ensure_chain_cap(self, n):
        if n > self.chain_cap:
            self._alloc_chains(max(n, 2 * self.chain_cap))

    def ensure_anchor_cap(self, n):
        if n > self.anchor_cap:
            self.anchor_cap = max(n, 2 * self.anchor_cap)
            self.aq = np.empty(self.anchor_cap, np.int64)
            self.at = np.empty(self.anchor_cap, np.int64)
            self._grow_anchor_ptrs()


# per-thread scratch (ADVICE r4): the fork-based pools each get their own
# copy anyway, but two Python *threads* sharing one singleton would corrupt
# each other's buffers mid-call
_TLS = threading.local()


def map_pair(pindex: PairIndex, q_vals, q_pos, q_dirs, q_len, density,
             min_span, max_occ, band=500, max_chains=4, min_anchors=4,
             align_l=15):
    """Single query vs a PairIndex; returns the map_sketched_batch chain
    tuples for that query, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = getattr(_TLS, "scratch", None)
    if s is None:
        s = _TLS.scratch = _PairScratch()
    nq = q_vals.shape[0]
    s.q_offs[1] = nq
    s.q_lens[0] = q_len
    s.ensure_chain_cap(2 * max_chains)  # floor; retries grow from needed[0]
    for _attempt in range(4):
        f = s._fixed
        rc = lib.ovl_map_batch(
            pindex.p_ivals, pindex.p_itids, pindex.p_ipos, pindex.p_idirs,
            np.int64(pindex.ni), pindex.p_tlen,
            _ptr(q_vals, ctypes.c_uint32), _ptr(q_pos, ctypes.c_int64),
            _ptr(q_dirs, ctypes.c_uint8), f["q_offs"], f["q_lens"],
            np.int32(1), f["exclude"], ctypes.c_uint8(0),
            ctypes.c_double(density), np.int64(min_span), np.int64(max_occ),
            np.int64(band), np.int32(max_chains), np.int64(min_anchors),
            np.int32(align_l), f["chain_offs"], f["qs"], f["qe"], f["ts"],
            f["te"], f["matches"], f["identity"], f["tid"], f["rev"],
            np.int64(s.chain_cap), f["anchor_offs"], s.p_aq, s.p_at,
            np.int64(s.anchor_cap), f["needed"], np.int32(1))
        if rc >= 0:
            break
        # grow BOTH capacities from the engine's reported needs (ADVICE
        # r4: growing only anchors could exhaust the retries even though
        # needed[0] says exactly how many chain slots are required)
        s.ensure_chain_cap(int(s.needed[0]))
        s.ensure_anchor_cap(int(s.needed[1]))
    else:
        raise RuntimeError("map_pair capacity retry failed")
    n = int(s.chain_offs[1])
    out = []
    for c in range(n):
        a, b = int(s.anchor_offs[c]), int(s.anchor_offs[c + 1])
        out.append((int(s.qs[c]), int(s.qe[c]), int(s.ts[c]), int(s.te[c]),
                    int(s.matches[c]), float(s.identity[c]), int(s.tid[c]),
                    bool(s.rev[c]), s.aq[a:b].copy(), s.at[a:b].copy()))
    return out


def map_sketched_batch(index, queries, density, min_span, max_occ, band,
                       max_chains, min_anchors, align_l,
                       exclude_self_diag=False, n_threads=None):
    """queries: list of (q_vals u32, q_pos i64, q_dirs u8, qlen,
    exclude_tid|-1). Returns per query a list of chain tuples
    (qs, qe, ts, te, matches, identity, tid, rev, aq, at) in the oracle's
    order, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    nq = len(queries)
    if nq == 0:
        return []
    ni = index.vals.shape[0]
    if ni == 0:
        return [[] for _ in range(nq)]
    max_tid = int(index.tids.max()) if ni else 0
    tid_lengths = np.zeros(max_tid + 1, np.int64)
    for tid, ln in index.lengths.items():
        if 0 <= tid <= max_tid:
            tid_lengths[tid] = ln

    q_offs = np.zeros(nq + 1, np.int64)
    for i, q in enumerate(queries):
        q_offs[i + 1] = q_offs[i] + q[0].shape[0]
    tot = int(q_offs[-1])
    q_vals = np.empty(tot, np.uint32)
    q_pos = np.empty(tot, np.int64)
    q_dirs = np.empty(tot, np.uint8)
    q_lens = np.empty(nq, np.int64)
    exclude = np.empty(nq, np.int64)
    for i, (v, p, d, qlen, ex) in enumerate(queries):
        a, b = q_offs[i], q_offs[i + 1]
        q_vals[a:b] = v
        q_pos[a:b] = p
        q_dirs[a:b] = d
        q_lens[i] = qlen
        exclude[i] = ex

    ivals = np.ascontiguousarray(index.vals, np.uint32)
    itids = np.ascontiguousarray(index.tids, np.int64)
    ipos = np.ascontiguousarray(index.pos, np.int64)
    idirs = np.ascontiguousarray(index.dirs, np.uint8)

    chain_cap = 4 * nq + 64
    anchor_cap = tot + 1024
    for _attempt in range(2):
        chain_offs = np.zeros(nq + 1, np.int64)
        out_qs = np.empty(chain_cap, np.int64)
        out_qe = np.empty(chain_cap, np.int64)
        out_ts = np.empty(chain_cap, np.int64)
        out_te = np.empty(chain_cap, np.int64)
        out_matches = np.empty(chain_cap, np.int64)
        out_identity = np.empty(chain_cap, np.float64)
        out_tid = np.empty(chain_cap, np.int32)
        out_rev = np.empty(chain_cap, np.uint8)
        anchor_offs = np.zeros(chain_cap + 1, np.int64)
        out_aq = np.empty(anchor_cap, np.int64)
        out_at = np.empty(anchor_cap, np.int64)
        needed = np.zeros(2, np.int64)
        rc = lib.ovl_map_batch(
            _ptr(ivals, ctypes.c_uint32), _ptr(itids, ctypes.c_int64),
            _ptr(ipos, ctypes.c_int64), _ptr(idirs, ctypes.c_uint8),
            np.int64(ni), _ptr(tid_lengths, ctypes.c_int64),
            _ptr(q_vals, ctypes.c_uint32), _ptr(q_pos, ctypes.c_int64),
            _ptr(q_dirs, ctypes.c_uint8), _ptr(q_offs, ctypes.c_int64),
            _ptr(q_lens, ctypes.c_int64), np.int32(nq),
            _ptr(exclude, ctypes.c_int64),
            ctypes.c_uint8(1 if exclude_self_diag else 0),
            ctypes.c_double(density), np.int64(min_span), np.int64(max_occ),
            np.int64(band), np.int32(max_chains), np.int64(min_anchors),
            np.int32(align_l), _ptr(chain_offs, ctypes.c_int64),
            _ptr(out_qs, ctypes.c_int64), _ptr(out_qe, ctypes.c_int64),
            _ptr(out_ts, ctypes.c_int64), _ptr(out_te, ctypes.c_int64),
            _ptr(out_matches, ctypes.c_int64),
            _ptr(out_identity, ctypes.c_double),
            _ptr(out_tid, ctypes.c_int32), _ptr(out_rev, ctypes.c_uint8),
            np.int64(chain_cap), _ptr(anchor_offs, ctypes.c_int64),
            _ptr(out_aq, ctypes.c_int64), _ptr(out_at, ctypes.c_int64),
            np.int64(anchor_cap), _ptr(needed, ctypes.c_int64),
            np.int32(n_threads))
        if rc >= 0:
            out = []
            for i in range(nq):
                chains = []
                for c in range(int(chain_offs[i]), int(chain_offs[i + 1])):
                    a, b = int(anchor_offs[c]), int(anchor_offs[c + 1])
                    chains.append((int(out_qs[c]), int(out_qe[c]),
                                   int(out_ts[c]), int(out_te[c]),
                                   int(out_matches[c]),
                                   float(out_identity[c]), int(out_tid[c]),
                                   bool(out_rev[c]), out_aq[a:b].copy(),
                                   out_at[a:b].copy()))
                out.append(chains)
            return out
        chain_cap = max(chain_cap, int(needed[0]))
        anchor_cap = max(anchor_cap, int(needed[1]))
    raise RuntimeError("ovl_map_batch capacity retry failed")
