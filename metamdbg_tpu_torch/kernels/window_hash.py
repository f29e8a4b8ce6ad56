"""Kernel KW: canonical k-min-mer hashing of windows of a minimizer stream.

Two wrappers, one per way of naming the windows; on CUDA tensors each
launches its hand-written kernel in csrc/window_hash.cu (built by
kernels/build.py) or raises; on CPU tensors each runs its plain torch
version in this module. Both compute, for each window, its u32 values made
canonical when `normalize` (lexicographic min of it and its reverse; a tie
takes the reverse), hashed with MurmurHash3_x64_128, seed 0, as 4*w
little-endian bytes. Outputs are (h1, h2), int64 tensors holding the u64
bits.

- `hash_windows(cat, starts, w, normalize)`: explicit starts, one per
  window, into `cat` (u32 values carried in an int64 stream). `w` is an
  int, or a 1-D int64 tensor with one width per start (the variable-length
  unitig sequences of the deterministic order). A window outside `cat`
  raises, on either device: the kernel checks each window itself and sets
  a flag word that the wrapper reads after the outputs, the one wait for
  the card per call; the plain version checks with torch ops. Plain
  version: `hash_windows_reference`.
- `hash_segments(segments, device)`: every w-window of every sequence of a
  `Stream` (u32 words in int32 slots; the sequences' lengths on the host),
  for any number of `Segment`s (a range of one stream's sequences, its
  width and normalize bit) in one launch. The window tables come from the
  lengths, which the host holds, so nothing waits for the card; the host
  data of a request (the tables, the words of streams not yet on the
  device, the descriptor table) goes up in one pinned copy. A stream moved
  to the device with `Stream.to` keeps its words there (the reads of the
  ladder, graph/multiplex.ReadsCache). Plain version:
  `hash_segments_reference`.

It is the port of what the JAX package computes three ways: in numpy
(count/kminmers.normalize_rows + utils/hashing.murmur128_u32rows), in
native SIMD (native/sketch.cpp:window_hash_batch, row_hash_batch) and in
XLA (parallel/count_table.py:_window_hash_pairs, rows + lengths: the shape
of the segmented mode).

`launches` counts kernel launches, and `sites` the same launches by the
caller outside this module and the pass-through helpers (`file:function`);
the plain versions count nothing.
"""

import collections
import ctypes
import dataclasses
import itertools
import os
import random
import sys

import numpy as np
import torch

from ..utils import hashing
from . import build

launches = 0
sites: collections.Counter = collections.Counter()

_SOURCES = ("window_hash.cu",)
# plain version: cap on the gathered (windows, w) elements per chunk
_BATCH_ELEMS = 8 << 20
# the segmented mode: windows per tile (csrc/window_hash.cu's kThreads),
# per warp, and int64 words per segment descriptor (its kSegWords, fields
# in that order)
TILE, WARP = 256, 32
_SEG_WORDS = 10
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# helpers outside this module that only pass a caller's windows on: a
# launch is counted at their caller
_PASS_THROUGH = frozenset({"flat_window_hashes"})


def reset_counts():
    global launches
    launches = 0
    sites.clear()


def _count_launch():
    """One launch, at the caller of the outermost frame of this module or
    of a pass-through helper (a wrapper of `_launch` set between them, as
    a launch recorder is, does not hide the caller)."""
    global launches
    launches += 1
    f, site = sys._getframe(1), None
    while f is not None:
        if f.f_globals.get("__name__") == __name__ or \
                f.f_code.co_name in _PASS_THROUGH:
            site = f.f_back
        f = f.f_back
    if site is None:
        sites["?"] += 1
        return
    path = os.path.abspath(site.f_code.co_filename)
    rel = (os.path.relpath(path, _PKG_DIR) if path.startswith(_PKG_DIR)
           else os.path.basename(path))
    sites[f"{rel}:{site.f_code.co_name}"] += 1


def normalize_rows(windows: torch.Tensor):
    """KmerVec::normalize over rows: lexicographic min(row, reversed row).

    Ties (palindromes) pick the reversed copy (src/Commons.hpp:886-916).
    Returns (normalized rows, is_reversed bool); the twin of
    metamdbg_tpu/count/kminmers.py:normalize_rows.
    """
    n, k = windows.shape
    rev = windows.flip(1)
    neq = windows != rev
    first = torch.where(neq.any(dim=1), neq.to(torch.uint8).argmax(dim=1),
                        k - 1)[:, None]
    is_reversed = ~(windows.gather(1, first) < rev.gather(1, first))[:, 0]
    return torch.where(is_reversed[:, None], rev, windows), is_reversed


def _reference_fixed(cat, starts, w: int, normalize: bool):
    n = starts.shape[0]
    h1 = torch.empty(n, dtype=torch.int64, device=cat.device)
    h2 = torch.empty_like(h1)
    step = max(_BATCH_ELEMS // w, 1)
    ar = torch.arange(w, device=cat.device)
    for a in range(0, n, step):
        # int64 or int32 slots: the low 32 bits are the value
        wins = cat[starts[a:a + step, None] + ar].to(torch.int64) & 0xFFFFFFFF
        if normalize:
            wins = normalize_rows(wins)[0]
        h1[a:a + step], h2[a:a + step] = hashing.murmur128_u32rows(wins)
    return h1, h2


def hash_windows_reference(cat: torch.Tensor, starts: torch.Tensor, w,
                           normalize: bool):
    """Plain torch version: gather the windows, normalise them with torch
    ops, hash them with utils/hashing.murmur128_u32rows."""
    if isinstance(w, int):
        return _reference_fixed(cat, starts, w, normalize)
    h1 = torch.empty(starts.shape[0], dtype=torch.int64, device=cat.device)
    h2 = torch.empty_like(h1)
    for width in torch.unique(w).tolist():
        sel = torch.nonzero(w == width).flatten()
        h1[sel], h2[sel] = _reference_fixed(cat, starts[sel], width,
                                            normalize)
    return h1, h2


def _lib() -> ctypes.CDLL:
    return _bind(build.load("window_hash", _SOURCES))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares window_hash.cu's C interface on a loaded library."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.window_hash_launch.argtypes = [vp, i64, vp, vp, i64, ctypes.c_int,
                                       ctypes.c_int, vp, i64, vp]
    lib.window_hash_launch.restype = ctypes.c_int
    lib.window_hash_segments_launch.argtypes = [vp, ctypes.c_int, i64, vp,
                                                i64, vp]
    lib.window_hash_segments_launch.restype = ctypes.c_int
    lib.window_hash_error_string.argtypes = [ctypes.c_int]
    lib.window_hash_error_string.restype = ctypes.c_char_p
    return lib


def _enqueue(cat, starts, w, normalize: bool, out: torch.Tensor,
             token: int = 0):
    """Launches the kernel into `out`, (2n + 1,) int64: h1, h2, then the
    flag word, which the kernel sets to token + 1 if a window reaches
    outside the stream and to token + 2 if a width is below 1, and leaves
    alone otherwise. Does not wait for the card."""
    lib = _lib()
    n = starts.shape[0]
    widths = None if isinstance(w, int) else w
    with torch.cuda.device(cat.device):
        stream = torch.cuda.current_stream(cat.device).cuda_stream
        err = lib.window_hash_launch(
            cat.data_ptr(), cat.numel(), starts.data_ptr(),
            None if widths is None else widths.data_ptr(), n,
            w if widths is None else 0, int(normalize), out.data_ptr(),
            token, stream)
    if err != 0:
        raise RuntimeError("window hash kernel launch failed: "
                           + lib.window_hash_error_string(err).decode())
    _count_launch()


# One token per launch: the flag word of a fresh output holds whatever the
# allocator left there, which is a token + 1 or + 2 of this launch only if
# this launch wrote it (the tokens are distinct and spaced by 4).
_tokens = itertools.count(4 * random.getrandbits(48) + 4, 4)


def _launch(cat: torch.Tensor, starts: torch.Tensor, w, normalize: bool):
    n = starts.shape[0]
    out = torch.empty(2 * n + 1, dtype=torch.int64, device=cat.device)
    token = next(_tokens)
    _enqueue(cat, starts, w, normalize, out, token)
    flag = int(out[2 * n]) - token  # the one wait for the card
    if flag == 2:
        raise ValueError("window widths must be >= 1")
    if flag == 1:
        raise ValueError(f"windows reach outside the stream of "
                         f"{cat.numel()}")
    return out[:n], out[n:2 * n]


def _check_range(cat, starts, w):
    """The range check of the plain version; the kernel makes its own."""
    if not isinstance(w, int) and w.numel() and int(w.min()) < 1:
        raise ValueError("window widths must be >= 1")
    lo, hi = torch.stack([starts.min(), (starts + w).max()]).tolist()
    if lo < 0 or hi > cat.numel():
        raise ValueError(f"windows reach outside the stream: [{lo}, {hi}) "
                         f"of {cat.numel()}")


def hash_windows(cat: torch.Tensor, starts: torch.Tensor, w,
                 normalize: bool):
    """(h1, h2) of the window of width `w` at each of `starts` in `cat`, on
    the tensors' device. A window outside `cat`, or a width below 1,
    raises ValueError."""
    for name, t in (("cat", cat), ("starts", starts)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d int64 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if starts.device != cat.device:
        raise ValueError("cat and starts must lie on one device")
    if isinstance(w, int):
        if w < 1:
            raise ValueError(f"window width must be >= 1, got {w}")
    elif (w.dtype != torch.int64 or w.shape != starts.shape
          or not w.is_contiguous() or w.device != cat.device):
        raise ValueError("per-window widths must be a contiguous int64 "
                         "tensor shaped like starts, on its device")
    if starts.numel() == 0:
        return starts.clone(), starts.clone()
    if cat.device.type == "cuda":
        return _launch(cat, starts, w, normalize)
    if cat.device.type == "cpu":
        _check_range(cat, starts, w)
        return hash_windows_reference(cat, starts, w, normalize)
    raise ValueError(f"no window hash kernel for device {cat.device}")


def hash_rows(rows: torch.Tensor, first: int = 0, width: int | None = None):
    """(h1, h2) of the raw slice rows[:, first:first+width] (whole rows by
    default) of each row of an (N, k) int64 table of u32 values: the port
    of murmur128_u32rows over a row table, through `hash_windows`."""
    rows = rows.contiguous()
    n, k = rows.shape
    starts = torch.arange(n, dtype=torch.int64, device=rows.device) * k
    return hash_windows(rows.view(-1), starts + first,
                        k - first if width is None else width,
                        normalize=False)


# -- the segmented mode ------------------------------------------------------

class Stream:
    """Sequences of u32 words back to back: the segmented mode's input.

    `lens` and `offsets`, the sequences' lengths and (n + 1,) word offsets,
    stay on the host (numpy int64), where each request derives its window
    tables from them. Once the stream lies on a device (`to`), `words` is
    an int32 tensor there holding the u32 bits of every word in turn; until
    then a request that names the stream carries its words up in the
    request's own copy."""

    def __init__(self, seqs):
        self.lens = np.fromiter((s.shape[0] for s in seqs), np.int64,
                                len(seqs))
        self.host_words = (np.concatenate(seqs).astype(np.uint32, copy=False)
                           .view(np.int32) if self.lens.sum()
                           else np.zeros(0, np.int32))
        self.offsets = np.zeros(self.lens.shape[0] + 1, np.int64)
        np.cumsum(self.lens, out=self.offsets[1:])
        self.device = None
        self.words = None

    def __len__(self):
        return self.lens.shape[0]

    def _pack_words(self) -> int:
        """int64 slots of the stream's words in a copy, two to a slot."""
        return (self.host_words.shape[0] + 1) // 2

    def _fill(self, pack: np.ndarray, at: int, dev_pack: torch.Tensor):
        """Writes the words into pack[at:]; returns the same place of
        `dev_pack` as an int32 tensor of the words."""
        n = self.host_words.shape[0]
        pack[at:at + self._pack_words()].view(np.int32)[:n] = self.host_words
        return dev_pack[at:at + self._pack_words()].view(torch.int32)[:n]

    def to(self, device):
        """Uploads the words to `device` in one copy, to stay there."""
        device = _device(device)
        host, dev = _staging(self._pack_words(), device)
        self.words = self._fill(host.numpy(), 0, dev)
        _upload(host, dev)
        self.device = device
        self.host_words = None
        return self


@dataclasses.dataclass
class Segment:
    """Every w-window of sequences [lo, hi) of `stream` (hi None: to its
    end), canonical when `normalize`."""
    stream: Stream
    w: int
    normalize: bool = True
    lo: int = 0
    hi: int | None = None


# a segment as the kernel takes it, its tensors on the device: the stream's
# words; the window offsets of its n sequences (n + 1, returned to the
# caller); of the m sequences that have windows, their window offsets
# (m + 1) and the word at which each one's window 0 starts, less that
# window's index (m); the sequence of each warp's first window among those
# m; and host numbers
Seg = collections.namedtuple(
    "Seg", "words win_off live_win live_base warp_seq n_win w normalize out")


def _device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" is the current
    card), so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _staging(n: int, device):
    """(host, dev): int64 tensors of n slots, the host one to fill and the
    device one it goes to. On a CUDA device the host one is pinned, so that
    the copy waits for nothing (the caching host allocator keeps it until
    the copy is done); on the CPU they are one tensor."""
    if device.type == "cuda":
        return (torch.empty(n, dtype=torch.int64, pin_memory=True),
                torch.empty(n, dtype=torch.int64, device=device))
    host = torch.zeros(n, dtype=torch.int64)
    return host, host


def _upload(host: torch.Tensor, dev: torch.Tensor):
    if dev is not host:
        dev.copy_(host, non_blocking=True)


def _descriptors(segs) -> np.ndarray:
    """The kernel's descriptor table (csrc/window_hash.cu, kSeg*) of the
    segments that have windows, in order."""
    rows, tile0 = [], 0
    for s in segs:
        if not s.n_win:
            continue
        rows.append((s.words.data_ptr(), s.live_win.data_ptr(),
                     s.live_base.data_ptr(), s.warp_seq.data_ptr(),
                     s.live_base.numel(), s.n_win, s.w, int(s.normalize),
                     s.out, tile0))
        tile0 += -(-s.n_win // TILE)
    return np.array(rows, np.int64).reshape(-1, _SEG_WORDS)


def _enqueue_segments(table: torch.Tensor, n_seg: int, n_tiles: int,
                      out: torch.Tensor):
    """Launches the segmented kernel on a descriptor table on the card into
    `out`, (2 n_total,) int64: h1 then h2. Does not wait for the card."""
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.window_hash_segments_launch(
            table.data_ptr(), n_seg, n_tiles, out.data_ptr(),
            out.numel() // 2, stream)
    if err != 0:
        raise RuntimeError("window hash kernel launch failed: "
                           + lib.window_hash_error_string(err).decode())
    _count_launch()


def _launch_segments(segs, n_total: int, table: torch.Tensor | None = None):
    """One launch over `segs` (a list of Seg on one CUDA device) into a new
    (2 n_total,) output. `table`: their descriptors already on the card
    (the request's copy holds them), else built and copied here."""
    live = [s for s in segs if s.n_win]
    out = torch.empty(2 * n_total, dtype=torch.int64,
                      device=segs[0].words.device)
    if table is None:
        table = torch.from_numpy(_descriptors(segs)).to(out.device)
    _enqueue_segments(table, len(live), _n_tiles(segs), out)
    return out


def _n_tiles(segs) -> int:
    return sum(-(-s.n_win // TILE) for s in segs)


def segment_starts(s: Seg) -> torch.Tensor:
    """The word at which each window of a segment starts, with torch ops:
    window t of the live sequence it falls in starts at live_base + t."""
    dev = s.live_base.device
    seq = torch.repeat_interleave(
        torch.arange(s.live_base.numel(), device=dev),
        s.live_win[1:] - s.live_win[:-1], output_size=s.n_win)
    return s.live_base[seq] + torch.arange(s.n_win, device=dev)


def hash_segments_reference(segs, n_total: int):
    """Plain torch version of the segmented mode: each segment's window
    starts from its tables with torch ops (`segment_starts`), the windows
    gathered, normalised and hashed as `hash_windows_reference` does."""
    dev = segs[0].words.device if segs else torch.device("cpu")
    out = torch.empty(2 * n_total, dtype=torch.int64, device=dev)
    for s in segs:
        if not s.n_win:
            continue
        starts = segment_starts(s)
        h1, h2 = _reference_fixed(s.words, starts, s.w, s.normalize)
        out[s.out:s.out + s.n_win] = h1
        out[n_total + s.out:n_total + s.out + s.n_win] = h2
    return out


def _check_segment(seg: Segment, device) -> tuple:
    """(lo, hi) of a valid segment on `device`, or ValueError."""
    st = seg.stream
    if not isinstance(st, Stream):
        raise ValueError(f"a segment's stream must be a Stream, got "
                         f"{type(st).__name__}")
    if isinstance(seg.w, bool) or not isinstance(seg.w, int) or \
            not 1 <= seg.w < 1 << 31:
        raise ValueError(f"window width must be an int >= 1, got {seg.w!r}")
    hi = len(st) if seg.hi is None else seg.hi
    if not (isinstance(seg.lo, int) and isinstance(hi, int)
            and 0 <= seg.lo <= hi <= len(st)):
        raise ValueError(f"segment [{seg.lo}, {hi}) is outside the stream's "
                         f"{len(st)} sequences")
    if st.device is not None and st.device != device:
        raise ValueError(f"a stream on {st.device} in a request on {device}")
    return seg.lo, hi


def _prepare(segments, device):
    """The request's host work and its one copy to `device`: (segs, the
    windows in all, the descriptor table on a CUDA device, else None). A
    bad segment raises ValueError here, before anything is launched."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no window hash kernel for device {device}")
    device = _device(device)
    bounds = [_check_segment(s, device) for s in segments]
    # host tables, and where each piece lies in the request's pack
    at = 0
    places = {}  # id(stream) -> slot of a stream not on the device
    for seg in segments:
        if seg.stream.device is None and id(seg.stream) not in places:
            places[id(seg.stream)] = at
            at += seg.stream._pack_words()
    plans, n_total = [], 0
    for seg, (lo, hi) in zip(segments, bounds):
        nwin = np.maximum(seg.stream.lens[lo:hi] - seg.w + 1, 0)
        win_off = np.zeros(hi - lo + 1, np.int64)
        np.cumsum(nwin, out=win_off[1:])
        n_win = int(win_off[-1])
        live = np.flatnonzero(nwin)
        live_win = np.append(win_off[live], n_win)
        live_base = seg.stream.offsets[lo + live] - win_off[live]
        warp_seq = np.searchsorted(live_win[:-1], np.arange(0, n_win, WARP),
                                   side="right") - 1
        tables = (win_off, live_win, live_base, warp_seq)
        plans.append((tables, at, n_total))
        at += sum(t.shape[0] for t in tables)
        n_total += n_win
    n_desc = sum(1 for p in plans if p[0][0][-1])  # segments with windows
    table_at = at
    host, dev = _staging(at + n_desc * _SEG_WORDS, device)
    pack = host.numpy()
    words = {}
    for seg in segments:
        key = id(seg.stream)
        if key in places and key not in words:
            words[key] = seg.stream._fill(pack, places[key], dev)
    segs = []
    for seg, (tables, p, out) in zip(segments, plans):
        views = []
        for t in tables:
            pack[p:p + t.shape[0]] = t
            views.append(dev[p:p + t.shape[0]])
            p += t.shape[0]
        segs.append(Seg(words.get(id(seg.stream), seg.stream.words), *views,
                        int(tables[0][-1]), seg.w, bool(seg.normalize), out))
    table = None
    if device.type == "cuda":
        pack[table_at:] = _descriptors(segs).reshape(-1)
        table = dev[table_at:]
    _upload(host, dev)
    return segs, n_total, table


def hash_segments(segments, device):
    """(h1, h2, window offsets) per segment: the hashes of every window of
    each of its sequences, in sequence then position order, and the (n +
    1,) int64 window offsets of its n sequences, all on `device`. One
    launch for all the segments on a CUDA device, none without windows; a
    bad segment raises ValueError before anything is launched."""
    segs, n_total, table = _prepare(segments, device)
    if not n_total:
        out = torch.zeros(0, dtype=torch.int64, device=device)
    elif table is not None:
        out = _launch_segments(segs, n_total, table)
    else:
        out = hash_segments_reference(segs, n_total)
    return [(out[s.out:s.out + s.n_win],
             out[n_total + s.out:n_total + s.out + s.n_win], s.win_off)
            for s in segs]
