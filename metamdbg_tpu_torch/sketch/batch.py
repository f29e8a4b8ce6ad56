"""Batched minimizer sketching over packed read tiles (kernel K1).

Reads are packed back-to-back into (rows, TILE_LEN) u8 tiles separated by
l-1 invalid bases, so no window spans two reads; a read longer than a tile
is split into segments overlapping by l-1 bases (the window sets of
consecutive segments partition the read's windows exactly). Tiles go to
the device as plain u8 in batches of TILE_ROWS rows, where
kernels/sketch.py:sketch_tiles selects and compacts each row's minimizers.
Back on the host, segments are stitched per read, the reference's read-end
trim of `trim` windows (MinimizerParser::_trimBps, 1 by default,
src/utils/kmer/Kmer.hpp:1362,1395; 0 in GenerateGfa's unitig parse,
src/graph/GenerateGfa.hpp:366) is applied on read-local window indices, and
then the repetitive-minimizer blacklist (the selected set is ~density *
bases, so both are cheap).

`tile_batches` counts the batches sent to the sketcher. While spans
record (utils/spans.py), each launch adds the inputs of its bound to the
innermost open span: `k1_launches`, `k1_rows`, `k1_row_len` (the padded
row length), `k1_windows` (rows x windows a row) and `k1_cap` (the
compacted slots a row), each summed over the span's launches.
"""

import numpy as np
import torch

from ..constants import MINIMIZER_DTYPE
from ..kernels import sketch as ksketch
from ..utils import spans

TILE_LEN = 16384       # bases per row
TILE_ROWS = 512        # rows per kernel launch (8 Mbp)

tile_batches = 0


class BatchSketcher:
    """Sketches many reads at once on `device`.

    `repetitive` is a sorted u32 blacklist applied after compaction;
    `trim` windows at each end of a read are never selected (the port of
    metamdbg_tpu/sketch/minimizers.py:select_minimizers(..., trim=)).
    """

    def __init__(self, l: int, density: float, repetitive, device,
                 trim: int = 1):
        self.l = l
        self.density = float(density)
        self.trim = trim
        self.repetitive = repetitive if repetitive is not None and \
            repetitive.size else None
        self.device = torch.device(device)

    def _pack(self, codes_list, bad_list):
        """Concatenate reads into (n_rows, TILE_LEN) tiles.

        Returns (tiles u8, segments) where segments[i] is a list of
        (row, col_start, seg_len, read_base_offset) for read i.
        """
        l = self.l
        sep = l - 1
        rows = [np.full(TILE_LEN, 4, np.uint8)]
        col = 0
        segments = [[] for _ in codes_list]

        def new_row():
            nonlocal col
            rows.append(np.full(TILE_LEN, 4, np.uint8))
            col = 0

        for i, codes in enumerate(codes_list):
            c = np.where(bad_list[i], 4, codes).astype(np.uint8)
            m = c.shape[0]
            off = 0
            while m - off > TILE_LEN:
                # long read: full-tile segment, next overlaps by l-1
                if col > 0:
                    new_row()
                rows[-1][:] = c[off: off + TILE_LEN]
                segments[i].append((len(rows) - 1, 0, TILE_LEN, off))
                new_row()
                off += TILE_LEN - (l - 1)
            rem = m - off
            if rem >= l:
                if col + rem > TILE_LEN:
                    new_row()
                rows[-1][col: col + rem] = c[off:]
                segments[i].append((len(rows) - 1, col, rem, off))
                col += rem + sep
                if col >= TILE_LEN:
                    new_row()
        return np.stack(rows), segments

    def _sketch_rows(self, tiles):
        """Per tile row: (positions i64, values u32, directions u8) of its
        selected windows, in ascending position order."""
        global tile_batches
        nk = TILE_LEN - self.l + 1
        cap = ksketch.compact_cap(nk, self.density)
        out = []
        for s in range(0, tiles.shape[0], TILE_ROWS):
            batch = torch.from_numpy(tiles[s: s + TILE_ROWS]).to(self.device)
            res = ksketch.sketch_tiles(batch, self.l, self.density, cap)
            tile_batches += 1
            if spans.recording():
                n = batch.shape[0]
                for key, v in (("k1_launches", 1), ("k1_rows", n),
                               ("k1_row_len", TILE_LEN),
                               ("k1_windows", n * nk), ("k1_cap", cap)):
                    spans.add(key, v)
            counts = res.counts.cpu().numpy()
            positions = res.positions.cpu().numpy()
            values = res.values.cpu().numpy()
            dirs = res.directions.cpu().numpy()
            over = {r: i for i, r in
                    enumerate(res.overflow_rows.cpu().tolist())}
            over_arrays = [x.cpu().numpy() for x in res.overflow]
            for r in range(batch.shape[0]):
                m = counts[r]
                if r in over:
                    p, v, d = (x[over[r]] for x in over_arrays)
                else:
                    p, v, d = positions[r], values[r], dirs[r]
                out.append((p[:m].astype(np.int64), v[:m], d[:m]))
        return out

    def sketch_many(self, codes_list, bad_list):
        """codes_list: list of u8 base-code arrays (RLE'd); bad_list: bool
        arrays marking non-ACGT bases. Returns a list of
        (minimizers u32, positions u32, directions u8), in input order."""
        tiles, segments = self._pack(codes_list, bad_list)
        rows = self._sketch_rows(tiles)

        out = []
        for i, segs in enumerate(segments):
            mins_parts, pos_parts, dir_parts = [], [], []
            for (row, col, seg_len, base_off) in segs:
                p, v, d = rows[row]
                lo = np.searchsorted(p, col)
                hi = np.searchsorted(p, col + seg_len - self.l, side="right")
                pos_parts.append(p[lo:hi] - col + base_off)
                mins_parts.append(v[lo:hi])
                dir_parts.append(d[lo:hi])
            if pos_parts:
                pos = np.concatenate(pos_parts)
                vals = np.concatenate(mins_parts).astype(MINIMIZER_DTYPE)
                dd = np.concatenate(dir_parts)
            else:
                pos = np.zeros(0, np.int64)
                vals = np.zeros(0, MINIMIZER_DTYPE)
                dd = np.zeros(0, np.uint8)
            # _trimBps: the first and last `trim` windows of the whole read
            # are never selected
            nk_read = codes_list[i].shape[0] - self.l + 1
            keep = (pos >= self.trim) & (pos < nk_read - self.trim)
            pos, vals, dd = pos[keep], vals[keep], dd[keep]
            if self.repetitive is not None and vals.size:
                j = np.searchsorted(self.repetitive, vals)
                j = np.minimum(j, self.repetitive.size - 1)
                keep = self.repetitive[j] != vals
                vals, pos, dd = vals[keep], pos[keep], dd[keep]
            out.append((vals, pos.astype(np.uint32), dd))
        return out
