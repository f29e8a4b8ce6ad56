"""Read-selection quality model (src/readSelection/ReadSelection.hpp).

- the phred -> error-rate float32 table (Utils::transformQuality,
  src/Commons.hpp:2338) that the native read filters consume
  (sketch/native_sketch.py);
- per-minimizer quality: min base quality over the minimizer's original-
  coordinate span [rle_pos[p], rle_pos[p+l]) (ReadSelection.hpp:1302-1321);
  reads without quality strings get quality 1 per minimizer.
"""

import numpy as np

# float32 phred->error table, indexed by raw quality byte (ReadSelection.hpp:101-104)
_QUAL_TABLE = np.zeros(256, dtype=np.float32)
for _q in range(33, 128):
    _QUAL_TABLE[_q] = np.float32(10.0) ** np.float32(-(_q - 33) / 10.0)


def minimizer_min_qualities(qual_bytes: np.ndarray, rle_positions: np.ndarray,
                            positions: np.ndarray, l: int) -> np.ndarray:
    """u8 min quality per minimizer span (ReadSelection.hpp:1135,1302-1321)."""
    positions = np.asarray(positions, dtype=np.int64)
    if qual_bytes is None or np.asarray(qual_bytes).size == 0:
        return np.ones(positions.shape[0], dtype=np.uint8)
    qual_bytes = np.asarray(qual_bytes, dtype=np.uint8)
    q = qual_bytes.astype(np.int32) - 33
    rp = np.asarray(rle_positions, dtype=np.int64)
    starts = rp[positions]
    ends = rp[positions + l]
    # span minimum via one reduceat over interleaved (start, end-1) bounds:
    # segment 2i covers [start_i, end_i-1) (reduceat returns q[start] when
    # the pair is equal, i.e. a length-1 span), then fold in q[end_i-1].
    out = np.full(positions.shape[0], 255, dtype=np.uint8)
    nz = np.flatnonzero(ends > starts)
    if nz.size:
        s = starts[nz]
        e = ends[nz]
        inds = np.empty(2 * nz.size, np.int64)
        inds[0::2] = s
        inds[1::2] = e - 1
        red = np.minimum.reduceat(q, inds)[0::2]
        out[nz] = np.minimum(red, q[e - 1]).astype(np.uint8)
    return out
