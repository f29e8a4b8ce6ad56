"""unitigGraph.* and kminmerData.* on-disk formats (byte-compatible).

The port of metamdbg_tpu/graph/gio.py (formats in its docstring, after
src/graph/CreateMdbg.cpp and src/Commons.hpp):
- kminmerData_min.txt: u32 minimizers[k] per record;
- kminmerData_abundance.txt: u128 hash (LE: low u64 = h2 first) + u32 count;
- unitigGraph.nodes.bin: u32 len, u32 seq[len], u32 unitigIndex;
- unitigGraph.edges.successors.bin: u32 fromIndex, u32 nSucc, u32 succ[],
  u32 nPred, u32 pred[];
- unitigGraph.nodes.abundances.bin: u32 unitigIndex, u32 n, u32 ab[n];
- unitigGraph.stats.bin: u64 nbNodes, u64 nbEdges.

Rows and counts come in as tensors on any device; the 128-bit keys of the
abundance files are hashed there by kernel KW (kernels/window_hash.py).
Readers return host numpy arrays, as the JAX package's do.
"""

import struct

import numpy as np
import torch

from ..kernels import window_hash


def write_kminmer_rows(path: str, rows: torch.Tensor):
    with open(path, "wb") as f:
        f.write(rows.cpu().numpy().astype(np.uint32).tobytes())


def key_bytes(h1: torch.Tensor, h2: torch.Tensor) -> np.ndarray:
    """(N, 16) uint8: each __uint128_t (h1<<64)|h2 in x86 little-endian."""
    return torch.stack([h2, h1], dim=1).cpu().numpy().view(np.uint8)


def hash128_bytes(rows: torch.Tensor) -> np.ndarray:
    """key_bytes of the 128-bit hash of each raw row."""
    return key_bytes(*window_hash.hash_rows(rows))


def write_abundance_records(path: str, keys: np.ndarray,
                            counts: torch.Tensor):
    """keys: (N, 16) uint8 from key_bytes; counts: one per key (u32)."""
    rec = np.empty((keys.shape[0], 20), np.uint8)
    rec[:, :16] = keys
    rec[:, 16:] = (counts.cpu().numpy().astype(np.uint32)[:, None]
                   .view(np.uint8))
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def write_kminmer_abundances(path: str, rows: torch.Tensor,
                             counts: torch.Tensor):
    write_abundance_records(path, hash128_bytes(rows), counts)


def read_kminmer_abundances(path: str):
    """Returns ((N,2) u64 [h1,h2] keys, u32 counts)."""
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8).reshape(-1, 20)
    h2 = raw[:, :8].copy().view(np.uint64).ravel()
    h1 = raw[:, 8:16].copy().view(np.uint64).ravel()
    counts = raw[:, 16:].copy().view(np.uint32).ravel()
    return np.stack([h1, h2], axis=1), counts


def write_unitig_nodes(path: str, sequences):
    with open(path, "wb") as f:
        for i, seq in enumerate(sequences):
            f.write(struct.pack("<I", seq.shape[0]))
            f.write(np.ascontiguousarray(seq, np.uint32).tobytes())
            f.write(struct.pack("<I", 2 * i))


def read_unitig_nodes(path: str):
    """Returns list of (sequence u32 array, unitigIndex)."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        seq = np.frombuffer(data, np.uint32, n, off)
        off += 4 * n
        (idx,) = struct.unpack_from("<I", data, off)
        off += 4
        out.append((seq, idx))
    return out


def write_unitig_edges(path: str, successors):
    """successors: list of 2U lists; record per unitig u: index 2u."""
    with open(path, "wb") as f:
        for u in range(len(successors) // 2):
            succ = np.asarray(successors[2 * u], np.uint32)
            pred = np.asarray(successors[2 * u + 1], np.uint32)
            f.write(struct.pack("<II", 2 * u, succ.shape[0]))
            f.write(succ.tobytes())
            f.write(struct.pack("<I", pred.shape[0]))
            f.write(pred.tobytes())


def read_unitig_edges(path: str):
    """Returns dict oriented_index -> sorted successor array (pred lists are
    folded into index^1 entries)."""
    with open(path, "rb") as f:
        data = f.read()
    out = {}
    off = 0
    while off < len(data):
        frm, ns = struct.unpack_from("<II", data, off)
        off += 8
        succ = np.frombuffer(data, np.uint32, ns, off)
        off += 4 * ns
        (npred,) = struct.unpack_from("<I", data, off)
        off += 4
        pred = np.frombuffer(data, np.uint32, npred, off)
        off += 4 * npred
        out[frm] = np.sort(succ)
        out[frm ^ 1] = np.sort(pred)
    return out


def write_unitig_abundances(path: str, abundances):
    with open(path, "wb") as f:
        for i, ab in enumerate(abundances):
            f.write(struct.pack("<II", 2 * i, ab.shape[0]))
            f.write(np.ascontiguousarray(ab, np.uint32).tobytes())


def read_unitig_abundances(path: str):
    with open(path, "rb") as f:
        data = f.read()
    out = []
    off = 0
    while off < len(data):
        idx, n = struct.unpack_from("<II", data, off)
        off += 8
        ab = np.frombuffer(data, np.uint32, n, off)
        off += 4 * n
        out.append((idx, ab))
    return out


def write_unitig_stats(path: str, nb_nodes: int, nb_edges: int):
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", nb_nodes, nb_edges))


def read_unitig_stats(path: str):
    with open(path, "rb") as f:
        return struct.unpack("<QQ", f.read(16))
