"""Binary record formats shared with the reference pipeline (byte-compatible).

Formats (little-endian throughout, matching x86 struct writes):

read_data_init.txt (ReadSelection.hpp:415-467), per read:
    u32 n, u8 is_circular, u32 minimizers[n], u32 pos[n], u8 dirs[n],
    u8 quals[n], f32 mean_read_quality, u32 read_length
read_data_corrected.txt (ReadSelection.hpp:1420-1426), per read:
    u32 n, u8 is_circular, u32 minimizers[n]          (no quality block)
read_stats.txt (ReadSelection.hpp:372-378):
    u64 nb_reads, u32 n50, f32 density, u64 nb_bases, f32 avg_quality,
    u32 mean_length, u64 nb_minimizers
repetitiveMinimizers.bin (ReadSelection.hpp:556-558): u32 minimizers[*]
parameters.gz (AssemblyPipeline.hpp:1479-1517 / Commons.hpp:1475-1497),
    gzip stream of: u64 minimizer_size, u64 kminmer_size, f32 density_assembly,
    u64 kminmer_size_first, f32 minimizer_spacing_mean, f32 kminmer_length_mean,
    f32 kminmer_overlap_mean, u64 kminmer_size_prev, u64 kminmer_size_last,
    u64 mean_read_length, f32 density_correction, u8 use_hpc (bool),
    i32 data_type, u64 snpmer_size
"""

import dataclasses
import gzip
import struct

import numpy as np


@dataclasses.dataclass
class MinimizerRead:
    """One read in minimizer space."""
    index: int
    minimizers: np.ndarray           # u32[n]
    positions: np.ndarray | None     # u32[n] (kmer index in RLE coords)
    directions: np.ndarray | None    # u8[n]
    qualities: np.ndarray | None     # u8[n]
    mean_quality: float = 0.0
    read_length: int = 0             # original (non-RLE) base length
    is_circular: bool = False


class ReadDataWriter:
    """Streams read records; with_quality selects the init/corrected layout."""

    def __init__(self, path: str, with_quality: bool):
        self._f = open(path, "wb", buffering=1 << 20)
        self._with_quality = with_quality

    def write(self, read: MinimizerRead):
        n = int(read.minimizers.shape[0])
        parts = [struct.pack("<IB", n, 1 if read.is_circular else 0),
                 np.ascontiguousarray(read.minimizers, dtype=np.uint32).tobytes()]
        if self._with_quality:
            parts.append(np.ascontiguousarray(read.positions, dtype=np.uint32).tobytes())
            parts.append(np.ascontiguousarray(read.directions, dtype=np.uint8).tobytes())
            parts.append(np.ascontiguousarray(read.qualities, dtype=np.uint8).tobytes())
            parts.append(struct.pack("<fI", np.float32(read.mean_quality),
                                     read.read_length))
        self._f.write(b"".join(parts))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_read_data(path: str, with_quality: bool):
    """Yields MinimizerRead records from a read_data*.txt file."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    index = 0
    nbytes = len(data)
    while off < nbytes:
        n, circ = struct.unpack_from("<IB", data, off)
        off += 5
        mins = np.frombuffer(data, np.uint32, n, off); off += 4 * n
        pos = dirs = quals = None
        mq = 0.0
        rl = 0
        if with_quality:
            pos = np.frombuffer(data, np.uint32, n, off); off += 4 * n
            dirs = np.frombuffer(data, np.uint8, n, off); off += n
            quals = np.frombuffer(data, np.uint8, n, off); off += n
            mq, rl = struct.unpack_from("<fI", data, off); off += 8
        yield MinimizerRead(index, mins, pos, dirs, quals, mq, rl, bool(circ))
        index += 1


@dataclasses.dataclass
class ReadStats:
    nb_reads: int
    n50: int
    density: float
    nb_bases: int
    avg_quality: float
    mean_length: int
    nb_minimizers: int

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(struct.pack("<QI", self.nb_reads, self.n50))
            f.write(struct.pack("<f", np.float32(self.density)))
            f.write(struct.pack("<Q", self.nb_bases))
            f.write(struct.pack("<f", np.float32(self.avg_quality)))
            f.write(struct.pack("<IQ", self.mean_length, self.nb_minimizers))

    @classmethod
    def load(cls, path: str):
        with open(path, "rb") as f:
            data = f.read()
        nb_reads, n50 = struct.unpack_from("<QI", data, 0)
        density, = struct.unpack_from("<f", data, 12)
        nb_bases, = struct.unpack_from("<Q", data, 16)
        avg_quality, = struct.unpack_from("<f", data, 24)
        mean_length, nb_minimizers = struct.unpack_from("<IQ", data, 28)
        return cls(nb_reads, n50, density, nb_bases, avg_quality, mean_length,
                   nb_minimizers)


def save_repetitive_minimizers(path: str, minimizers: np.ndarray):
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(minimizers, dtype=np.uint32).tobytes())


def load_repetitive_minimizers(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), dtype=np.uint32)
    except FileNotFoundError:
        return np.zeros(0, dtype=np.uint32)


@dataclasses.dataclass
class Parameters:
    minimizer_size: int = 15
    kminmer_size: int = 4
    density_assembly: float = 0.005
    kminmer_size_first: int = 4
    minimizer_spacing_mean: float = 0.0
    kminmer_length_mean: float = 0.0
    kminmer_overlap_mean: float = 0.0
    kminmer_size_prev: int = 0
    kminmer_size_last: int = 0
    mean_read_length: int = 0
    density_correction: float = 0.025
    use_homopolymer_compression: bool = True
    data_type: int = 0
    snpmer_size: int = 21

    def save(self, path: str):
        payload = struct.pack(
            "<QQfQfffQQQf?iQ",
            self.minimizer_size, self.kminmer_size,
            np.float32(self.density_assembly), self.kminmer_size_first,
            np.float32(self.minimizer_spacing_mean),
            np.float32(self.kminmer_length_mean),
            np.float32(self.kminmer_overlap_mean),
            self.kminmer_size_prev, self.kminmer_size_last,
            self.mean_read_length, np.float32(self.density_correction),
            self.use_homopolymer_compression, self.data_type, self.snpmer_size)
        with gzip.open(path, "wb") as f:
            f.write(payload)

    @classmethod
    def load(cls, path: str):
        with gzip.open(path, "rb") as f:
            data = f.read()
        vals = struct.unpack_from("<QQfQfffQQQf?iQ", data, 0)
        return cls(*vals)
