"""FASTA/FASTQ(.gz) streaming parser (kseq-equivalent, host side).

The reference parses reads with htslib's kseq over gzip streams
(src/Commons.hpp:82, ReadParserParallel src/Commons.hpp:5732-5850) in file
order across one or more input files listed in tmp/input.txt. This parser
reproduces that ordering and tolerates multi-line FASTA, FASTQ, and mixed
inputs.
"""

import dataclasses
import gzip
import os

import numpy as np


@dataclasses.dataclass
class Read:
    index: int
    header: str
    seq: np.ndarray    # uint8 ascii
    qual: np.ndarray   # uint8 ascii, empty for fasta


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_reads(paths, max_reads: int | None = None,
               need_headers: bool = True):
    """Yields Read records over one or more fasta/fastq[.gz] files.

    With need_headers=False the native C++ batch decoder (native/fastio.cpp
    via io/native.py) is used when available: it zlib-decodes and splits
    records off the Python heap and returns flat buffers that are sliced
    into the same Read views (headers empty). Sequence/quality bytes are
    identical to the Python parser (tests/test_native_io.py); every hot
    consumer (read selection, correction re-sketch, partition routing)
    only uses index/seq/qual.
    """
    if not need_headers:
        from . import native
        if native.available():
            yield from _iter_reads_native(paths, max_reads)
            return
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    index = 0
    empty = np.zeros(0, dtype=np.uint8)
    for path in paths:
        with _open(str(path)) as f:
            header = None
            seq_parts = []
            is_fastq = False
            line = f.readline()
            while line:
                if max_reads is not None and index >= max_reads:
                    return
                line = line.rstrip(b"\r\n")
                if line.startswith(b"@"):          # fastq record
                    header = line[1:].decode()
                    seq = f.readline().rstrip(b"\r\n")
                    f.readline()                    # +
                    qual = f.readline().rstrip(b"\r\n")
                    yield Read(index, header,
                               np.frombuffer(seq, dtype=np.uint8),
                               np.frombuffer(qual, dtype=np.uint8))
                    index += 1
                    line = f.readline()
                elif line.startswith(b">"):        # fasta record (multi-line)
                    header = line[1:].decode()
                    seq_parts = []
                    line = f.readline()
                    while line and not line.startswith(b">") and not line.startswith(b"@"):
                        seq_parts.append(line.rstrip(b"\r\n"))
                        line = f.readline()
                    yield Read(index, header,
                               np.frombuffer(b"".join(seq_parts), dtype=np.uint8),
                               empty)
                    index += 1
                else:
                    line = f.readline()


def _iter_reads_native(paths, max_reads: int | None):
    """Decode-ahead: the native zlib decode (which releases the GIL)
    runs on a producer thread feeding a 2-deep queue, so IO overlaps the
    consumer's compute — the synchronous decode was ~25%% of
    readSelection at metagenome scale."""
    import queue
    import threading

    from . import native

    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def _produce():
        try:
            for item in native.iter_read_batches(paths):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            item = None
        except BaseException as exc:  # surfaced to the consumer
            item = exc
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=_produce, daemon=True,
                         name="fastq-native-prefetch")
    t.start()
    index = 0
    empty = np.zeros(0, dtype=np.uint8)
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            seq_buf, qual_buf, lengths, has_qual = item
            off = 0
            for L, hq in zip(lengths.tolist(), has_qual.tolist()):
                if max_reads is not None and index >= max_reads:
                    return
                yield Read(index, "", seq_buf[off:off + L],
                           qual_buf[off:off + L] if hq else empty)
                index += 1
                off += L
    finally:
        stop.set()


def open_maybe_gzip(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode, compresslevel=1)
    return open(path, mode)


def write_fasta(path: str, records, gzipped: bool | None = None):
    """records: iterable of (header, sequence-str-or-bytes)."""
    if gzipped is None:
        gzipped = path.endswith(".gz")
    # level 1 like the reference's bgzf "w1" (ToBasespace2.hpp:456)
    opener = (lambda p, m: gzip.open(p, m, compresslevel=1)) if gzipped \
        else open
    with opener(path, "wb") as f:
        for header, seq in records:
            if isinstance(seq, str):
                seq = seq.encode()
            f.write(b">" + header.encode() + b"\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + b"\n")
