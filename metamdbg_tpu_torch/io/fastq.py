"""FASTA/FASTQ(.gz) reads over the native batch decoder (native/fastio.cpp).

Reads come in file order across one or more inputs, as the reference's
kseq parser gives them (src/Commons.hpp:5732-5850). Headers are not
decoded: every consumer only uses index, sequence and quality. Output:
`write_fasta` (contigs.fasta.gz) and `open_maybe_gzip`, copies of
metamdbg_tpu/io/fastq.py's.
"""

import dataclasses
import gzip
import queue
import threading

import numpy as np

from . import native


@dataclasses.dataclass
class Read:
    index: int
    seq: np.ndarray    # uint8 ascii
    qual: np.ndarray   # uint8 ascii, empty for fasta


def iter_reads(paths, max_reads: int | None = None):
    """Yields Read records. The native zlib decode (which releases the GIL)
    runs on a producer thread feeding a 2-deep queue, so decoding overlaps
    the consumer's compute."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in native.iter_read_batches(paths):
                if not _put(item):
                    return
            _put(None)
        except BaseException as exc:  # surfaced to the consumer
            _put(exc)

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
            for n, hq in zip(lengths.tolist(), has_qual.tolist()):
                if max_reads is not None and index >= max_reads:
                    return
                yield Read(index, seq_buf[off:off + n],
                           qual_buf[off:off + n] if hq else empty)
                index += 1
                off += n
    finally:
        stop.set()
        t.join()


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
