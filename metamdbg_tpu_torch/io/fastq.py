"""FASTA/FASTQ(.gz) reads over the native batch decoder (native/fastio.cpp).

Reads come in file order across one or more inputs, as the reference's
kseq parser gives them (src/Commons.hpp:5732-5850). Headers are not
decoded: read selection only uses index, sequence and quality.
"""

import dataclasses
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
