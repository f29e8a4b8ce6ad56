"""Spans: the port's one timing mechanism.

A span is a context manager around one step of the program:

    with spans.span("polish.map") as s:
        ...
        s.add("alignments", n)
    log.info("map %.1fs", s.seconds)

It always measures its own duration (`seconds`), so the operator's log
lines keep their numbers. While recording is on it also keeps a record:
its name, `start_ns` and `end_ns` from `time.time_ns()` (the clock of
`torch.profiler`'s events, Unix-epoch nanoseconds), its thread, its parent
(the span open below it on the same thread, or the span that started a
`threadmap.thread_map` whose worker opened it), the root span its unit
began with, and its counts. Root spans, and spans opened with `rss=True`,
also carry VmRSS in kB at open and at close while recording.

A span's `counts` are of three kinds:
- `add(key, n)`, only while recording;
- the seconds of each `timed(key)` block run inside the span, recording
  or not (the native engines' calls and the packing of their batches,
  which run once per call in hot loops and never open a span of their own);
- the seconds of each child span, under the child's name, recording or
  not, summed over the children of one name.

Recording is on exactly while a `torch.profiler` session is open in the
process, or after `record_all()` (`asm --trace-out`). Recording off, a
span costs two clock reads, one flag read, a push and pop on its
thread's stack and one count on its parent, and keeps nothing. Records stay in memory: `records()`
returns them, and `write_chrome_trace` writes them out. The spans are no
`record_function` ranges: those are not captured from the host fan-out's
worker threads, and the profiler mirrors a range around device work onto
the device's timeline, where it would read as device time.
"""

import itertools
import json
import os
import threading
import time

import torch.autograd.profiler as _autograd_profiler

_all = [False]               # record_all() was called
_records: list = []          # closed spans kept while recording
_lock = threading.Lock()     # counts and the record list
_ids = itertools.count(1)
_local = threading.local()   # .stack: the open spans, innermost last


def recording() -> bool:
    """Whether spans keep records now."""
    return _all[0] or _autograd_profiler._is_profiler_enabled


def record_all():
    """Keep records from now on, with or without a profiler session."""
    _all[0] = True


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current():
    """The innermost open span of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def status_kb(field: str):
    """A `kB` field of /proc/self/status, or None where it has none."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    return None


class span:
    """A span named `name`; see the module's docstring. With `rss`, it
    reads VmRSS at open and close while recording (a root span always
    does)."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "id", "parent",
                 "root", "counts", "rss_kb", "_rss", "_recorded",
                 "_parent_span")

    def __init__(self, name: str, rss: bool = False):
        self.name = name
        self.counts: dict = {}
        self.rss_kb = None    # (at open, at close) where read
        self._rss = rss

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self._parent_span = parent
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self._recorded = recording()
        if self._recorded:
            if self._rss or parent is None:
                self.rss_kb = (status_kb("VmRSS") or 0, 0)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack().pop()
        parent = self._parent_span
        self._parent_span = None
        if parent is not None:
            parent._count(self.name, self.seconds)
        if self._recorded:
            if self.rss_kb is not None:
                self.rss_kb = (self.rss_kb[0], status_kb("VmRSS") or 0)
            with _lock:
                _records.append(self)
        return False

    @property
    def seconds(self) -> float:
        """The span's duration, once it has closed."""
        return (self.end_ns - self.start_ns) / 1e9

    def add(self, key: str, n=1):
        """Adds `n` to the count `key` while recording."""
        if self._recorded:
            self._count(key, n)

    def _count(self, key, n):
        with _lock:
            self.counts[key] = self.counts.get(key, 0) + n


def add(key: str, n=1):
    """Adds `n` to the count `key` of this thread's innermost open span,
    while recording."""
    if recording():
        s = current()
        if s is not None:
            s.add(key, n)


class timed:
    """Adds the block's seconds to the count `key` of this thread's
    innermost open span, recording or not."""

    __slots__ = ("key", "_t0")

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        dt = (time.time_ns() - self._t0) / 1e9
        s = current()
        if s is not None:
            s._count(self.key, dt)
        return False


class inherited:
    """In a worker thread: spans opened inside have `parent` (a span of
    the thread that handed out the work) as their parent."""

    __slots__ = ("parent", "_saved")

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        self._saved = getattr(_local, "stack", None)
        _local.stack = [self.parent] if self.parent is not None else []
        return self

    def __exit__(self, *exc):
        _local.stack = self._saved
        return False


def records() -> list:
    """The records kept so far, in the order their spans closed."""
    with _lock:
        return list(_records)


def write_chrome_trace(path: str, recs=None):
    """The records as Chrome trace JSON: one complete (`X`) event a span,
    `ts` and `dur` in microseconds, `ts` since the Unix epoch (a
    `torch.profiler` trace holds its `ts` from its `baseTimeNanoseconds`),
    the thread's ident as `tid`, counts, ids and VmRSS as `args`."""
    recs = records() if recs is None else recs
    pid = os.getpid()
    events = []
    for r in recs:
        args = dict(r.counts, span_id=r.id, parent=r.parent, root=r.root)
        if r.rss_kb is not None:
            args.update(rss_kb_open=r.rss_kb[0], rss_kb_close=r.rss_kb[1])
        events.append({"name": r.name, "ph": "X", "pid": pid,
                       "tid": r.thread, "ts": r.start_ns / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
