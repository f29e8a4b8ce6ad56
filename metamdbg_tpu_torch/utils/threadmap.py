"""Ordered map over threads, in ranges of items: the port's host fan-out.

The counterpart of metamdbg_tpu/utils/forkmap.py. Nothing forks: a process
that has started CUDA must not, and the native engines (native/*.cpp,
called through ctypes, which releases the interpreter lock for the length
of a call) run as well on N Python threads as on N forked workers. Each
wrapper packs its batch once, splits it into ranges of items (`ranges`),
and makes one engine call per range on one thread each (`thread_map`):
the engines' OpenMP loops are not used, so a box with libgomp and one
without run the same code.

Ranges are pulled from a shared counter (dynamic scheduling, as the
engines' own `schedule(dynamic, ...)` loops) and results are placed by
item index, so the result is `[fn(x) for x in items]` whatever the timing.
An exception in a worker is raised in the caller; there is no sequential
retry. A map called from inside a worker runs inline (its caller already
holds a thread).

`stage_pool(n)` opens one pool of n threads for a whole pipeline stage:
native/poa.cpp keeps its alignment workspaces `thread_local`, so threads
that live for the stage reuse them across every call of the stage, and
the memory goes back when the stage ends and its threads exit. A map
outside any stage opens a pool for its own call.

`packing(name)` adds the seconds a wrapper spends packing its batch in
Python (serial, under the interpreter lock) to the count `pack.<name>` of
the caller's innermost span (utils/spans.py); the stages log them beside
the engines' walls. Spans opened in a worker have the span that started
the map as their parent.
"""

import concurrent.futures
import contextlib
import threading

from . import spans

# ranges per thread: enough for dynamic scheduling to even out items of
# very different cost (one long POA window among short ones)
RANGES_PER_THREAD = 8

_stage: list = []            # the open stage pool, innermost last
_local = threading.local()   # .in_worker: this thread is running a map


def ranges(n_items: int, n_threads: int, min_size: int = 1):
    """[(lo, hi)] covering range(n_items) in order: one range when
    n_threads <= 1, else about RANGES_PER_THREAD per thread of at least
    min_size items."""
    if n_items <= 0:
        return []
    if n_threads <= 1:
        return [(0, n_items)]
    step = max(min_size, -(-n_items // (n_threads * RANGES_PER_THREAD)))
    return [(lo, min(lo + step, n_items)) for lo in range(0, n_items, step)]


@contextlib.contextmanager
def stage_pool(n_threads: int):
    """One pool of n_threads threads for every thread_map inside."""
    if n_threads <= 1:
        yield
        return
    with concurrent.futures.ThreadPoolExecutor(
            n_threads, thread_name_prefix="metamdbg_host") as pool:
        _stage.append(pool)
        try:
            yield
        finally:
            _stage.pop()


def packing(name: str) -> spans.timed:
    return spans.timed("pack." + name)


def thread_map(fn, items, n_threads: int):
    """[fn(x) for x in items] on n_threads threads, one item per pull from
    the shared counter (a wrapper's items are its ranges)."""
    items = items if isinstance(items, list) else list(items)
    n = min(int(n_threads), len(items))
    if n <= 1 or getattr(_local, "in_worker", False):
        return [fn(x) for x in items]

    out = [None] * len(items)
    counter = iter(range(len(items)))
    counter_lock = threading.Lock()
    failed = threading.Event()
    parent = spans.current()

    def work():
        _local.in_worker = True
        try:
            with spans.inherited(parent):
                while not failed.is_set():
                    with counter_lock:
                        i = next(counter, None)
                    if i is None:
                        return
                    out[i] = fn(items[i])
        except BaseException:
            failed.set()
            raise
        finally:
            _local.in_worker = False

    with contextlib.ExitStack() as stack:
        pool = _stage[-1] if _stage else stack.enter_context(
            concurrent.futures.ThreadPoolExecutor(n))
        futures = [pool.submit(work) for _ in range(n)]
        concurrent.futures.wait(futures)
        for f in futures:
            f.result()
    return out
