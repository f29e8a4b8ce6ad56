"""The traced run: spans from the benchmark's own wrappers, and the
device's timeline from `torch.profiler`, reduced to what the per-layer
readers and the result's `breakdown` need.

A span wraps one function of the program (`module:attribute`, named in
the cell's file) for the traced run only: a `record_function` range named
`pb:<span>`, so that spans and device work lie on the profiler's one
clock.
"""

import contextlib
import functools
import importlib


WINDOW = "pb:window"
UNIT = "pb:unit"


class Spans:
    """Installs the cell's span wrappers."""

    def __init__(self, specs):
        self.specs = specs
        self._undo = []

    def install(self):
        from torch.profiler import record_function

        for spec in self.specs:
            mod_name, attr = spec["target"].split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            name = "pb:" + spec["name"]

            def wrapper(*args, _fn=fn, _name=name, **kwargs):
                with record_function(_name):
                    return _fn(*args, **kwargs)

            functools.update_wrapper(wrapper, fn)
            setattr(mod, attr, wrapper)
            self._undo.append((mod, attr, fn))

    def remove(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the CPU and the card, or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _device_type(e) -> str:
    return str(e.device_type()).split(".")[-1]


def _start_end(e):
    start = e.start_ns()
    return start, start + e.duration_ns()


class Timeline:
    """The traced window: annotated host ranges, and device intervals."""

    def __init__(self, prof):
        self.ranges = []      # (start, end, name) of pb: annotations, ns
        device = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            kind = _device_type(e)
            if kind == "CPU" and name.startswith("pb:"):
                self.ranges.append((*_start_end(e), name[3:]))
            elif kind == "CUDA" and not name.startswith("pb:"):
                # (the profiler mirrors each annotation on the device's
                # timeline; those are no device work)
                device.append(e)
        window = [r for r in self.ranges if r[2] == WINDOW[3:]]
        if not window:
            raise RuntimeError("the trace holds no window")
        self.t0, self.t1 = window[0][0], window[0][1]
        self.device = []      # (start, end, name)
        for e in device:
            s, t = _start_end(e)
            if t > self.t0 and s < self.t1:
                self.device.append((max(s, self.t0), min(t, self.t1),
                                    e.name()))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        merged = []
        for s, t, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def span_seconds(self, name: str) -> float:
        """Host seconds inside spans `name`, nested ones counted once."""
        total, end = 0, 0
        for s, t, n in sorted(self.ranges):
            if n == name and t > end:
                total += t - max(s, end)
                end = t
        return total / 1e9

    def _named(self, at: int) -> str:
        """The spans around host time `at`, outer to inner."""
        inside = [(s, n) for s, t, n in self.ranges
                  if s <= at < t and n not in (WINDOW[3:],)]
        return " / ".join(n for _, n in sorted(inside)) or "between units"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for s, t, name in self.device:
            by_name[name] = by_name.get(name, 0) + (t - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for s, t in self.busy_intervals() + [[self.t1, self.t1]]:
            if s > prev:
                gaps.append((s - prev, prev + (s - prev) // 2))
            prev = max(prev, t)
        gaps.sort(reverse=True)
        return {"device_ops": [[n[:64], v / 1e9] for n, v in ops],
                "idle_gaps": [[self._named(mid), g / 1e9]
                              for g, mid in gaps[:top]]}
