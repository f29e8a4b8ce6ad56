"""The program's own spans (`metamdbg_tpu_torch/utils/spans.py`) in the
traced window: the records of the spans that began inside it, kept by the
program while `torch.profiler` runs. A program without that recorder has
none, and the readers built on these helpers then give None."""


def window_records(run) -> list:
    try:
        from metamdbg_tpu_torch.utils import spans
    except ImportError:
        return []
    t = run.timeline
    return [r for r in spans.records() if t.t0 <= r.start_ns <= t.t1]


def named(recs, name: str) -> list:
    return [r for r in recs if r.name == name]


def unit_root(r, by_id: dict):
    """The nearest enclosing `tobasespace` span of `r` (r itself
    excluded), or None."""
    p = by_id.get(r.parent)
    while p is not None:
        if p.name == "tobasespace":
            return p
        p = by_id.get(p.parent)
    return None


def seconds_per_gbp(run, recs, name: str):
    """Seconds in spans `name` per Gbp of the window's input, or None
    where no such span ran."""
    found = named(recs, name)
    if not found:
        return None
    return sum((r.end_ns - r.start_ns) / 1e9 for r in found) \
        / (run.bases / 1e9)


def merged(intervals) -> list:
    """Sorted disjoint [start, end] lists covering `intervals`."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        elif t > s:
            out.append([s, t])
    return out


def overlap_ns(a, b) -> int:
    """The length both sorted disjoint interval lists cover."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
