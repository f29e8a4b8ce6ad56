"""toBasespace: of the window's device-idle time (the complement of the
profiler's busy intervals), the share in which the thread that runs a unit
had no span of the program open below the unit's `tobasespace` span, in
%. What it leaves is time no span names: between phases, between units."""

from ._spans import merged, named, overlap_ns, unit_root, window_records


def read(run):
    recs = window_records(run)
    if not named(recs, "tobasespace"):
        return None
    t = run.timeline
    by_id = {r.id: r for r in recs}
    covered = []
    for r in recs:
        root = unit_root(r, by_id)
        if root is not None and r.thread == root.thread:
            covered.append((max(r.start_ns, t.t0), min(r.end_ns, t.t1)))
    idle, prev = [], t.t0
    for s, e in t.busy_intervals():
        if s > prev:
            idle.append([prev, s])
        prev = max(prev, e)
    if t.t1 > prev:
        idle.append([prev, t.t1])
    idle_ns = sum(e - s for s, e in idle)
    if idle_ns == 0:
        return None
    return 100.0 * (idle_ns - overlap_ns(idle, merged(covered))) / idle_ns
