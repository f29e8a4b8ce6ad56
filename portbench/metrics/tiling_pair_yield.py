"""toBasespace: of the read-vs-read overlaps the tiling walk computed
(`pair_calls` less `pair_cache_hits` of the program's `tiling.walk`
spans), the share that extended a path (`successors_accepted`), in %."""

from ._spans import named, window_records


def read(run):
    walks = named(window_records(run), "tiling.walk")
    computed = sum(r.counts.get("pair_calls", 0)
                   - r.counts.get("pair_cache_hits", 0) for r in walks)
    if computed <= 0:
        return None
    accepted = sum(r.counts.get("successors_accepted", 0) for r in walks)
    return 100.0 * accepted / computed
