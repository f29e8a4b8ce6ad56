"""toBasespace: the seconds of the tiling walk's read-vs-read overlaps,
the counts `pair_s` (the native pair overlaps) and `erroneous_s` (the
chimeric-read checks' batched overlaps) of the program's `tiling.walk`
spans, per Gbp of input reads."""

from ._spans import named, window_records


def read(run):
    walks = named(window_records(run), "tiling.walk")
    if not walks:
        return None
    seconds = sum(r.counts.get("pair_s", 0.0) + r.counts.get("erroneous_s",
                                                             0.0)
                  for r in walks)
    return seconds / (run.bases / 1e9)
