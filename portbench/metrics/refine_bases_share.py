"""toBasespace: the bases the refinement passes re-polished (the count
`bases` of the program's `polish` spans with `restricted`) over the bases
of every contig the full passes handed on (the count `polished_bases` of
the `tobasespace` spans), in the window, in %."""

from ._spans import named, window_records


def read(run):
    recs = window_records(run)
    scope = sum(r.counts.get("polished_bases", 0)
                for r in named(recs, "tobasespace"))
    if scope <= 0:
        return None
    refined = sum(r.counts.get("bases", 0) for r in named(recs, "polish")
                  if r.counts.get("restricted"))
    return 100.0 * refined / scope
