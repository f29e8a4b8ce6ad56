"""toBasespace: over the window, the highest VmRSS that a `tobasespace`
span of the program, or one of its spans that read VmRSS, read at close,
less the lowest that a `tobasespace` span read at open, in GB (kB / 2**20,
as `peak_rss_gb`)."""

from ._spans import named, unit_root, window_records


def read(run):
    recs = window_records(run)
    roots = [r for r in named(recs, "tobasespace") if r.rss_kb is not None]
    if not roots:
        return None
    by_id = {r.id: r for r in recs}
    closes = [r.rss_kb[1] for r in recs if r.rss_kb is not None
              and (r.name == "tobasespace"
                   or unit_root(r, by_id) is not None)]
    return (max(closes) - min(r.rss_kb[0] for r in roots)) / 1048576.0
