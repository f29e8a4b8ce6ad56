"""toBasespace: seconds in the program's refinement passes (its `polish`
spans with the count `restricted`) per Gbp of input reads. For ONT the
refinement re-polishes every changed contig whole; for HiFi, margins
around the changed intervals."""

from ._spans import named, window_records


def read(run):
    refines = [r for r in named(window_records(run), "polish")
               if r.counts.get("restricted")]
    if not refines:
        return None
    return sum((r.end_ns - r.start_ns) / 1e9 for r in refines) \
        / (run.bases / 1e9)
