"""toBasespace: seconds in the program's `polish.index` spans (the polish
passes' fragment index: each cut fragment filed into its window) per Gbp
of input reads."""

from ._spans import seconds_per_gbp, window_records


def read(run):
    return seconds_per_gbp(run, window_records(run), "polish.index")
