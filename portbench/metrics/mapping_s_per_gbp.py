"""toBasespace: seconds in the program's `tobasespace.map` spans (the
read-vs-contig mapping, its chain DP on K3) per Gbp of input reads."""

from ._spans import seconds_per_gbp, window_records


def read(run):
    return seconds_per_gbp(run, window_records(run), "tobasespace.map")
