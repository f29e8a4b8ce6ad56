"""Read selection: seconds in the program's `readselection.sketch` spans
(each chunk's homopolymer compression, base codes, K1 on the card and the
stitching of its rows) per Gbp of input reads."""

from ._spans import seconds_per_gbp, window_records


def read(run):
    return seconds_per_gbp(run, window_records(run), "readselection.sketch")
