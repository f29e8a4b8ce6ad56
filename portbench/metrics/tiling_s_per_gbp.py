"""toBasespace: host seconds inside the span around the tiler's entry
(`basespace/tiling.create_base_contig`) per Gbp of input reads."""

from . import per_gbp


def read(run):
    return per_gbp(run, "tiling")
