"""toBasespace: host seconds inside the span around the polish passes'
window POA (`basespace/poa_native.polish_windows`) per Gbp of input
reads."""

from . import per_gbp


def read(run):
    return per_gbp(run, "polish_poa")
