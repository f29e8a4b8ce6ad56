"""Per-layer metric readers, one module per metric of `BENCHMARK.json`'s
`per_layer`, found by the metric's name. Each has `read(run)`, where `run`
has `timeline` (trace.Timeline of the window), `bases` (the window's input
bases) and `units` (the window's units). It returns the value, or None
where the window holds nothing to read. A reader may declare `SPANS`,
spans in the form of a cell file's, which the traced run installs beside
the cell's own."""


def per_gbp(run, span: str):
    """Host seconds in spans `span` per Gbp of the window's input, or None
    where no such span ran."""
    if not any(n == span for _, _, n in run.timeline.ranges):
        return None
    return run.timeline.span_seconds(span) / (run.bases / 1e9)
