"""Median milliseconds of an engine step's `finish` span: the copy back,
`predict` and the results published to the waiting clients."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    d = median(durations(spans, "finish")) if spans else None
    return None if d is None else 1e3 * d
