"""Median milliseconds of an engine step's `forward` span: the host's
dispatch of the step's launches and the gather of the scores."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    d = median(durations(spans, "forward")) if spans else None
    return None if d is None else 1e3 * d
