"""Median milliseconds of an engine step's `upload` span: the padded batch,
its rows and the copy to the card."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    d = median(durations(spans, "upload")) if spans else None
    return None if d is None else 1e3 * d
