"""Median milliseconds of a frame sweep's `head` span: the window head's
launches and torch ops."""
from bench.spans import median, spans_of, summed_by_parent


def read(rec):
    spans = spans_of(rec, "sweep")
    d = median(summed_by_parent(spans, "head", "score")) if spans else None
    return None if d is None else 1e3 * d
