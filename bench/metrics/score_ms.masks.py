"""Median over frames of the milliseconds of a frame sweep's `masks` spans,
summed a frame: the params' preparation and each stage's eight masked
weights."""
from bench.spans import median, spans_of, summed_by_parent


def read(rec):
    spans = spans_of(rec, "sweep")
    d = median(summed_by_parent(spans, "masks", "score")) if spans else None
    return None if d is None else 1e3 * d
