"""Median over frames of the milliseconds of a frame sweep's `trunk` spans,
summed a frame: the frame's upload and the trunk's launches, which the
masks of each stage split into several spans."""
from bench.spans import median, spans_of, summed_by_parent


def read(rec):
    spans = spans_of(rec, "sweep")
    d = median(summed_by_parent(spans, "trunk", "score")) if spans else None
    return None if d is None else 1e3 * d
