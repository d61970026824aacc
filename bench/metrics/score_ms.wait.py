"""Median milliseconds of the `device_wait` spans under `score`: the copy of
the window scores back, which waits for the frame's work on the card."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "sweep")
    d = median(durations(spans, "device_wait", parent="score")) if spans else None
    return None if d is None else 1e3 * d
