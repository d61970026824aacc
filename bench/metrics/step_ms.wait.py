"""Median milliseconds of the `device_wait` spans under `device_step`: the
step's synchronize with the card."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    d = median(durations(spans, "device_wait", parent="device_step")) if spans else None
    return None if d is None else 1e3 * d
