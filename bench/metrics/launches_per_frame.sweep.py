"""Median of the `launches` tag of the `score` spans: the csrc kernel
launches of one frame's sweep."""
from bench.spans import median, spans_of


def read(rec):
    spans = spans_of(rec, "sweep")
    if spans is None:
        return None
    return median(s.tags["launches"] for s in spans
                  if s.name == "score" and "launches" in s.tags)
