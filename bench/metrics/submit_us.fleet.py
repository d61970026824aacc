"""Median microseconds of the router's `submit`: its `dispatch` spans, one
a request, over the whole call (lock waits included).  A program with no
`drain` spans predates the dispatch span over the call (its `dispatch`
was a point) and reads None."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None or not any(s.name == "drain" for s in spans):
        return None
    return 1e6 * median(durations(spans, "dispatch"))
