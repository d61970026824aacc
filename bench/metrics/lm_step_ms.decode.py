"""The median length of the engine's decode steps (`lm_decode` program
spans: the step's layers, the lm head, the argmax and its copy back)."""
from bench.spans import durations, median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None:
        return None
    m = median(durations(spans, "lm_decode"))
    return None if m is None else 1e3 * m
