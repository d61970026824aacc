"""The median over decode steps of the `kda` program spans summed a step
(one a KDA layer, children of `lm_decode`), in milliseconds."""
from bench.spans import median, spans_of, summed_by_parent


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None:
        return None
    m = median(summed_by_parent(spans, "kda", "lm_decode"))
    return None if m is None else 1e3 * m
