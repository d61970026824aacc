"""Microseconds of the router's own drain work a request served: the
`drain` spans' summed seconds less the engine spans that ran inside them
(`batch_form`, `device_step`, `finish`), over the engines' `request`
spans that ended served."""
from bench.spans import drain_self_s, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None:
        return None
    self_s = drain_self_s(spans)
    served = sum(1 for s in spans if s.name == "request" and s.status == "served")
    if self_s is None or not served:
        return None
    return 1e6 * self_s / served
