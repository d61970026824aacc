"""Milliseconds of an engine step: the replicas' summed `busy_s` over their
summed `batches` (upload, the forward, the wait for the card)."""


def read(rec):
    if rec["kind"] != "fleet":
        return None
    steps = sum(e["batches"] for e in rec["engines"])
    if not steps:
        return None
    return 1e3 * sum(e["busy_s"] for e in rec["engines"]) / steps
