"""Percent of the engine steps' slots that held a real image, summed over
the replicas (`VisionEngine` counters `batches` and `padded_slots`)."""


def read(rec):
    if rec["kind"] != "fleet":
        return None
    slots = sum(e["batches"] * e["batch_size"] for e in rec["engines"])
    if not slots:
        return None
    return 100.0 * (slots - sum(e["padded_slots"] for e in rec["engines"])) / slots
