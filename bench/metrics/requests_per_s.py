"""Requests answered within the cell's latency limit, over the window's
seconds.  A request shed, failed or answered late is not counted."""


def read(rec):
    if rec["kind"] != "fleet":
        return None
    return rec["answered_in_time"] / rec["seconds"]
