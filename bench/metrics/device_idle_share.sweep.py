"""Percent of the profiled window in which no operation ran on the card."""


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "sweep" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
