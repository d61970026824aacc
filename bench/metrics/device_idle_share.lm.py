"""Percent of the LM cell's profiled window (the replay and its drain) in
which no operation ran on the card."""


def read(rec):
    tr = rec["trace"]
    if rec.get("lm") is None or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
