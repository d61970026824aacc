"""The 99th percentile (nearest rank) of the latencies of all requests due
in the window, each from its scheduled arrival to its result; a request
shed, failed or never answered counts at the window's length."""
from bench.harness import nearest_rank


def read(rec):
    if rec["kind"] != "fleet":
        return None
    return nearest_rank(rec["latency_ms"], 99)
