"""The 99th percentile (nearest rank) of how late the benchmark's client
submitted each request against its schedule."""
from bench.harness import nearest_rank


def read(rec):
    if rec["kind"] != "fleet":
        return None
    return nearest_rank(rec["late_ms"], 99)
