"""The 99th percentile (nearest rank) of the LM requests' time to first
token, from each request's due time to its first token read back; a
request never answered counts as infinite."""
from bench.harness import nearest_rank


def read(rec):
    lm = rec.get("lm")
    if lm is None:
        return None
    return nearest_rank(lm["ttft_ms"], 99)
