"""The median over the `moe` program spans (one a MoE layer, in prefill
and decode) of the most (token, expert) pairs a routed expert got over
the mean over the experts (`tokens_max` / `tokens_mean` tags): 1 is an
even load."""
from bench.spans import median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None:
        return None
    return median(s.tags["tokens_max"] / s.tags["tokens_mean"] for s in spans
                  if s.name == "moe" and s.tags.get("tokens_mean"))
