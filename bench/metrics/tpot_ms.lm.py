"""The median over the LM requests of the time per output token: from a
request's first token to its last, over the gaps between them (requests
of one token left out)."""
import statistics


def read(rec):
    lm = rec.get("lm")
    if lm is None:
        return None
    ms = [float(v) for v, n in zip(lm["tpot_ms"], lm["n_tokens"]) if n > 1]
    return statistics.median(ms) if ms else None
