"""Milliseconds of prefill a thousand prompt tokens: the `lm_prefill`
program spans' summed length over their prompt tokens (`tokens` tag),
times 1000."""
from bench.spans import spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None:
        return None
    pre = [s for s in spans if s.name == "lm_prefill"]
    tokens = sum(s.tags.get("tokens", 0) for s in pre)
    if not tokens:
        return None
    return 1e6 * sum(s.t_end - s.t_start for s in pre) / tokens
