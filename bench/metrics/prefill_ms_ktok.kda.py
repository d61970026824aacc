"""The median over prefills of the `kda` program spans summed a prefill
(one a KDA layer, children of `lm_prefill`) over its prompt tokens
(`tokens` tag), in milliseconds a thousand tokens."""
from bench.spans import median, spans_of


def read(rec):
    spans = spans_of(rec, "fleet")
    if spans is None:
        return None
    pre = {s.span_id: s.tags.get("tokens", 0) for s in spans if s.name == "lm_prefill"}
    kda = {}
    for s in spans:
        if s.name == "kda" and s.parent_id in pre:
            kda[s.parent_id] = kda.get(s.parent_id, 0.0) + s.t_end - s.t_start
    return median(1e6 * t / pre[p] for p, t in kda.items() if pre[p])
