"""Percent of the card's dense bfloat16 peak that the Kimi Linear window's
useful FLOPs (every prefill and decode step the engine ran, `bench/work/
kimi_linear.py`) take over the replay's wall time."""
from bench.work import kimi_linear as W


def read(rec):
    lm = rec.get("lm")
    if lm is None or not rec["trace"] or "router_experts" not in lm["arch"]:
        return None
    return 100.0 * W.window_flops(lm["arch"], lm["work"]) / (lm["wall_s"] * W.PEAK_BF16)
