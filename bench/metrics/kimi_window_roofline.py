"""Percent of its roofline that the Kimi Linear window's work reached: each
prefill and each decode step at its least time (the larger of its useful
FLOPs over the bfloat16 peak and its bytes over the memory's rate,
`bench/work/kimi_linear.py`), summed, over the device time of every
kernel the window launched."""
from bench.work import kimi_linear as W


def read(rec):
    tr, lm = rec["trace"], rec.get("lm")
    if lm is None or not tr or tr["kernel_s"] <= 0 or "router_experts" not in lm["arch"]:
        return None
    bound = W.window_bound_s(lm["arch"], lm["work"], rec["peaks"]["hbm_bytes_per_s"])
    return 100.0 * bound / tr["kernel_s"]
