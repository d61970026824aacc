"""Percent of their roofline that the window's KDA kernels reached: each
call of `kda_chunk_prefill_kernel` and `kda_decode_step_kernel` at its
least time (the larger of its FLOPs over the card's float32 peak and its
bytes over the memory's rate, `bench/work/kimi_linear.py`), summed, over
the two kernels' device time."""
from bench.work import kimi_linear as W


def read(rec):
    lm = rec.get("lm")
    if lm is None or not rec["trace"] or not lm.get("kda_device"):
        return None
    device_s = sum(k["s"] for k in lm["kda_device"].values())
    if device_s <= 0:
        return None
    return 100.0 * W.kda_kernels_bound_s(lm["arch"], lm["work"], rec["peaks"]) / device_s
