"""Percent of the card's peak that the answered images' useful operations
(`bench/work/`) would take over the window: int32 (derived) for Qm.n,
float32 for PLAN."""
from bench.work.smallnet import image_ops


def read(rec):
    if rec["kind"] != "fleet" or not rec["trace"]:
        return None
    dtype = rec["config"]["arithmetic"]
    ops = rec["answered"] * image_ops(dtype)
    return 100.0 * ops / (rec["seconds"] * rec["peaks"][dtype])
