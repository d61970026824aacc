"""Percent of the card's peak that the delivered frames' sweeps' operations
(`bench/work/`) would take over the window that `frames_per_s` reads."""
from bench.work.smallnet import sweep_frame_work


def read(rec):
    if rec["kind"] != "sweep" or not rec["trace"] or not rec["frames_done"]:
        return None
    H, W = rec["frame_shape"]
    ops = rec["frames_done"] * sweep_frame_work(H, W, rec["n_windows"])[1]
    dtype = rec["config"]["arithmetic"]
    return 100.0 * ops / (rec["seconds"] * rec["peaks"][dtype])
