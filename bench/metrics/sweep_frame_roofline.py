"""Percent of its roofline that the frames' sweeps reached: the least time
of every swept frame's work (the frame read once, the window scores
written once, the trunk's and the window head's operations over the
configuration's peak, `bench/work/`) over the device time of every
kernel that the window launched."""
from bench.work import peaks as P
from bench.work.smallnet import sweep_frame_work


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "sweep" or not tr or tr["kernel_s"] <= 0:
        return None
    H, W = rec["frame_shape"]
    nbytes, ops = sweep_frame_work(H, W, rec["n_windows"])
    dtype = rec["config"]["arithmetic"]
    return 100.0 * rec["frames_swept"] * P.bound_s(nbytes, ops, dtype, rec["peaks"]) / tr["kernel_s"]
