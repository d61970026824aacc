"""Percent of its roofline that the served steps reached: the least time of
the steps' work (the real images' pixels read and scores written once,
the params once a step, bytes over the memory's rate or operations over
the configuration's peak, `bench/work/`) over the device time of every
kernel the window launched.  The same bound whatever kernel runs the step."""
from bench.work import peaks as P
from bench.work.smallnet import served_step_work


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "fleet" or not tr or tr["kernel_s"] <= 0:
        return None
    eng = rec["engines"]
    images = sum(e["batches"] * e["batch_size"] - e["padded_slots"] for e in eng)
    steps = sum(e["batches"] for e in eng)
    dtype = rec["config"]["arithmetic"]
    nbytes, ops = served_step_work(images, steps, dtype)
    return 100.0 * P.bound_s(nbytes, ops, dtype, rec["peaks"]) / tr["kernel_s"]
