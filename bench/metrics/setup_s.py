"""Seconds from the start of the run to the window: kernels built or
loaded, params and traffic made from the seed, the reference's threshold,
the cell's shapes warmed."""


def read(rec):
    return rec["setup_s"]
