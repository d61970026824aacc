"""Open-loop arrival schedules over independent streams, from a seed.

`poisson` is the homogeneous Poisson process conditioned on its count:
each of the `n_streams` streams places exactly round(rate * seconds /
n_streams) arrivals uniformly in [0, seconds), which is how a Poisson
process's arrivals lie once their number is given.  Every seed so offers
the same number of requests, in other places, and a run's offered load
does not move with the seed.  `bursty` is the program's interrupted
Poisson process (`streaming/loadgen.py` `LoadGen._times_bursty`, copied):
ON windows (mean `burst_on_s`) fire at rate / duty, OFF windows (mean
`burst_off_s`) are silent; its count varies with the seed.

Streams are merged and time-sorted, ties broken by stream.  NumPy only.
"""
from __future__ import annotations

import numpy as np

PROCESSES = ("poisson", "bursty")


def _poisson(rng, rate: float, seconds: float) -> np.ndarray:
    return rng.uniform(0.0, seconds, size=int(round(rate * seconds)))


def _bursty(rng, rate: float, seconds: float, burst_on_s: float,
            burst_off_s: float) -> np.ndarray:
    duty = burst_on_s / (burst_on_s + burst_off_s)
    rate_on = rate / duty
    out, t = [], 0.0
    on = bool(rng.uniform() < duty)
    while t < seconds:
        win = rng.exponential(burst_on_s if on else burst_off_s)
        if on:
            s = t + rng.exponential(1.0 / rate_on)
            while s < min(t + win, seconds):
                out.append(s)
                s += rng.exponential(1.0 / rate_on)
        t += win
        on = not on
    return np.asarray(out, np.float64)


def arrivals(process: str, rate_qps: float, seconds: float, *, n_streams: int,
             seed: int, burst_on_s: float = 0.25,
             burst_off_s: float = 0.75) -> np.ndarray:
    """Sorted arrival offsets in seconds, (n,) float64."""
    if process not in PROCESSES:
        raise ValueError(f"unknown process {process!r}; one of {PROCESSES}")
    per_stream = rate_qps / n_streams
    times, streams = [], []
    for s in range(n_streams):
        rng = np.random.default_rng([seed, s, 0xA221])
        t = (_poisson(rng, per_stream, seconds) if process == "poisson"
             else _bursty(rng, per_stream, seconds, burst_on_s, burst_off_s))
        times.append(t)
        streams.append(np.full(len(t), s))
    t, s = np.concatenate(times), np.concatenate(streams)
    return t[np.lexsort((s, t))]
