"""Open-loop traffic generation: seeded arrival processes over N streams.

Port of `repro.streaming.loadgen`, numpy only: equal arguments give the
reference's schedules and images byte for byte (the glyph helpers come
from the port's own copy of `synth_mnist`).

The paper's deployment discipline is open-loop — the camera emits pixels on
ITS clock, not the fabric's, and a slow stage costs frames.  Production
serving is the same game at fleet scale: requests arrive on the users'
clock regardless of server state, so a harness that waits for the server
(closed-loop) can never expose overload behavior.  `LoadGen` models that
load: N concurrent synthetic request streams, each an independent seeded
arrival process, merged into one deterministic schedule.

Arrival processes (per stream, aggregate rate `rate_qps` split evenly):

  poisson   homogeneous Poisson — i.i.d. exponential inter-arrival gaps;
            the memoryless baseline every queueing result assumes.
  bursty    Markov-modulated on/off (interrupted Poisson): each stream
            alternates exponential ON bursts (mean `burst_on_s`) firing at
            `rate / duty` and silent OFF gaps (mean `burst_off_s`).  The
            duty-cycle normalization keeps the AVERAGE rate equal to the
            Poisson case — same offered load, far spikier, so it stresses
            admission control where the mean-rate process would not.
  diurnal   inhomogeneous Poisson whose rate ramps sinusoidally between
            `diurnal_floor * peak` and `peak` over `duration_s` (one
            trough->peak->trough "day"), realized by thinning a
            peak-rate Poisson process — the textbook exact sampler.

Determinism contract (the `SyntheticVideoSource` idiom): every draw comes
from `np.random.default_rng` seeded by (seed, stream, role), so
`schedule()` and `images()` are pure functions of the constructor
arguments — two LoadGens with equal args emit byte-identical workloads,
regardless of wall clock, interleaving, or how often you call them.

`schedule()` returns the merged, time-sorted arrivals; `replay()` plays
them against a `submit` callback in real time (chunked ticks: wake every
~2 ms and submit EVERYTHING due, so a fast batched server can be driven at
rates far beyond one Python call per request).  Open-loop stamping: pass
each arrival's SCHEDULED time as the submit timestamp so latency and
deadlines measure from intended arrival, not generator lag.

Usage:

    gen = LoadGen(process="bursty", rate_qps=500, duration_s=4,
                  n_streams=8, seed=7)
    eng.start()
    t0 = time.perf_counter()
    gen.replay(lambda a, t: eng.submit(gen.image(a), t_submit=t))
    eng.stop()
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.data.synth_mnist import _glyph_array, _smooth

PROCESSES = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: WHEN it arrives (seconds from epoch start),
    which stream emitted it, and what the image will contain."""
    uid: int                      # schedule-order index, ties broken by stream
    stream: int
    t: float                      # offset from replay start, seconds
    label: int                    # digit the rendered image contains


class LoadGen:
    """Deterministic open-loop arrival-process generator over N streams."""

    def __init__(self, *, process: str = "poisson", rate_qps: float = 100.0,
                 duration_s: float | None = None, n_requests: int | None = None,
                 n_streams: int = 4, seed: int = 0,
                 burst_on_s: float = 0.25, burst_off_s: float = 0.75,
                 diurnal_floor: float = 0.1):
        if process not in PROCESSES:
            raise ValueError(f"unknown process {process!r}; one of {PROCESSES}")
        if (duration_s is None) == (n_requests is None):
            raise ValueError("give exactly one of duration_s / n_requests")
        if rate_qps <= 0:
            raise ValueError("rate_qps must be > 0")
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if not (0.0 < diurnal_floor <= 1.0):
            raise ValueError("diurnal_floor must be in (0, 1]")
        self.process = process
        self.rate_qps = float(rate_qps)
        # fixed-count mode sizes the window so MEAN load is rate-invariant:
        # n requests at rate r occupy n/r seconds — a 2x-capacity overload
        # run takes the same wall time as a half-capacity one
        self.duration_s = (float(duration_s) if duration_s is not None
                           else n_requests / self.rate_qps)
        self.n_streams = int(n_streams)
        self.seed = int(seed)
        self.burst_on_s = float(burst_on_s)
        self.burst_off_s = float(burst_off_s)
        self.diurnal_floor = float(diurnal_floor)
        self._schedule: list[Arrival] | None = None

    # -- arrival processes (one stream each) --------------------------------

    def _times_poisson(self, rng, rate: float) -> list[float]:
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= self.duration_s:
                return out
            out.append(t)

    def _times_bursty(self, rng, rate: float) -> list[float]:
        # interrupted Poisson: ON windows (mean burst_on_s) fire at
        # rate/duty, OFF windows (mean burst_off_s) are silent; duty
        # normalization keeps the long-run average at `rate`
        duty = self.burst_on_s / (self.burst_on_s + self.burst_off_s)
        rate_on = rate / duty
        out, t = [], 0.0
        # initial phase drawn from the STATIONARY distribution (P[on] =
        # duty); with exponential windows that makes the process stationary
        # from t=0, so the realized mean rate is unbiased even over short
        # schedules
        on = bool(rng.uniform() < duty)
        while t < self.duration_s:
            win = rng.exponential(self.burst_on_s if on else self.burst_off_s)
            if on:
                s = t + rng.exponential(1.0 / rate_on)
                while s < min(t + win, self.duration_s):
                    out.append(s)
                    s += rng.exponential(1.0 / rate_on)
            t += win
            on = not on
        return out

    def _times_diurnal(self, rng, rate: float) -> list[float]:
        # `rate` is the MEAN; the instantaneous rate ramps sinusoidally
        # between floor*peak and peak across the window (one "day":
        # trough -> peak at duration/2 -> trough).  Exact sampling by
        # thinning a peak-rate Poisson stream.
        f = self.diurnal_floor
        peak = rate * 2.0 / (1.0 + f)      # mean of the ramp == rate
        out = []
        for t in self._times_poisson(rng, peak):
            x = np.sin(np.pi * t / self.duration_s)       # 0 -> 1 -> 0
            lam = peak * (f + (1.0 - f) * x)
            if rng.uniform() < lam / peak:
                out.append(t)
        return out

    # -- schedule -----------------------------------------------------------

    def schedule(self) -> list[Arrival]:
        """The full merged workload, time-sorted, uids in time order.
        Pure function of the constructor args (memoized)."""
        if self._schedule is not None:
            return self._schedule
        per_stream = self.rate_qps / self.n_streams
        sampler = getattr(self, f"_times_{self.process}")
        merged: list[tuple[float, int]] = []
        for s in range(self.n_streams):
            rng = np.random.default_rng([self.seed, s, 0xA221])
            merged.extend((t, s) for t in sampler(rng, per_stream))
        merged.sort()                      # ties broken by stream index
        label_rng = np.random.default_rng([self.seed, 0xD161])
        labels = label_rng.integers(0, 10, size=len(merged))
        self._schedule = [Arrival(uid=i, stream=s, t=t, label=int(labels[i]))
                          for i, (t, s) in enumerate(merged)]
        return self._schedule

    def __len__(self) -> int:
        return len(self.schedule())

    @property
    def offered_qps(self) -> float:
        """Realized (not nominal) offered load of this seed's schedule."""
        return len(self.schedule()) / self.duration_s

    # -- payloads -----------------------------------------------------------

    def image(self, arrival: Arrival) -> np.ndarray:
        """Render the arrival's 28x28x1 digit — deterministic per (seed,
        uid): same glyph pipeline as the training data (kron upscale,
        jitter, smooth, noise), so served predictions are meaningful."""
        rng = np.random.default_rng([self.seed, 0x1A6E, arrival.uid])
        g = _glyph_array(arrival.label)
        sy = rng.integers(3, 4)
        sx = rng.integers(3, 5)
        big = np.kron(g, np.ones((sy, sx), np.float32))
        h, w = big.shape
        big = big * rng.uniform(0.8, 1.0)
        dy = rng.integers(0, 28 - h + 1)
        dx = rng.integers(0, 28 - w + 1)
        canvas = np.zeros((28, 28), np.float32)
        canvas[dy:dy + h, dx:dx + w] = big
        canvas = _smooth(canvas)
        canvas += rng.normal(0, 0.03, (28, 28)).astype(np.float32)
        return np.clip(canvas, 0.0, 1.0)[..., None]

    def images(self) -> np.ndarray:
        """Every payload, schedule-ordered: (n, 28, 28, 1) float32."""
        return np.stack([self.image(a) for a in self.schedule()])

    # -- replay -------------------------------------------------------------

    def replay(self, submit: Callable[[Arrival, float], object], *,
               speed: float = 1.0, tick_s: float = 0.002) -> int:
        """Play the schedule open-loop against `submit(arrival, t_submit)`.

        Chunked-tick clocking: sleep until the next due arrival (at most
        `tick_s`), then submit EVERY arrival now due in one burst — the
        generator never falls behind a server faster than Python's
        per-call overhead, and never waits for a slow one (that's the
        point).  `t_submit` passed to the callback is the arrival's
        SCHEDULED wall-clock time (epoch + t/speed) so downstream latency
        accounting measures from intended arrival.  `speed > 1` replays
        the same schedule compressed (2.0 = double the offered rate with
        identical arrival structure).  Returns #submitted."""
        sched = self.schedule()
        t0 = time.perf_counter()
        n = 0
        for a in sched:
            due = t0 + a.t / speed
            while True:
                now = time.perf_counter()
                if now >= due:
                    break
                time.sleep(min(tick_s, due - now))
            submit(a, due)
            n += 1
        return n

    def describe(self) -> dict:
        sched = self.schedule()
        per_stream = [0] * self.n_streams
        for a in sched:
            per_stream[a.stream] += 1
        return {
            "process": self.process,
            "rate_qps": self.rate_qps,
            "offered_qps": self.offered_qps,
            "duration_s": self.duration_s,
            "n": len(sched),
            "n_streams": self.n_streams,
            "per_stream": per_stream,
            "seed": self.seed,
        }


def arrival_cv(gen: LoadGen) -> float:
    """Coefficient of variation of inter-arrival gaps of the MERGED stream
    (1.0 for Poisson; >1 means burstier) — the knob the overload tests
    use to confirm `bursty` really is."""
    ts = np.asarray([a.t for a in gen.schedule()])
    gaps = np.diff(ts)
    if gaps.size < 2 or gaps.mean() == 0:
        return 0.0
    return float(gaps.std() / gaps.mean())


def sweep_processes(rate_qps: float, *, n_requests: int, n_streams: int = 4,
                    seed: int = 0) -> "Sequence[LoadGen]":
    """One LoadGen per arrival process at the same offered load — the
    goodput table's row axis."""
    return [LoadGen(process=p, rate_qps=rate_qps, n_requests=n_requests,
                    n_streams=n_streams, seed=seed) for p in PROCESSES]
