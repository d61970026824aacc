"""Driver of served traffic: open-loop arrivals of 28x28 digits into the
program's fleet, `ReplicaRouter` over `VisionEngine` replicas on one card.

Set-up (counted in `setup_s`): the params, a pool of distinct images and
the schedule from the seed; the fleet built (each engine warms its one
padded batch shape); one batch a replica through the fleet, so that the
slo door starts from observed service rates, then `WARM_S` of the cell's
own traffic, all through the router's serving thread, whose first steps
and picks there pay one-off costs (a first submit in an earlier version
of this driver stalled 100 ms); the set-up's objects are then frozen out
of the collector.  The window: arrivals are submitted at their scheduled
times from this thread (sleeping to each one, then submitting; the router
drains its replicas on its own thread), each stamped with its scheduled
time, so its latency runs from when it was due; the client takes the
answers every `HARVEST_S`.  At the close the router is stopped, which
drains what is pending first.  Every answered request is then compared
with the reference, which scores each distinct image of the pool once.

Mix parameters: process, rate_qps, n_streams, replicas, batch_size,
policy, slo_ms (the router's: the deadline each request carries and the
slo door's; null, none), limit_ms (the client's: an answer later than
this from its due time is not in time), image_pool.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from bench import harness, judge, program
from bench.reference import smallnet as ref
from bench.trace import DeviceTrace, GcPauses, HostSpans
from bench.traffic import render, schedule

KIND = "fleet"
TICK_S = 0.002
HARVEST_S = 0.02
WARM_S = 0.5


class Run:
    def __init__(self, cell: harness.Cell, seed: int, seconds: float, *,
                 device: str = "cuda", rate_qps: float | None = None,
                 backend=None, score_fmt: dict | None = None):
        """`backend` puts another backend in the program's place (a planted
        fault, or the lower-precision control), whose scores are words of
        `score_fmt` where that is given."""
        self.cell, self.seed, self.seconds, self.device = cell, seed, float(seconds), device
        self.mix = cell.mix
        self.rate = float(rate_qps if rate_qps is not None else self.mix["rate_qps"])
        self._backend, self._score_fmt = backend, score_fmt
        self.trace: dict | None = None

    # -- set-up -----------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.serving.router import ReplicaRouter
        from repro_torch.serving.vision_engine import VisionEngine
        mix, cfg = self.mix, self.cell.config
        self.params = harness.params_for(self.cell.config, self.seed)
        rng = np.random.default_rng([self.seed, 0x9001])
        labels = rng.integers(0, 10, size=mix["image_pool"])
        self.pool = np.stack([render.digit_image(self.seed, i, int(d))
                              for i, d in enumerate(labels)])
        self.times = schedule.arrivals(mix["process"], self.rate, self.seconds,
                                       n_streams=mix["n_streams"], seed=self.seed)
        self.which = rng.integers(0, len(self.pool), size=len(self.times))
        be = self._backend if self._backend is not None else program.backend(cfg)
        self.fmt = program.score_format(cfg, self._score_fmt)
        params = program.params_on(self.params, self.device)
        self.engines = [VisionEngine(params, backend=be, batch_size=mix["batch_size"],
                                     device=self.device) for _ in range(mix["replicas"])]
        self.router = ReplicaRouter(self.engines, policy=mix["policy"], slo_ms=mix["slo_ms"])
        # warm through the router's own serving thread, which serves the
        # window: one batch a replica, then the cell's own traffic for WARM_S
        self.router.start()
        warm = self.router.submit_many(list(self.pool[:mix["batch_size"] * mix["replicas"]]))
        self.router.wait(warm, timeout=120)
        self.router.pop_results(warm)
        self.router.pop_shed(warm)
        wt = schedule.arrivals(mix["process"], self.rate, WARM_S, n_streams=mix["n_streams"],
                               seed=self.seed + 1)
        self._replay(wt, rng.integers(0, len(self.pool), size=len(wt)), WARM_S)
        self.router.start()
        self.stats0 = self.router.stats()
        # the set-up's objects leave the collector's view: a full collection
        # of them stops every thread for 120-160 ms (`PERF.md` §5)
        gc.collect()
        gc.freeze()

    # -- the window ---------------------------------------------------------------

    def _replay(self, times: np.ndarray, which: np.ndarray, close_s: float) -> dict:
        """Submit `pool[which[i]]` at `times[i]` seconds from now, each
        stamped with its due time, taking the answers as they come; at
        `close_s`, stop the router, which drains what is pending first.
        -> arrays of the requests' fates."""
        router, pool = self.router, self.pool
        n = len(times)
        out = {"late": np.empty(n), "t_done": np.full(n, np.nan),
               "scores": np.zeros((n, 10), np.int32 if self.fmt is not None else np.float32),
               "preds": np.full(n, -1, np.int64), "shed": np.zeros(n, bool)}
        t_done, scores, preds, shed = out["t_done"], out["scores"], out["preds"], out["shed"]
        base = None

        def harvest():
            """Take the answers the router holds, as a client does, so that
            the process keeps no object of a request once it is answered."""
            for uid, r in router.pop_results().items():
                i = uid - base
                t_done[i], scores[i], preds[i] = r.t_done, r.scores, r.pred
            for uid in router.pop_shed():
                shed[uid - base] = True

        submit, late = router.submit, out["late"]
        t0 = time.perf_counter() + 0.001
        t_harvest = t0
        for i in range(n):
            due = t0 + times[i]
            now = time.perf_counter()
            if base is not None and now - t_harvest > HARVEST_S and due - now > TICK_S:
                harvest()
                t_harvest = now = time.perf_counter()
            while now < due:
                time.sleep(min(TICK_S, due - now))
                now = time.perf_counter()
            late[i] = now - due
            uid = submit(pool[which[i]], t_submit=due)
            if base is None:
                base = uid
        rest = t0 + close_s - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        router.stop()                          # drains what is pending first
        if base is not None:
            harvest()
        out["due"] = t0 + times
        return out

    def window(self, trace: bool = False) -> None:
        spans = HostSpans() if trace else None
        if trace:
            spans.wrap(self.router, "run", "ReplicaRouter.run")
            for eng in self.engines:
                spans.wrap(eng, "_step_fn", "VisionEngine._step_fn")
        dt = DeviceTrace() if trace else contextlib.nullcontext()
        gcp = GcPauses()
        with dt, gcp:
            out = self._replay(self.times, self.which, self.seconds)
        self.late_s, self.t_done, self.scores = out["late"], out["t_done"], out["scores"]
        self.preds, self.shed = out["preds"], out["shed"]
        self.latency_ms = np.where(np.isnan(self.t_done), self.seconds * 1e3,
                                   (self.t_done - out["due"]) * 1e3)
        self.gc = gcp.summary()
        self.stats1 = self.router.stats()
        if trace:
            s = dt.summary()
            s["idle_gaps"] = spans.label_gaps(
                s.pop("gaps"), ["VisionEngine._step_fn", "ReplicaRouter.run"],
                "router thread waiting for requests")
            self.trace = s

    def release(self) -> None:
        """Free the program's state on the card before the reference runs."""
        import torch
        gc.unfreeze()
        self.router = self.engines = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- results ---------------------------------------------------------------------

    @property
    def attempted(self) -> int:
        return len(self.times)

    @property
    def answered(self) -> np.ndarray:
        return ~np.isnan(self.t_done)

    @property
    def failed(self) -> int:
        """Requests shed, or never answered."""
        return self.attempted - int(self.answered.sum())

    def record(self) -> dict:
        d0, d1 = self.stats0, self.stats1
        engines = [{k: e1[k] - e0[k] for k in ("batches", "padded_slots", "busy_s")}
                   | {"batch_size": e1["batch_size"]}
                   for e0, e1 in zip(d0["per_replica"], d1["per_replica"])]
        limit = self.mix["limit_ms"]
        pcts = "/".join(f"{harness.nearest_rank(self.latency_ms, q):.3f}" for q in (50, 95, 99))
        return {"kind": KIND, "cell": self.cell.name, "config": self.cell.config,
                "seconds": self.seconds, "limit_ms": limit,
                "latency_ms": self.latency_ms, "late_ms": self.late_s * 1e3,
                "answered_in_time": int((self.latency_ms <= limit).sum()),
                "answered": int(self.answered.sum()),
                "submitted": d1["submitted"] - d0["submitted"],
                "shed": d1["shed"] - d0["shed"],
                "engines": engines, "trace": self.trace,
                "notes": f"gc during the window: {self.gc}; of {self.attempted} requests "
                         f"{int(self.shed.sum())} shed; latency p50/p95/p99 {pcts} ms; "
                         f"client late p99 {harness.nearest_rank(self.late_s * 1e3, 99):.3f} ms"}

    def check(self) -> list[harness.Compared]:
        limits = self.cell.workload["limits"]
        answered = self.answered
        st = self.stats1
        out = [harness.Compared("unresolved",
                                int((~answered & ~self.shed).sum()),
                                limits["unresolved"]),
               harness.Compared("ledger_unbalanced",
                                int(not (st["accounted"] and st["pending"] == 0)),
                                limits["ledger_unbalanced"])]
        if not answered.any():
            return out + [harness.Compared("answered", 0, -1)]
        used, inverse = np.unique(self.which[answered], return_inverse=True)
        want_fmt = program.score_format(self.cell.config)
        if want_fmt is not None:
            want = ref.net_words(self.params, self.pool[used], want_fmt)[inverse]
        else:
            want = ref.net_float(self.params, self.pool[used])[inverse]
        got = program.as_reference_words(self.scores[answered], self.fmt, want_fmt)
        return out + judge.scores(got, want, self.preds[answered], want_fmt is not None, limits)
