"""Replica router: SLO-aware fleet-level serving over N vision engines.

Port of `repro.serving.router` to the port's engines: `from_backends`
builds its replicas on `device` ("cuda" unless the caller asks for the
CPU) or, as the reference's, on a serving `mesh` (each engine splitting
its steps across it); replicas are drained one after another (see `run`).
Dispatch, failover, autoscaling and the fleet ledger are the
reference's.

The survey line of FPGA accelerator work (Guo et al.; ZynqNet) scales
throughput by REPLICATING the compute unit and partitioning the data path;
`VisionEngine` already batches one step, and this module adds
the second axis: a router that owns several engines ("replicas" — distinct
backends on the one card), dispatches each incoming request to a
replica, drains the replicas in turn, and aggregates per-replica stats
into fleet-level throughput, latency percentiles, and goodput.

Dispatch policies:

  least_loaded  shallowest lane+queue (depth only)
  round_robin   rotate over the healthy set
  slo           minimum PROJECTED WAIT — per-replica depth divided by the
                replica's OBSERVED service rate (`service_rate_qps()`, qps
                over busy time; cold replicas borrow the fleet median, then
                the deterministic `min_step_s` seed rate, then the fleet
                median of seeds), so a slow replica with a short queue
                loses to a fast replica with a longer one.  A replica with
                NO rate from any source and a full batch already backlogged
                projects an infinite wait (a cold fleet must door-shed a
                burst, not queue it into a blown p99).  When even the best
                projected wait exceeds the request's deadline headroom the
                request is SHED at the door (reason "slo_wait") instead of
                being queued — goodput over graveyard latency.

Every request can carry a deadline (default: the router's `slo_ms`); sheds
— at the router door or inside an engine (admission bound, expired
deadline) — are counted per reason, and the fleet ledger mirrors the
engine's:  submitted == served + shed + pending  (stats()["accounted"]).

Dispatch is deferred: `submit()` assigns a request to a replica's pending
lane immediately (so queue depths — the load signal — are visible), but the
images only enter the engine's own queue inside `run()`.  That makes
failover clean: if a replica dies mid-drain (its device step raises), the
router collects whatever that engine already completed, re-dispatches the
unserved remainder across the survivors, and only raises if NO replica is
left healthy.  One bad backend never poisons the fleet.

Elastic scaling: construct with `spawn=` (a zero-arg engine factory) and
call `autoscale()` between waves — or `start()` the serving thread, which
drains continuously and autoscales by itself.  Scale-up triggers when the
fleet's backlog exceeds `scale_up_depth` waves of capacity; scale-down
retires the idlest replica after `scale_down_idle` consecutive idle checks
(never below `min_replicas`; retired replicas stay in `replicas` so
indices — and per-replica stats — remain stable).

Usage:

    router = ReplicaRouter.from_backends(params, ["fixed_cuda", "cuda_plan"],
                                         policy="slo", slo_ms=50)  # device="cuda"
    uids = [router.submit(img) for img in images]
    router.run()                       # drain + failover
    res = router.pop_results(uids)     # uid -> RoutedResult
    print(router.stats())              # fleet + per-replica
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np

import torch

from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
from repro_torch.serving.ledger import RequestLedger
from repro_torch.serving.vision_engine import VisionEngine, VisionResult


class FleetExhaustedError(RuntimeError):
    """Every replica failed: there is nobody left to serve the remainder."""


@dataclasses.dataclass
class RoutedResult:
    """One served request as the ROUTER's client sees it: global uid,
    which replica served it, and latency measured from router submit (queue
    wait in the router's pending lane included)."""
    uid: int
    replica: int
    pred: int
    scores: np.ndarray
    t_submit: float                   # router-side submit time
    t_done: float

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class _Pending:
    uid: int
    image: np.ndarray
    t_submit: float
    deadline_ms: float | None = None
    parent_span: object = None        # caller's trace context (frame span)


class ReplicaRouter(RequestLedger):
    """SLO-aware request router over an elastic fleet of `VisionEngine`s.
    Its results, sheds and `wait` are a `serving/ledger.py` ledger, under
    a reentrant lock: `_pick`, under the submit lock, reads
    `queue_depths`, which locks again for its own public callers."""

    POLICIES = ("least_loaded", "round_robin", "slo")

    def __init__(self, replicas: Sequence[VisionEngine], *,
                 policy: str = "least_loaded", slo_ms: float | None = None,
                 shed_headroom: float = 1.0,
                 spawn: Callable[[], VisionEngine] | None = None,
                 min_replicas: int = 1, max_replicas: int | None = None,
                 scale_up_depth: float = 2.0, scale_down_idle: int = 3):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {self.POLICIES}")
        self.replicas = list(replicas)
        self.policy = policy
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.shed_headroom = float(shed_headroom)
        self._spawn = spawn
        self.min_replicas = int(min_replicas)
        self.max_replicas = None if max_replicas is None else int(max_replicas)
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_idle = int(scale_down_idle)
        self._pending: list[list[_Pending]] = [[] for _ in self.replicas]
        self._errors: dict[int, BaseException] = {}
        self._retired: set[int] = set()
        self._assignment: dict[int, int] = {}      # uid -> replica (pending)
        self._id = M.instance_label("router")
        super().__init__("router", {"router": self._id},
                         threading.Condition(threading.RLock()))
        self._served_by: dict[int, int] = {i: 0 for i in range(len(replicas))}
        self._idle_ticks = 0
        self._rr_last = -1            # last-dispatched STABLE replica id
        self._thread: threading.Thread | None = None
        self._stop_flag = False

    @classmethod
    def from_backends(cls, params: Any, backends: Iterable[str], *,
                      batch_size: int = 32, mesh: Any = None,
                      device: torch.device | str | None = None,
                      warmup: bool = True, policy: str = "least_loaded",
                      engine_kw: dict | None = None,
                      **router_kw) -> "ReplicaRouter":
        """Build one replica per backend name over shared float params (each
        engine quantizes its own copy — the paper's per-substrate bake), all
        on `device` or all on `mesh`."""
        return cls([VisionEngine(params, backend=b, batch_size=batch_size,
                                 mesh=mesh, device=device, warmup=warmup,
                                 **(engine_kw or {}))
                    for b in backends], policy=policy, **router_kw)

    # -- request side -------------------------------------------------------

    def healthy_replicas(self) -> list[int]:
        # snapshot under the GIL; callers needing consistency vs concurrent
        # drains hold self._cond (as _pick/run/_redistribute do)
        dead = set(self._errors) | self._retired
        return [i for i in range(len(self.replicas)) if i not in dead]

    def queue_depths(self) -> list[int]:
        """Per-replica load: router pending lane + engine queue+in-flight."""
        with self._cond:
            return [len(self._pending[i]) + self.replicas[i].load()
                    for i in range(len(self.replicas))]

    def _load_snapshot(self, healthy: list[int]
                       ) -> dict[int, tuple[int, float | None,
                                            float | None, int]]:
        """ONE consistent read of every dispatch signal, taken under the
        router lock: replica -> (depth, observed rate, seed rate,
        batch_size).  The slo pick derives both the wait map and its depth
        tiebreaker from this single snapshot — reading them in two separate
        locked passes let a concurrent submit land between the reads, so
        the wait map and the tiebreaker could describe different fleets
        mid-pick."""
        with self._cond:
            return {i: (len(self._pending[i]) + self.replicas[i].load(),
                        self.replicas[i].service_rate_qps(),
                        self.replicas[i].seed_rate_qps(),
                        self.replicas[i].batch_size)
                    for i in healthy}

    @staticmethod
    def _projected_waits_from(snapshot: dict[int, tuple[int, float | None,
                                                        float | None, int]]
                              ) -> dict[int, float]:
        """Seconds until a request dispatched NOW would be served, per
        replica: depth / service rate, as a pure function of one load
        snapshot (deterministic given frozen inputs — tested as such).

        Rate fallback chain, most- to least-informed:
          1. the replica's OBSERVED rate (qps over busy time),
          2. the fleet median of observed rates,
          3. the replica's deterministic seed rate (`seed_rate_qps()`: the
             min_step_s capacity floor, known before any traffic),
          4. the fleet median of seed rates.
        A replica with no rate from ANY source projects an INFINITE wait
        once a full batch is already pending on it (depth >= batch_size) —
        the pessimistic reading of "a whole wave is backlogged and there is
        no evidence anybody serves it".  That lets the slo door shed during
        a cold-start burst instead of projecting 0.0 and queueing
        everything into a blown p99 (the cold-fleet SLO hole).  Below one
        batch the wait stays 0.0: a cold replica absorbs its first wave in
        a single step, and serving it is exactly what establishes the
        observed rate."""
        observed = [r for _, r, _, _ in snapshot.values() if r]
        med_obs = float(np.median(observed)) if observed else None
        seeds = [s for _, _, s, _ in snapshot.values() if s]
        med_seed = float(np.median(seeds)) if seeds else None
        waits = {}
        for i, (depth, obs, seed, batch) in snapshot.items():
            rate = obs or med_obs or seed or med_seed
            if rate:
                waits[i] = depth / rate
            else:
                waits[i] = float("inf") if depth >= max(batch, 1) else 0.0
        return waits

    def _projected_waits(self, healthy: list[int]) -> dict[int, float]:
        return self._projected_waits_from(self._load_snapshot(healthy))

    def _pick(self, deadline_ms: float | None = None
              ) -> tuple[int, str | None]:
        """(replica index, shed reason) — reason is non-None when even the
        best replica's projected wait blows the deadline headroom."""
        healthy = self.healthy_replicas()
        if not healthy:
            raise FleetExhaustedError(
                f"all {len(self.replicas)} replicas have failed or retired: "
                f"{ {i: repr(e) for i, e in self._errors.items()} }")
        if self.policy == "round_robin":
            # rotate over STABLE replica ids, not positions in the healthy
            # list: `clock % len(healthy)` re-aliases every time the healthy
            # set churns (failover, autoscale spawn/retire), double-hitting
            # one replica while starving another.  Advancing to the next
            # healthy id past the last-dispatched one is churn-proof — ids
            # never move.
            nxt = [i for i in healthy if i > self._rr_last]
            i = nxt[0] if nxt else healthy[0]
            self._rr_last = i
            return i, None
        if self.policy == "least_loaded":
            depths = self.queue_depths()
            return min(healthy, key=lambda i: depths[i]), None
        snapshot = self._load_snapshot(healthy)
        waits = self._projected_waits_from(snapshot)
        i = min(healthy, key=lambda j: (waits[j], snapshot[j][0]))
        if (deadline_ms is not None
                and waits[i] * 1e3 > deadline_ms * self.shed_headroom):
            return i, "slo_wait"
        return i, None

    def submit(self, image: np.ndarray, *,
               deadline_ms: float | None = None,
               t_submit: float | None = None,
               parent_span: object = None) -> int:
        """Route one image per the dispatch policy; returns a fleet-global
        uid immediately.  Under the "slo" policy a request the fleet cannot
        plausibly serve in time is shed at the door (reason "slo_wait").
        `t_submit` lets an open-loop replay harness stamp the request with
        its scheduled arrival time (the engine deadline then counts from
        intended arrival, not generator lag).  With tracing on, every
        call emits a span "dispatch" over the whole call, from entry (so a
        wait for the lock counts) to return — chosen replica, policy —
        nested under `parent_span` when given, so a frame's waterfall
        shows WHERE it was sent and a door-shed request carries the span
        where it died (status "shed:<reason>")."""
        tr = T.get()
        t_in = time.perf_counter() if tr is not None else 0.0
        with self._cond:
            dl = deadline_ms if deadline_ms is not None else self.slo_ms
            # may raise FleetExhaustedError: counters move only once admitted
            i, shed = self._pick(dl)
            now = time.perf_counter() if t_submit is None else float(t_submit)
            uid = self._admit_locked(now, dl)
            if shed is not None:
                self._shed_uid_locked(uid, shed)
            else:
                self._assignment[uid] = i
                self._pending[i].append(_Pending(
                    uid=uid, image=np.asarray(image, np.float32),
                    t_submit=now, deadline_ms=dl, parent_span=parent_span))
                self._cond.notify_all()
        if tr is not None:
            tid = (parent_span.trace_id if parent_span is not None
                   else f"rreq-{self._id}-{uid}")
            where = {} if shed is not None else {"replica": i}
            tr.emit("dispatch", tid, t_in, time.perf_counter(),
                    "ok" if shed is None else f"shed:{shed}",
                    parent=parent_span, uid=uid, policy=self.policy,
                    router=self._id, **where)
        return uid

    def submit_many(self, images: Iterable[np.ndarray], *,
                    deadline_ms: float | None = None,
                    parent_span: object = None) -> list[int]:
        return [self.submit(img, deadline_ms=deadline_ms,
                            parent_span=parent_span) for img in images]

    def _shed_uid_locked(self, uid: int, reason: str) -> None:
        super()._shed_uid_locked(uid, reason)
        self._assignment.pop(uid, None)

    # -- serving side -------------------------------------------------------

    def _drain_replica(self, i: int) -> list[_Pending]:
        """Feed replica i its pending lane and drain it.  Returns the
        requests that did NOT complete (empty when healthy); on failure the
        replica is marked dead and partial results are still harvested.
        Engine-side sheds (expired deadline, admission bound) are recorded
        as fleet sheds, NOT failed over — their deadline already lapsed.
        With tracing on, a lane drained emits one "drain" span over the
        call (replica, lane length); the engine's step spans run inside it,
        on this thread."""
        tr = T.get()
        t_in = time.perf_counter() if tr is not None else 0.0
        eng = self.replicas[i]
        with self._cond:              # vs concurrent submit() to this lane
            lane, self._pending[i] = self._pending[i], []
        if not lane:
            return []
        local: dict[int, _Pending] = {}
        res: dict[int, VisionResult] = {}
        eng_shed: dict[int, str] = {}
        error: BaseException | None = None
        try:
            for p in lane:
                # stamp the engine request with the ROUTER submit time so
                # engine latency/deadlines measure what the client observes
                local[eng.submit(p.image, deadline_ms=p.deadline_ms,
                                 t_submit=p.t_submit,
                                 parent_span=p.parent_span)] = p
            eng.run()
        except Exception as e:        # noqa: BLE001 — any replica fault fails over
            error = e
        try:                          # harvest whatever completed pre-fault
            res = eng.pop_results(list(local))
            eng_shed = eng.pop_shed(list(local))
        except Exception:
            res, eng_shed = {}, {}
        done: set[int] = set()
        routed: dict[int, RoutedResult] = {}
        shed_here: dict[int, str] = {}
        for luid, p in local.items():
            r = res.get(luid)
            if r is not None:
                routed[p.uid] = RoutedResult(
                    uid=p.uid, replica=i, pred=r.pred, scores=r.scores,
                    t_submit=p.t_submit, t_done=r.t_done)
                done.add(p.uid)
                continue
            reason = eng_shed.get(luid)
            if reason is not None and reason != "fault":
                shed_here[p.uid] = reason    # lapsed in queue: not re-run
                done.add(p.uid)
        with self._cond:
            self._results.update(routed)
            for uid, rr in routed.items():
                self._m_served.inc()
                self._served_by[i] = self._served_by.get(i, 0) + 1
                self._lat_hist.observe(rr.latency_s)
                self._assignment.pop(uid, None)
            for uid, reason in shed_here.items():
                self._shed_uid_locked(uid, reason)
            # deadline bookkeeping needs the pending records, not the uids
            for luid, p in local.items():
                if p.uid in routed and p.deadline_ms is not None:
                    rr = routed[p.uid]
                    if rr.t_done <= p.t_submit + p.deadline_ms / 1e3:
                        self._deadline_ok += 1
            if error is not None:
                self._errors[i] = error
            self._cond.notify_all()
        if tr is not None:
            tr.emit("drain", f"drain-{self._id}", t_in, time.perf_counter(),
                    "ok" if error is None else "error", replica=i,
                    lane=len(lane))
        # unserved from the LANE (not the submitted map): a fault inside
        # eng.submit itself must not drop the never-submitted remainder
        return [p for p in lane if p.uid not in done]

    def run(self) -> int:
        """Drain every replica, one after another; fail unserved requests
        over to survivors until everything is served (or shed) or the fleet
        is exhausted.  Returns total #requests served this call.

        The reference drains its replicas on a thread each: each waits on a
        device of its own.  Here they share one card and one interpreter,
        and a step is host Python around a kernel of microseconds, so
        threads only hand the interpreter lock to each other and stretch
        every step past its deadline (`PERF.md` §5)."""
        served_before = self._m_served.value
        while True:
            with self._cond:
                # reclaim lanes stranded on dead replicas: a concurrent
                # submit() can route to a replica in the window before its
                # fault is recorded — those requests must fail over too,
                # not sit invisible on a lane nothing will ever drain
                stranded = []
                for i in list(self._errors) + sorted(self._retired):
                    if self._pending[i]:
                        stranded.extend(self._pending[i])
                        self._pending[i] = []
                self._redistribute(stranded)
                busy = [i for i in self.healthy_replicas() if self._pending[i]]
            if not busy:
                break
            unserved = [p for i in busy for p in self._drain_replica(i)]
            if not unserved:
                continue              # loop once more in case of re-routes
            with self._cond:
                self._redistribute(unserved)
        return self._m_served.value - served_before

    def _redistribute(self, orphans: list[_Pending]) -> None:
        """Spread failed-over requests across the survivors, shallowest lane
        first.  Caller holds self._cond."""
        if not orphans:
            return
        healthy = self.healthy_replicas()
        if not healthy:
            raise FleetExhaustedError(
                f"{len(orphans)} requests unserved and every replica "
                f"failed: { {i: repr(e) for i, e in self._errors.items()} }")
        for p in orphans:
            i = min(healthy, key=lambda j: len(self._pending[j]))
            self._assignment[p.uid] = i
            self._pending[i].append(p)

    # -- continuous serving + elastic scaling -------------------------------

    def start(self) -> "ReplicaRouter":
        """Spawn the fleet serving loop: drain whatever is pending, wave
        after wave (continuous batching at fleet granularity — each drain
        takes exactly what accumulated during the last), autoscaling when a
        `spawn` factory was provided.  Idempotent."""
        with self._cond:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True, name="replica-router")
            self._thread.start()
        return self

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                has_work = any(self._pending[i]
                               for i in self.healthy_replicas())
                if not has_work:
                    if self._stop_flag:
                        return
                    self._cond.wait(timeout=0.01)
            if has_work:
                try:
                    self.run()
                except FleetExhaustedError:
                    with self._cond:
                        for lane in self._pending:
                            while lane:
                                self._shed_uid_locked(lane.pop().uid,
                                                      "fleet_exhausted")
                    return
            if self._spawn is not None:
                self.autoscale()

    def stop(self, drain: bool = True) -> None:
        """Stop the fleet serving loop (draining pending work first unless
        `drain=False`, which sheds it)."""
        with self._cond:
            thread = self._thread
            self._stop_flag = True
            if not drain:
                for lane in self._pending:
                    while lane:
                        self._shed_uid_locked(lane.pop().uid, "stopped")
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=120.0)
            with self._cond:
                self._thread = None
                self._stop_flag = False

    def autoscale(self) -> str | None:
        """One elastic-sizing decision against depth + goodput signals.
        Scale UP (via the `spawn` factory) when the fleet backlog exceeds
        `scale_up_depth` waves of current batch capacity; RETIRE the
        emptiest replica after `scale_down_idle` consecutive idle checks.
        Returns "spawn:<i>" / "retire:<i>" / None.  Meant to be called from
        one place (the serving loop or the harness) — concurrent callers
        may overshoot the bounds by a replica."""
        with self._cond:
            healthy = self.healthy_replicas()
            if not healthy:
                return None
            depth = sum(len(self._pending[i]) + self.replicas[i].load()
                        for i in healthy)
            capacity = sum(self.replicas[i].batch_size for i in healthy)
            self._idle_ticks = self._idle_ticks + 1 if depth == 0 else 0
            can_grow = (self._spawn is not None
                        and (self.max_replicas is None
                             or len(healthy) < self.max_replicas))
            if can_grow and depth > self.scale_up_depth * capacity:
                grow = True
            else:
                grow = False
                if (len(healthy) > self.min_replicas
                        and self._idle_ticks >= self.scale_down_idle):
                    i = min(healthy,
                            key=lambda j: len(self._pending[j])
                            + self.replicas[j].load())
                    if not self._pending[i] and self.replicas[i].load() == 0:
                        self._retired.add(i)
                        self._idle_ticks = 0
                        self.replicas[i].stop(drain=True)
                        return f"retire:{i}"
                return None
        eng = self._spawn()           # build OUTSIDE the lock: warmup launches
        with self._cond:
            self.replicas.append(eng)
            self._pending.append([])
            i = len(self.replicas) - 1
            self._served_by.setdefault(i, 0)
            self._idle_ticks = 0
            return f"spawn:{i}"

    # -- client loop --------------------------------------------------------

    def _inline_locked(self) -> Callable[[], int] | None:
        return self.run if self._thread is None else None

    def _idle_locked(self) -> bool:
        return not any(self._pending)

    def _pop_results_locked(self, uids: Iterable[int] | None) -> dict:
        out = super()._pop_results_locked(uids)
        for u in out:                 # assignment records go with them
            self._assignment.pop(u, None)
        return out

    def serve(self, images: Iterable[np.ndarray], *,
              deadline_ms: float | None = None
              ) -> list["RoutedResult | None"]:
        """Submit a workload, drain the fleet, return results in submission
        order (None where a request was shed)."""
        uids = self.submit_many(images, deadline_ms=deadline_ms)
        self.wait(uids)
        res = self.pop_results(uids)
        self.pop_shed(uids)
        return [res.get(u) for u in uids]

    # -- reporting ----------------------------------------------------------

    def errors(self) -> dict[int, BaseException]:
        with self._cond:
            return dict(self._errors)

    def stats(self) -> dict:
        """Fleet-level goodput/latency/throughput + per-replica engine
        stats.  Fleet throughput is the SUM of per-replica observed service
        rates (replicas serve in parallel), each measured over that
        replica's busy time — idle gaps never deflate it."""
        with self._cond:
            # lanes (incl. ones stranded on dead replicas — run() reclaims
            # those) + live engines' queues.  A DEAD replica's engine queue
            # is excluded: whatever it still holds was already failed over.
            pending = (sum(len(lane) for lane in self._pending)
                       + sum(self.replicas[i].load()
                             for i in range(len(self.replicas))
                             if i not in self._errors))
            out = {
                "replicas": len(self.replicas),
                "healthy": len(self.healthy_replicas()),
                "retired": sorted(self._retired),
                "failed": sorted(self._errors),
                "policy": self.policy,
                "slo_ms": self.slo_ms,
                **self._ledger_locked(pending),
                "per_replica": [eng.stats() for eng in self.replicas],
                "served_by": dict(sorted(self._served_by.items())),
                **self._deadline_stats_locked(),
            }
            if out["n"]:
                busy = sum(r["busy_s"] for r in out["per_replica"])
                out.update(M.summarize_latency(self._lat_hist.samples(), busy))
                rates = [eng.service_rate_qps() for eng in self.replicas]
                out["throughput_qps"] = float(sum(r for r in rates if r))
        return self._checked(out)
