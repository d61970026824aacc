"""Disaggregated trunk/head serving: separate engine pools joined by a
feature-map cache.

Port of `repro.serving.disagg` to the port's sweep on one device (the card
unless the caller asks for the CPU).  smallNet's deployment shape is a
heavy conv trunk feeding a light dense head.  The monolithic sweep
(`FcnSweep.score`) runs both halves per frame; when many queries land on
the SAME frame (overlapping crops, re-scores under new thresholds, fan-out
to several consumers), every one of them re-runs the trunk to reproduce
feature words the fleet just computed.  This module serves the two halves
from separate pools:

    frames ──> TRUNK POOL ──> FeatureMapCache ──> HEAD POOL ──> scores
               (N replicas)      (bounded LRU+TTL,   (M replicas)
                                  single-flight)

  * Each trunk replica is a `StageEngine` running the trunk half of the
    sweep (`fcn_sweep.make_trunk_fn`: one `frame_trunk` launch a frame on
    `fixed_cuda`, the composed cascade with `megakernel=False` and on the
    float and int8 backends): the level-2 role-map quad (I, B, R, C) in
    the backend's native word domain, left on the device.
  * The `FeatureMapCache` holds recent quads keyed on (frame digest,
    backend, fixed-point config, megakernel route, device type): every axis
    that changes the words, or the program that made them, changes the
    key, so a cached quad is never served to a query it is not exact for.
    A hit hands the head the quad where the trunk left it: no copy to the
    host and back.  LRU + optional TTL keep memory bounded; hits, misses
    and evictions are registry counters.  Single-flight: concurrent queries
    on one uncached frame elect ONE leader to run the trunk; followers
    wait for it and are counted as `coalesced`.
  * Each head replica is a `StageEngine` running the head half
    (`fcn_sweep.make_head_fn`): quad -> (n_windows, 10) scores through the
    sweep's own `_head_scores`, on the route the monolithic call takes for
    the same `megakernel` (one `fixed_window_head` launch on `fixed_cuda`),
    so scores are int32 word-exact against `FcnSweep.score` on the fixed
    backends.

`DisaggServer` fronts the pools with the fleet contract the rest of the
stack expects: bounded intake, per-request deadlines, per-reason shed
accounting, trunk failover (a faulted trunk replica's requests retry on a
healthy sibling), and the no-silent-loss ledger

    submitted == served + shed + pending          (stats()["accounted"])

Both call styles are supported: synchronous `score_frame()` (what
`StreamingPipeline` drives per frame) and open-loop `submit()` + `wait()`
+ `pop_results()` (what a goodput harness replays arrival schedules
against); trunk and head replica counts scale independently under either.

Threads on one card.  The thread model is the reference's: a serving
thread for each started `StageEngine` and the fleet's worker threads (the
open-loop interface and single-flight need real concurrency).  Every
replica launches on the current stream of its thread, and torch's default
stream is shared by all threads, so a quad made on a trunk thread is read
on a head thread in stream order.  No replica has a side stream; one that
gets one must record an event with each quad it caches.

A hit skips the trunk but still pays for `frame_digest` (blake2b over the
frame's bytes) and two stage round trips in Python.  Whether that beats
the monolithic sweep on a given card is measured, not assumed
(`chip_smoke.py`'s `disagg` phase; `PERF.md`).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import backends as B
from repro_torch.core.device import as_device_tensor, resolve_device
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
from repro_torch.serving.ledger import RequestLedger, ServingQueue
from repro_torch.streaming import fcn_sweep as fs
from repro_torch.streaming.sources import Frame


# ---------------------------------------------------------------------------
# Cache keying
# ---------------------------------------------------------------------------

def frame_digest(frame: np.ndarray) -> str:
    """Content digest of one frame batch: blake2b-128 over shape + dtype +
    raw bytes.  Two frames share a digest iff they are the same array —
    the cache's correctness rests on this, not on object identity, so
    replayed clips and duplicated streams deduplicate across sources."""
    px = np.ascontiguousarray(frame)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(px.shape).encode())
    h.update(str(px.dtype).encode())
    h.update(px.tobytes())
    return h.hexdigest()


def _cfg_token(be: B.Backend) -> str:
    """The fixed-point config as a key axis: any word-domain knob
    (total/frac bits, saturate, rounding) changes the trunk's output words
    and therefore the cache key.  Float backends have no cfg — their token
    is the empty string (backend name still separates them)."""
    cfg = getattr(be, "cfg", None)
    if cfg is None:
        return ""
    return (f"q{cfg.total_bits}.{cfg.frac_bits}"
            f".{'sat' if cfg.saturate else 'wrap'}"
            f".{'rn' if cfg.round_nearest else 'trunc'}")


@dataclasses.dataclass(frozen=True)
class FeatureMapKey:
    """Everything that determines the trunk's output words for one frame.

    `digest` pins the pixels; `backend`/`cfg` pin the word domain;
    `megakernel` pins the trunk route (None/True/False produce identical
    words on the fixed backends, but the key keeps them separate so a
    route-comparison harness never reads the other route's words as its
    own); `device` is the device type of the trunk's output, "cuda" or
    "cpu": the kernels and the plain versions give equal words on the
    fixed backends, but the key keeps them apart, as the reference keeps
    its interpreted and compiled programs apart."""
    digest: str
    backend: str
    cfg: str
    megakernel: bool | None
    device: str


def feature_key(frame: np.ndarray, be: B.Backend, megakernel: bool | None,
                device: str) -> FeatureMapKey:
    return FeatureMapKey(
        digest=frame_digest(frame), backend=be.name, cfg=_cfg_token(be),
        megakernel=megakernel, device=device)


# ---------------------------------------------------------------------------
# Feature-map cache: bounded LRU + TTL, single-flight, registry-instrumented
# ---------------------------------------------------------------------------

class FeatureMapCache:
    """Bounded LRU (+ optional TTL) cache of trunk feature-map quads with
    single-flight dedup.

    `get_or_compute(key, compute)` is the whole API: a hit returns the
    cached quad; a miss elects the FIRST caller as leader (it runs
    `compute()` outside the cache lock), and every concurrent caller for
    the same key blocks on the leader's completion instead of re-running
    the trunk (counted as `coalesced`).  A failed leader wakes its
    followers to re-elect — a crash never wedges a key.

    Eviction: LRU order on access, capacity-driven (`reason="capacity"`)
    plus lazy TTL expiry at lookup (`reason="ttl"`).  Memory is bounded by
    construction: at most `capacity` quads resident, tracked in bytes by
    the `disagg_cache_bytes` gauge (its high-water mark is the soak test's
    bounded-memory assertion).

    Thread model: one lock guards the entry map and the in-flight table;
    `compute()` runs outside it, so a slow trunk pass never blocks hits on
    other keys.  Instruments live in the process-wide registry under this
    cache's unique instance label.
    """

    def __init__(self, capacity: int = 64, ttl_s: float | None = None,
                 registry: M.Registry | None = None):
        if capacity < 1:
            raise ValueError(f"FeatureMapCache capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self._lock = threading.Lock()
        # key -> (value, t_insert, nbytes); OrderedDict is the LRU order
        self._entries: collections.OrderedDict[
            FeatureMapKey, tuple[Any, float, int]] = collections.OrderedDict()
        self._inflight: dict[FeatureMapKey, threading.Event] = {}
        reg = registry if registry is not None else M.REGISTRY
        self._id = M.instance_label("fmcache")
        labels = {"cache": self._id}
        self._m_hits = reg.counter("disagg_cache_hits", **labels)
        self._m_misses = reg.counter("disagg_cache_misses", **labels)
        self._m_coalesced = reg.counter("disagg_cache_coalesced", **labels)
        self._m_evicted: dict[str, M.Counter] = {
            reason: reg.counter("disagg_cache_evictions", reason=reason,
                                **labels)
            for reason in ("capacity", "ttl")}
        self._m_entries = reg.gauge("disagg_cache_entries", **labels)
        self._m_bytes = reg.gauge("disagg_cache_bytes", **labels)

    @staticmethod
    def _nbytes(value: Any) -> int:
        def one(v) -> int:
            if isinstance(v, torch.Tensor):
                return v.element_size() * v.numel()
            return int(np.asarray(v).nbytes)
        if isinstance(value, (tuple, list)):
            return sum(one(v) for v in value)
        return one(value)

    def _expired_locked(self, t_insert: float, now: float) -> bool:
        return self.ttl_s is not None and now - t_insert > self.ttl_s

    def _evict_locked(self, key: FeatureMapKey, reason: str) -> None:
        self._entries.pop(key, None)
        self._m_evicted[reason].inc()
        self._refresh_gauges_locked()

    def _refresh_gauges_locked(self) -> None:
        self._m_entries.set(len(self._entries))
        self._m_bytes.set(sum(nb for _, _, nb in self._entries.values()))

    def _lookup_locked(self, key: FeatureMapKey, now: float):
        """(value,) on a live hit, None on miss (expired entries are
        evicted in passing — lazy TTL)."""
        hit = self._entries.get(key)
        if hit is None:
            return None
        value, t_insert, _ = hit
        if self._expired_locked(t_insert, now):
            self._evict_locked(key, "ttl")
            return None
        self._entries.move_to_end(key)
        return (value,)

    def get_or_compute(self, key: FeatureMapKey,
                       compute: Callable[[], Any], *,
                       timeout: float | None = None) -> Any:
        """The single-flight read-through path (see class docstring).
        `timeout` bounds a FOLLOWER's wait on the leader (a deadline-bearing
        query must not outwait its budget on someone else's trunk pass);
        expiry raises TimeoutError.  Leader failures propagate to the
        leader's caller; followers re-elect."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        counted = False   # each call counts exactly one of hit/miss/coalesced
        while True:
            with self._lock:
                now = time.perf_counter()
                found = self._lookup_locked(key, now)
                if found is not None:
                    if not counted:
                        self._m_hits.inc()
                    return found[0]
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    if not counted:
                        self._m_misses.inc()
                    leader = True
                else:
                    if not counted:
                        self._m_coalesced.inc()
                        counted = True
                    leader = False
            if leader:
                try:
                    value = compute()
                except BaseException:
                    with self._lock:
                        # wake followers with nothing cached: they re-elect
                        # a new leader (or time out) instead of hanging
                        self._inflight.pop(key, None)
                    ev.set()
                    raise
                self.put(key, value)
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
                return value
            remaining = (None if deadline is None
                         else deadline - time.perf_counter())
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"feature-map wait for {key.digest[:8]} exceeded its "
                    f"deadline while another query computed the trunk")
            if not ev.wait(remaining):
                raise TimeoutError(
                    f"feature-map wait for {key.digest[:8]} exceeded its "
                    f"deadline while another query computed the trunk")
            # leader finished (or failed): loop re-reads the entry map

    def put(self, key: FeatureMapKey, value: Any) -> None:
        """Insert (or refresh) an entry, evicting LRU past capacity."""
        nb = self._nbytes(value)
        with self._lock:
            self._entries[key] = (value, time.perf_counter(), nb)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                oldest = next(iter(self._entries))
                self._evict_locked(oldest, "capacity")
            self._refresh_gauges_locked()

    def get(self, key: FeatureMapKey) -> Any | None:
        """Plain lookup (hit/miss counted); None on miss."""
        with self._lock:
            found = self._lookup_locked(key, time.perf_counter())
            if found is not None:
                self._m_hits.inc()
                return found[0]
            self._m_misses.inc()
            return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def hit_rate(self) -> float:
        h, m = self._m_hits.value, self._m_misses.value
        return h / (h + m) if h + m else 0.0

    def stats(self) -> dict:
        with self._lock:
            entries = len(self._entries)
            resident = sum(nb for _, _, nb in self._entries.values())
        return {
            "capacity": self.capacity,
            "ttl_s": self.ttl_s,
            "entries": entries,
            "resident_bytes": resident,
            "resident_bytes_hwm": int(self._m_bytes.hwm),
            "hits": self._m_hits.value,
            "misses": self._m_misses.value,
            "coalesced": self._m_coalesced.value,
            "hit_rate": self.hit_rate,
            "evictions": {r: c.value for r, c in self._m_evicted.items()},
        }


# ---------------------------------------------------------------------------
# Stage engine: the continuous serving loop for one disagg stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageRequest:
    uid: int
    payload: Any
    t_submit: float = 0.0
    deadline: float | None = None
    parent_span: Any = None


@dataclasses.dataclass
class StageResult:
    uid: int
    value: Any
    t_submit: float
    t_done: float
    deadline: float | None = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def within_deadline(self) -> bool:
        return self.deadline is None or self.t_done <= self.deadline


class StageEngine(ServingQueue):
    """One disagg-stage replica: a continuously-served queue over an
    arbitrary compute callable (trunk: frame batch -> role-map quad; head:
    quad -> window scores).

    The serving discipline is `VisionEngine`'s (`serving/ledger.py`'s
    `ServingQueue`), specialized to one request per step (the trunk
    megakernel is a batch-1 program; a head request already carries its
    whole window lattice): bounded intake (`max_queue`, shed reason
    "queue_depth"), deadline shedding at batch-forming time ("deadline"),
    fault containment (a raising compute sheds its request as "fault" and
    kills the replica in both serving modes — the `DisaggServer` fails the
    work over to a sibling replica), a deterministic `min_step_s` service
    floor for overload harnesses, and registry-backed accounting with the
    engine ledger invariant

        submitted == served + shed + pending

    Throughput is measured over BUSY time; `service_rate_qps()` is the
    observed rate (None before history) and `seed_rate_qps()` the
    deterministic floor-derived rate — the dispatch signals the disagg
    router shares with `serving/router.py`.  Once it faulted, `wait`
    returns when nothing is queued or in flight, resolved or not.
    """

    _Request = StageRequest
    _noun = "stage requests"

    def __init__(self, compute: Callable[[Any], Any], *, name: str,
                 min_step_s: float = 0.0, max_queue: int | None = None):
        self._compute = compute
        self.name = name
        self._id = M.instance_label(f"stage-{name}")
        super().__init__("stage", {"stage": self._id}, max_queue=max_queue,
                         min_step_s=min_step_s,
                         thread_name=f"stage-engine-{name}")

    def _trace_id(self, uid: int, parent_span: Any) -> str:
        return (parent_span.trace_id if parent_span is not None
                else f"stage-{self._id}-{uid}")

    def _shed_span(self, tr, uid: int, reason: str, t_submit: float,
                   t_end: float, parent_span: Any, queued: bool) -> None:
        tr.emit("stage_request", self._trace_id(uid, parent_span), t_submit,
                t_end, f"shed:{reason}", parent=parent_span, uid=uid,
                stage=self._id)

    def step(self) -> int:
        """Serve ONE request (shedding expired ones in passing); returns
        the number served (0 or 1)."""
        with self._cond:
            req = None
            now = time.perf_counter()
            while self._queue:
                r = self._queue.popleft()
                if r.deadline is not None and now > r.deadline:
                    self._shed_locked(r.uid, "deadline", r.t_submit, now,
                                      parent_span=r.parent_span)
                else:
                    req = r
                    break
            self._m_queue.set(len(self._queue))
            if req is None:
                return 0
            self._in_flight = 1
        t0 = time.perf_counter()
        try:
            value = self._compute(req.payload)
        except Exception as e:
            with self._cond:
                self._in_flight = 0
                # a faulted compute kills this replica in BOTH serving
                # modes: the threaded loop exits, and inline callers see
                # the door close — dispatch must fail over, not retry a
                # replica whose program is broken
                self._fault = e
                self._shed_locked(req.uid, "fault", req.t_submit,
                                  time.perf_counter(),
                                  parent_span=req.parent_span)
            raise
        t_done = self._held_to_floor(t0, time.perf_counter())
        with self._cond:
            res = StageResult(uid=req.uid, value=value,
                              t_submit=req.t_submit, t_done=t_done,
                              deadline=req.deadline)
            self._results[req.uid] = res
            self._lat_hist.observe(res.latency_s)
            self._m_served.inc()
            self._m_busy.inc(t_done - t0)
            self._in_flight = 0
            self._cond.notify_all()
        tr = T.get()
        if tr is not None:
            tr.emit("stage_request", self._trace_id(req.uid, req.parent_span),
                    req.t_submit, t_done, "served", parent=req.parent_span,
                    uid=req.uid, stage=self._id)
        return 1

    def seed_rate_qps(self) -> float | None:
        """Deterministic service-rate floor before any history exists:
        one request per `min_step_s` step.  None when no floor is set."""
        return 1.0 / self.min_step_s if self.min_step_s > 0 else None

    def _inline_locked(self) -> Callable[[], int] | None:
        # a faulted compute closed the replica: nothing serves it inline
        return None if self._fault is not None else super()._inline_locked()

    def _dead_locked(self, n_missing: int) -> bool:
        return self._fault is not None and self._idle_locked()

    def stats(self) -> dict:
        with self._cond:
            busy = self._m_busy.value
            out = {
                "stage": self.name,
                **self._ledger_locked(len(self._queue) + self._in_flight),
                "queue_hwm": int(self._m_queue.hwm),
                "busy_s": busy,
            }
            if out["n"]:
                out.update(M.summarize_latency(self._lat_hist.samples(),
                                               busy))
                out["throughput_qps"] = out["n"] / busy if busy > 0 else 0.0
        return self._checked(out)


# ---------------------------------------------------------------------------
# The disaggregated server
# ---------------------------------------------------------------------------

class DisaggShedError(RuntimeError):
    """A synchronous `score_frame` query was shed; `.reason` carries the
    ledger reason ("queue_depth" / "deadline" / "fault" / "stopped")."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"disagg query shed ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


@dataclasses.dataclass
class DisaggResult:
    uid: int
    scores: np.ndarray                # (n_windows, 10) backend-native
    t_submit: float
    t_done: float
    cache_hit: bool
    deadline: float | None = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def within_deadline(self) -> bool:
        return self.deadline is None or self.t_done <= self.deadline


class DisaggServer(RequestLedger):
    """Disaggregated trunk/head window-scoring fleet (module docstring has
    the topology).  Pipeline-compatible: exposes `.params` / `.backend` /
    `.score_frame(frames)` so `StreamingPipeline` can drive it exactly
    where it drives the monolithic sweep, and the open-loop
    `submit`/`wait`/`pop_results`/`stats` contract so the goodput harness
    can replay arrival schedules against it.

    Dispatch is least-loaded over each pool with trunk failover: a query
    whose trunk request dies on a faulted replica retries on the next
    healthy one (the cache's single-flight leader re-election makes this
    safe under concurrency); only when EVERY replica of a pool has faulted
    is the query shed with reason "fault".

    `device` (default "cuda"; raises where there is no CUDA) is where both
    halves run: each trunk call moves its frame there once, and the cached
    quads stay there.  Construction warms both halves on it, which builds
    the kernels at first use, outside any timed window.

    `wait` never serves inline: the worker pool (`start()`) serves what
    `submit` queues.
    """

    _noun = "disagg queries"

    def __init__(self, params: Any, *,
                 backend: str | B.Backend = "fixed_cuda",
                 frame_shape: tuple[int, int] = (112, 112),
                 patch: int = 28, stride: int = 8,
                 megakernel: bool | None = None,
                 n_trunk: int = 2, n_head: int = 1,
                 cache_capacity: int = 64,
                 trunk_floor_s: float = 0.0, head_floor_s: float = 0.0,
                 max_queue: int | None = None,
                 n_workers: int | None = None,
                 warmup: bool = True,
                 device: torch.device | str | None = None):
        if n_trunk < 1 or n_head < 1:
            raise ValueError(f"DisaggServer needs at least one replica per "
                             f"pool, got n_trunk={n_trunk} n_head={n_head}")
        self.backend = B.get_backend(backend)
        self.device = resolve_device(device)
        self.params = self.backend.prepare_params(params, self.device)
        self.frame_shape = tuple(frame_shape)
        self.patch = int(patch)
        self.stride = int(stride)
        self.megakernel = megakernel
        self.max_queue = None if max_queue is None else int(max_queue)
        # the window lattice is the sweep's own (geometry contract included)
        sweep = fs.FcnSweep(patch=self.patch, stride=self.stride,
                            megakernel=megakernel)
        self.positions = tuple(sweep.positions(self.frame_shape))
        self._trunk_fn = fs.make_trunk_fn(self.backend, megakernel)
        self._head_fn = fs.make_head_fn(self.backend, self.patch,
                                        self.positions, megakernel)
        self.cache = FeatureMapCache(capacity=cache_capacity)

        def run_trunk(frames: np.ndarray):
            # cache entries stay backend-native tensors on the device: a
            # cache hit must skip the trunk without buying a device->host
            # ->device round trip per head call (re-uploading the quad
            # costs more than the head itself at smallNet scale).  The
            # device memory held is exactly what capacity/TTL bound.
            x = as_device_tensor(frames, self.device, dtype=torch.float32)
            return tuple(self._trunk_fn(self.params, x))

        def run_head(quad) -> np.ndarray:
            return self._head_fn(self.params, tuple(quad)).cpu().numpy()

        self._run_trunk = run_trunk
        self._run_head = run_head
        self.trunks = [StageEngine(run_trunk, name=f"trunk{i}",
                                   min_step_s=trunk_floor_s,
                                   max_queue=max_queue)
                       for i in range(n_trunk)]
        self.heads = [StageEngine(run_head, name=f"head{i}",
                                  min_step_s=head_floor_s,
                                  max_queue=max_queue)
                      for i in range(n_head)]
        # fleet-level intake + worker pool for the open-loop interface
        self._id = M.instance_label(f"disagg-{self.backend.name}")
        labels = {"server": self._id, "backend": self.backend.name}
        super().__init__("disagg", labels)
        self._intake: collections.deque = collections.deque()
        self._n_busy_workers = 0
        self._workers: list[threading.Thread] = []
        self._stop_flag = False
        self.n_workers = int(n_workers) if n_workers else max(2, n_trunk)
        self._m_queue = M.REGISTRY.gauge("disagg_intake_depth", **labels)
        if warmup:
            # build both halves' kernels outside the serving clock (the
            # trunk call doubles as the frame-geometry check)
            zeros = np.zeros((1,) + self.frame_shape + (1,), np.float32)
            self._run_head(self._run_trunk(zeros))

    # -- dispatch core ------------------------------------------------------

    @staticmethod
    def _healthy(pool: list[StageEngine]) -> list[StageEngine]:
        return [e for e in pool if e.fault is None]

    def _dispatch(self, pool: list[StageEngine], payload: Any,
                  deadline: float | None, parent_span: Any) -> Any:
        """Least-loaded dispatch with failover: submit to the least-loaded
        healthy replica, wait; a "fault" shed retries on the next healthy
        sibling.  Returns the stage result value; raises DisaggShedError
        when the request cannot be served."""
        tried: set[int] = set()
        while True:
            healthy = [e for e in self._healthy(pool)
                       if id(e) not in tried]
            if not healthy:
                raise DisaggShedError(
                    "fault", f"all {len(pool)} replicas faulted or tried")
            eng = min(healthy, key=lambda e: e.load())
            remaining_ms = None
            if deadline is not None:
                remaining_ms = (deadline - time.perf_counter()) * 1e3
                if remaining_ms <= 0:
                    raise DisaggShedError("deadline")
            uid = eng.submit(payload, deadline_ms=remaining_ms,
                             parent_span=parent_span)
            try:
                eng.wait([uid])
            except Exception:   # noqa: BLE001 — shed table is the truth
                # inline driving (no serving thread) re-raises the stage
                # compute's own exception after shedding the request as
                # "fault"; the threaded loop contains it instead.  Either
                # way the request's fate is in the shed table below.
                pass
            res = eng.pop_results([uid])
            if uid in res:
                return res[uid].value
            reason = eng.pop_shed([uid]).get(uid, "fault")
            if reason == "fault":
                tried.add(id(eng))      # failover to a sibling
                continue
            raise DisaggShedError(reason)

    def _trunk_quad(self, frames: np.ndarray, deadline: float | None,
                    parent_span: Any) -> tuple[Any, bool]:
        """(quad, cache_hit) through the cache's single-flight path."""
        key = feature_key(frames, self.backend, self.megakernel,
                          self.device.type)
        hit = True

        def compute():
            nonlocal hit
            hit = False
            return self._dispatch(self.trunks, frames, deadline,
                                  parent_span)

        timeout = (None if deadline is None
                   else max(0.0, deadline - time.perf_counter()))
        try:
            quad = self.cache.get_or_compute(key, compute, timeout=timeout)
        except TimeoutError as e:
            raise DisaggShedError("deadline", str(e)) from e
        return quad, hit

    def _score(self, frames: np.ndarray, deadline: float | None,
               parent_span: Any) -> tuple[np.ndarray, bool]:
        """The full chain: trunk (through the cache) then head."""
        quad, hit = self._trunk_quad(frames, deadline, parent_span)
        scores = self._dispatch(self.heads, quad, deadline, parent_span)
        return scores, hit

    # -- synchronous interface (what the pipeline drives) -------------------

    def score_frame(self, frames: np.ndarray, *,
                    deadline_ms: float | None = None,
                    parent_span: Any = None) -> np.ndarray:
        """One (1, H, W, 1) float frame batch -> (n_windows, 10)
        backend-native window scores in `positions` order — the monolithic
        `FcnSweep.score` contract, served disaggregated.  Raises
        `DisaggShedError` when the query is shed."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] != 1:
            raise ValueError(
                f"score_frame takes one frame per call (the trunk is a "
                f"per-frame program), got batch {frames.shape[0]}")
        if frames.shape[1:3] != self.frame_shape:
            raise ValueError(
                f"frame {frames.shape[1:3]} does not match the server's "
                f"geometry {self.frame_shape}")
        t0 = time.perf_counter()
        with self._cond:
            uid = self._admit_locked(t0, deadline_ms)
        deadline = t0 + deadline_ms / 1e3 if deadline_ms is not None else None
        try:
            scores, hit = self._score(frames, deadline, parent_span)
        except DisaggShedError as e:
            self._record_shed(uid, e.reason, t0, parent_span)
            raise
        self._record_served(uid, scores, t0, deadline, hit, parent_span)
        return scores

    # -- open-loop interface (what the goodput harness drives) --------------

    def submit(self, image: np.ndarray, *, deadline_ms: float | None = None,
               t_submit: float | None = None,
               parent_span: Any = None) -> int:
        """Queue one frame for asynchronous disagg scoring; returns its uid
        immediately.  Intake past `max_queue` is shed ("queue_depth") —
        the fleet is its own admission controller, like `VisionEngine`."""
        frames = np.asarray(image, np.float32)
        if frames.ndim == 2:
            frames = frames[..., None]
        if frames.ndim == 3:
            frames = frames[None]
        with self._cond:
            now = time.perf_counter() if t_submit is None else float(t_submit)
            uid = self._admit_locked(now, deadline_ms)
            deadline = (now + deadline_ms / 1e3
                        if deadline_ms is not None else None)
            if self.max_queue is not None \
                    and len(self._intake) >= self.max_queue:
                self._shed_locked(uid, "queue_depth", now,
                                  time.perf_counter(), parent_span)
            elif self._stop_flag or not self._workers:
                # submits before start() (or after stop) queue up only if
                # workers will exist to drain them; otherwise they shed
                if self._workers:
                    self._shed_locked(uid, "stopped", now,
                                      time.perf_counter(), parent_span)
                else:
                    self._intake.append(
                        (uid, frames, now, deadline, parent_span))
                    self._m_queue.set(len(self._intake))
            else:
                self._intake.append((uid, frames, now, deadline, parent_span))
                self._m_queue.set(len(self._intake))
                self._cond.notify_all()
            return uid

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._intake and not self._stop_flag:
                    self._cond.wait(timeout=0.05)
                if self._stop_flag and not self._intake:
                    return
                uid, frames, t_submit, deadline, parent_span = \
                    self._intake.popleft()
                self._m_queue.set(len(self._intake))
                self._n_busy_workers += 1
            try:
                if deadline is not None and time.perf_counter() > deadline:
                    self._record_shed(uid, "deadline", t_submit, parent_span)
                    continue
                try:
                    scores, hit = self._score(frames, deadline, parent_span)
                except DisaggShedError as e:
                    self._record_shed(uid, e.reason, t_submit, parent_span)
                    continue
                self._record_served(uid, scores, t_submit, deadline, hit,
                                    parent_span)
            finally:
                with self._cond:
                    self._n_busy_workers -= 1
                    self._cond.notify_all()

    def _record_served(self, uid: int, scores: np.ndarray, t_submit: float,
                       deadline: float | None, hit: bool,
                       parent_span: Any) -> None:
        t_done = time.perf_counter()
        with self._cond:
            res = DisaggResult(uid=uid, scores=scores, t_submit=t_submit,
                               t_done=t_done, cache_hit=hit,
                               deadline=deadline)
            self._results[uid] = res
            self._m_served.inc()
            self._lat_hist.observe(res.latency_s)
            self._t_last_done = t_done
            if deadline is not None and t_done <= deadline:
                self._deadline_ok += 1
            self._cond.notify_all()
        tr = T.get()
        if tr is not None:
            tid = (parent_span.trace_id if parent_span is not None
                   else f"disagg-{self._id}-{uid}")
            tr.emit("disagg_query", tid, t_submit, t_done, "served",
                    parent=parent_span, uid=uid, server=self._id,
                    cache_hit=hit)

    def _record_shed(self, uid: int, reason: str, t_submit: float,
                     parent_span: Any) -> None:
        t_end = time.perf_counter()
        with self._cond:
            self._shed_locked(uid, reason, t_submit, t_end, parent_span)

    def _shed_locked(self, uid: int, reason: str, t_submit: float,
                     t_end: float, parent_span: Any) -> None:
        self._shed_uid_locked(uid, reason)
        tr = T.get()
        if tr is not None:
            tid = (parent_span.trace_id if parent_span is not None
                   else f"disagg-{self._id}-{uid}")
            tr.emit("disagg_query", tid, t_submit, t_end,
                    f"shed:{reason}", parent=parent_span, uid=uid,
                    server=self._id)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DisaggServer":
        """Start every stage replica and the fleet worker pool."""
        for eng in self.trunks + self.heads:
            eng.start()
        with self._cond:
            if self._workers:
                return self
            self._stop_flag = False
            for i in range(self.n_workers):
                t = threading.Thread(target=self._worker_loop, daemon=True,
                                     name=f"disagg-worker-{i}")
                t.start()
                self._workers.append(t)
        return self

    def stop(self, drain: bool = True) -> None:
        with self._cond:
            workers = list(self._workers)
            self._stop_flag = True
            if not drain:
                now = time.perf_counter()
                while self._intake:
                    uid, _, t_submit, _, span = self._intake.popleft()
                    self._shed_locked(uid, "stopped", t_submit, now, span)
                self._m_queue.set(0)
            self._cond.notify_all()
        for t in workers:
            t.join(timeout=60.0)
        for eng in self.trunks + self.heads:
            eng.stop(drain=drain)
        with self._cond:
            self._workers = []
            self._stop_flag = False

    # -- reporting ----------------------------------------------------------

    def pending(self) -> int:
        with self._cond:
            return len(self._intake) + self._n_busy_workers

    def load(self) -> int:
        return self.pending()

    def stats(self) -> dict:
        """Fleet ledger + per-stage + cache stats.  The fleet invariant is
        over DISAGG queries (each may fan into several stage requests —
        stage ledgers reconcile per replica underneath)."""
        per_stage = {e.name: e.stats() for e in self.trunks + self.heads}
        with self._cond:
            served = self._m_served.value
            wall = ((self._t_last_done or 0.0)
                    - (self._t_first_submit or 0.0)) if served else 0.0
            out = {
                "backend": self.backend.name,
                "topology": {"trunk": len(self.trunks),
                             "head": len(self.heads),
                             "workers": self.n_workers},
                **self._ledger_locked(len(self._intake)
                                      + self._n_busy_workers),
                "queue_hwm": int(self._m_queue.hwm),
                "wall_s": wall,
                "cache": self.cache.stats(),
                "per_stage": per_stage,
                **self._deadline_stats_locked(),
            }
            if served:
                out.update(M.summarize_latency(self._lat_hist.samples(),
                                               wall))
                out["throughput_qps"] = served / wall if wall > 0 else 0.0
        return self._checked(out)

    # -- detection-parity helper (benchmarks, tests) ------------------------

    def detect(self, frame: "Frame | np.ndarray", *,
               tiler: fs.FcnSweep | None = None) -> list:
        """Detections from one frame through the disagg path, with the
        SAME aggregation semantics as the monolithic sweep (`Tiler
        .aggregate` over the identical window lattice) — the parity gates
        compare this output against `FcnSweep.detect`.  Pass the exact
        `tiler` being compared against to share its threshold/dedup
        settings; the default matches `FcnSweep`'s defaults."""
        sweep = tiler if tiler is not None else fs.FcnSweep(
            patch=self.patch, stride=self.stride,
            megakernel=self.megakernel)
        px = frame.pixels if isinstance(frame, Frame) else np.asarray(frame)
        if px.ndim == 2:
            px = px[..., None]
        scores = self.score_frame(px[None])
        return sweep.aggregate(scores, list(self.positions))
