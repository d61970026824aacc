"""Streaming vision serving engine: continuous batching over async requests.

Port of `repro.serving.vision_engine` to PyTorch.  The reference's
`jax.jit` step becomes an eager torch step on the engine's explicit
`device` ("cuda" unless the caller asks for the CPU), which synchronizes
before `t_done` in place of `block_until_ready`; `warmup` builds and
launches the kernels outside the serving clock.  Everything else —
batching, admission sheds, the ledger, the spans — is the reference's.

Pass a serving mesh (`launch/mesh.make_serving_mesh`) in place of `device`
and each step's batch is split across the mesh's batch axes (the vision
rules of `distributed/sharding.py`): `batch_size` is rounded UP to a
multiple of `vision_batch_multiple(mesh)`, the params are prepared once a
device, every shard is launched on its device before any is waited for
(`smallnet.apply_sharded`), and the scores are gathered in order.  The
words equal the unsharded engine's, whose step is the same over one
shard.  For fleets of engines see `serving/router.py`.

The GPU analogue of the paper's deployment loop — there, pixels stream from
the PS over a DMA-FIFO into the fabric and classifications stream back; here,
single-image classification requests stream into a queue and every `step()`
forms one batch from WHATEVER is queued at that instant (continuous
batching: no wave boundaries, no drain/reopen churn), zero-pads it to the
engine's fixed `batch_size` (one set of kernel shapes per engine — the
FIFO depth is the batch size), runs one step of `smallnet.apply`
on any registered backend, and streams per-request results back with latency
accounting.

Under real load the engine is also the ADMISSION CONTROLLER: `max_queue`
bounds the intake (an arrival past the bound is shed immediately, reason
"queue_depth"), `max_age_ms` and per-request deadlines shed stale requests
at batch-forming time (reasons "age"/"deadline"), and a faulted step sheds
its batch (reason "fault") instead of losing it.  Every shed is counted per
reason and the pipeline's no-silent-loss invariant extends to the engine:

    submitted == served + shed + pending        (stats()["accounted"])

Serving runs either synchronously (`step()`/`run()` on the caller's thread)
or continuously (`start()` spawns a serving thread that batches whatever
arrives; `submit()` + `wait()` + `pop_results()` is the client loop —
`serve()` wraps all three).  Results are handed over by `pop_results()`, so
memory stays O(inflight), not O(stream length); latency/throughput stats
accumulate in O(1)-per-request accumulators independent of retention.

Throughput is reported over BUSY time (the sum of per-step serving windows),
not the submit-to-done wall clock, so an engine reused across separated
bursts reports its real service rate instead of one deflated by idle gaps —
`stats()` also reports the wall window (first submit to last completion),
which includes the host work after each step.  `load()`,
`service_rate_qps()` and `seed_rate_qps()` (the capacity the `min_step_s`
floor sets) are the dispatch signals of `serving/router.py`, which scales
across separate engines.

Usage:

    eng = VisionEngine(params, backend="fixed_cuda", batch_size=64,
                       max_queue=128)                # device="cuda"
    eng.start()                                      # continuous batching
    uids = [eng.submit(img, deadline_ms=50) for img in images]
    eng.wait(uids)
    res = eng.pop_results(uids)                      # uid -> VisionResult
    print(eng.stats())                               # latency + goodput
    eng.stop()
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core import backends as B
from repro_torch.core import smallnet
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T


def latency_stats(latencies_s, window_s: float) -> dict:
    """The shared latency/throughput block of engine AND fleet stats():
    mean/p50/p95/p99/max in ms + qps over the `window_s`-second serving
    window.  A zero-length window yields 0.0 qps (a single instantaneous
    batch has no measurable rate — never inf); an empty latency set raises
    (callers must guard the n == 0 case explicitly).  Percentiles are
    NEAREST-RANK via the one shared helper (`obs.metrics.percentile`) —
    the same semantics as every other latency summary in the repo."""
    return M.summarize_latency(latencies_s, window_s)


class EngineFaultError(RuntimeError):
    """The serving thread died: the device step raised.  Queued and future
    submits are shed with reason "fault" (accounting still reconciles); the
    original exception is chained as __cause__."""


@dataclasses.dataclass
class VisionRequest:
    uid: int
    image: np.ndarray                 # (28, 28, 1) float32
    t_submit: float = 0.0
    deadline: float | None = None     # absolute perf_counter time, or None
    parent_span: Any = None           # caller's trace context (traced runs)


@dataclasses.dataclass
class VisionResult:
    uid: int
    pred: int                         # Max Finder output
    scores: np.ndarray                # (10,) backend-native class scores
    t_submit: float
    t_done: float
    batch_index: int                  # which engine step served it
    deadline: float | None = None     # absolute deadline it was held to

    @property
    def latency_s(self) -> float:
        """Queue wait + batch compute (what the client observes)."""
        return self.t_done - self.t_submit

    @property
    def within_deadline(self) -> bool:
        """True when served in time (vacuously true without a deadline)."""
        return self.deadline is None or self.t_done <= self.deadline


class VisionEngine:
    """Continuously-batched streaming classifier over any smallNet backend.

    Requests submitted via `submit()` queue up (or are shed at the
    admission bound); each `step()` pops up to `batch_size` of them —
    shedding any whose deadline/age already expired — zero-pads to exactly
    `batch_size` (static shapes for every kernel launch), runs the forward
    on `device`, and timestamps completions after a device synchronize so
    reported latency is honest wall clock.

    Thread model: all bookkeeping lives under one condition variable; the
    device compute runs outside it, so submitters never block on the
    accelerator.  `start()`/`stop()` run the step loop on a daemon thread
    (continuous batching); without it, `step()`/`run()`/`wait()` drive
    serving synchronously on the caller's thread.
    """

    def __init__(self, params: Any, *, backend: str | B.Backend = "fixed_cuda",
                 batch_size: int = 32, image_shape=(28, 28, 1),
                 warmup: bool = True, mesh: Any = None,
                 device: torch.device | str | None = None,
                 max_queue: int | None = None,
                 max_age_ms: float | None = None,
                 min_step_s: float = 0.0):
        self.backend = B.get_backend(backend)
        self.image_shape = tuple(image_shape)
        self.mesh = mesh
        self.batch_size = int(batch_size)
        if mesh is None:
            self._shard_devices = [resolve_device(device)]
        else:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both")
            if mesh.devices is None:
                raise ValueError("an abstract mesh has no devices to serve on")
            mult = shd.vision_batch_multiple(mesh)
            self.batch_size = -(-self.batch_size // mult) * mult
            self._shard_devices = shd.vision_batch_devices(mesh)
        self.device = self._shard_devices[0]
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_age_ms = None if max_age_ms is None else float(max_age_ms)
        # service-time floor per step: a deterministic rate limiter
        # (capacity = batch_size / min_step_s), so a test of the router's
        # dispatch has a known capacity whatever the host's speed.  Only
        # the tests that mirror the reference's dispatch tests set it; no
        # path of the port does.  0 disables
        self.min_step_s = float(min_step_s)
        # quantize once at engine build (the paper bakes weights at
        # synthesis), once a device on a mesh
        self._shard_params = [self.backend.prepare_params(params, d)
                              for d in self._shard_devices]
        self._cond = threading.Condition()
        self._queue: collections.deque[VisionRequest] = collections.deque()
        self._results: dict[int, VisionResult] = {}
        self._shed: dict[int, str] = {}            # uid -> reason (unfetched)
        # -- registry-backed accounting (repro/obs/metrics.py): the ledger
        # counters, queue-depth gauge, and latency histogram live in the
        # process-wide registry under this engine's unique instance label
        # (Prometheus-exportable, bounded memory — the latency list used to
        # grow per request forever).  stats() reads these back; the ledger
        # invariant submitted == served + shed + pending is computed over
        # the counter values.
        self._id = M.instance_label(f"eng-{self.backend.name}")
        reg = M.REGISTRY
        labels = {"engine": self._id, "backend": self.backend.name}
        self._m_submitted = reg.counter("engine_submitted", **labels)
        self._m_served = reg.counter("engine_served", **labels)
        self._m_shed: dict[str, M.Counter] = {}    # reason -> Counter
        self._m_batches = reg.counter("engine_batches", **labels)
        self._m_padded = reg.counter("engine_padded_slots", **labels)
        self._m_busy = reg.counter("engine_busy_seconds", **labels)
        self._m_queue = reg.gauge("engine_queue_depth", **labels)
        self._m_occupancy = reg.gauge("engine_batch_occupancy", **labels)
        self._lat_hist = reg.histogram("engine_latency_seconds", **labels)
        self._next_uid = 0
        self._in_flight = 0
        self._deadline_total = 0                   # submits that carried one
        self._deadline_ok = 0                      # ...served in time
        self._t_first_submit: float | None = None
        self._t_last_done: float | None = None
        self._thread: threading.Thread | None = None
        self._stop_flag = False
        self._fault: BaseException | None = None
        if warmup:     # build and launch the kernels outside the serving clock
            self._step_fn(np.zeros((self.batch_size,) + self.image_shape,
                                   np.float32))

    @property
    def params(self):
        """The backend-native params on the first device (the handle the
        streaming pipeline takes)."""
        return self._shard_params[0]

    def _step_fn(self, batch: np.ndarray,
                 phases: T.Phases | None = None) -> torch.Tensor:
        """One forward over a padded host batch, split in one shard a device
        (one shard without a mesh); returns the scores gathered in order on
        the first device once every device is done (the synchronize stands
        in for `block_until_ready`).  A traced step passes its `phases`,
        which this moves from the upload to "forward" (the launches and the
        gather) and to "device_wait" (the synchronize), which the caller
        ends."""
        devs = self._shard_devices
        with torch.inference_mode():
            shards = [torch.from_numpy(part).to(dev)
                      for part, dev in zip(np.split(batch, len(devs)), devs)]
            if phases is not None:
                phases.to("forward")
            scores = smallnet.apply_sharded(self._shard_params, shards, backend=self.backend)
            scores = torch.cat([s.to(self.device) for s in scores])
        if phases is not None:
            phases.to("device_wait")
        for dev in dict.fromkeys(devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return scores

    # -- request side -------------------------------------------------------

    def submit(self, image: np.ndarray, *, deadline_ms: float | None = None,
               t_submit: float | None = None, parent_span: Any = None) -> int:
        """Queue one image; returns its uid immediately (async).  A request
        past the admission bound (or to a faulted engine) is SHED — the uid
        resolves via `pop_shed()` instead of `pop_results()`, so accounting
        always reconciles.  `t_submit` lets an open-loop replay harness
        stamp the request with its scheduled arrival time (latency and
        deadlines then measure from intended arrival, not generator lag).
        With tracing on, the request yields a root "request" span (exactly
        one terminal state, served/shed:<reason>) nested under
        `parent_span` when the caller supplies its own trace context (the
        streaming pipeline passes the frame's root span).  The span is
        materialized at the request's terminal point from the timestamps
        the engine records anyway — submit itself does no tracer work."""
        img = np.asarray(image, np.float32).reshape(self.image_shape)
        with self._cond:
            uid = self._next_uid
            self._next_uid += 1
            self._m_submitted.inc()
            now = time.perf_counter() if t_submit is None else float(t_submit)
            if self._t_first_submit is None:
                self._t_first_submit = now
            if deadline_ms is not None:
                self._deadline_total += 1
            # Tracing adds NOTHING here: the request path records plain
            # floats (t_submit) and the caller's span ref; the "request" /
            # "queue_wait" spans are materialized at their terminal point
            # (step completion or shed) via Tracer.emit, keeping the
            # submit critical path span-free.
            if self._fault is not None:
                self._shed_locked(uid, "fault", now, now,
                                  parent_span=parent_span)
            elif (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                self._shed_locked(uid, "queue_depth", now, now,
                                  parent_span=parent_span)
            else:
                deadline = (now + deadline_ms / 1e3
                            if deadline_ms is not None else None)
                self._queue.append(VisionRequest(
                    uid=uid, image=img, t_submit=now, deadline=deadline,
                    parent_span=parent_span))
                self._m_queue.set(len(self._queue))
                self._cond.notify_all()
            return uid

    def submit_many(self, images: Iterable[np.ndarray], *,
                    deadline_ms: float | None = None,
                    parent_span: Any = None) -> list[int]:
        return [self.submit(img, deadline_ms=deadline_ms,
                            parent_span=parent_span) for img in images]

    def _shed_locked(self, uid: int, reason: str,
                     t_submit: float, t_end: float, *,
                     parent_span: Any = None, queued: bool = False) -> None:
        self._shed[uid] = reason
        c = self._m_shed.get(reason)
        if c is None:
            c = M.REGISTRY.counter("engine_shed", reason=reason,
                                   engine=self._id,
                                   backend=self.backend.name)
            self._m_shed[reason] = c
        c.inc()
        tr = T.get()
        if tr is not None:
            tid = (parent_span.trace_id if parent_span is not None
                   else f"req-{self._id}-{uid}")
            span = tr.emit("request", tid, t_submit, t_end,
                           f"shed:{reason}", parent=parent_span, uid=uid,
                           engine=self._id)
            if queued:   # the request sat in the queue before being shed
                tr.emit("queue_wait", tid, t_submit, t_end,
                        "expired" if reason in ("deadline", "age") else "ok",
                        parent=span)
        self._cond.notify_all()

    # -- serving side -------------------------------------------------------

    def _form_batch_locked(self) -> list[VisionRequest]:
        """Pop up to batch_size live requests; shed expired ones in passing
        (their deadline already lapsed or they outlived max_age_ms — serving
        them would burn a slot on an answer nobody can use)."""
        reqs: list[VisionRequest] = []
        now = time.perf_counter()
        while self._queue and len(reqs) < self.batch_size:
            r = self._queue.popleft()
            if r.deadline is not None and now > r.deadline:
                self._shed_locked(r.uid, "deadline", r.t_submit, now,
                                  parent_span=r.parent_span, queued=True)
            elif (self.max_age_ms is not None
                    and (now - r.t_submit) * 1e3 > self.max_age_ms):
                self._shed_locked(r.uid, "age", r.t_submit, now,
                                  parent_span=r.parent_span, queued=True)
            else:
                reqs.append(r)
        self._m_queue.set(len(self._queue))
        return reqs

    def step(self) -> int:
        """Serve one continuous batch: coalesce whatever is queued (up to
        batch_size), pad, run the device step, record results. Returns
        #requests served (sheds don't count)."""
        tr = T.get()
        batch_idx = self._m_batches.value
        bf = (tr.start("batch_form", f"step-{self._id}-{batch_idx}",
                       batch_index=batch_idx, engine=self._id)
              if tr is not None else None)
        with self._cond:
            reqs = self._form_batch_locked()
            if not reqs:
                if bf is not None:
                    tr.end(bf, n_formed=0)
                return 0
            self._in_flight = len(reqs)
        if bf is not None:
            tr.end(bf, n_formed=len(reqs))
        t0 = time.perf_counter()
        ds = ph = None
        if tr is not None:
            # the step's phases: "upload" (the padded batch, its rows, the
            # copy to the card), then "forward" and "device_wait", which
            # `_step_fn` moves to
            ds = tr.start("device_step", f"step-{self._id}-{batch_idx}",
                          batch_index=batch_idx, engine=self._id,
                          n_real=len(reqs),
                          padded=self.batch_size - len(reqs))
            ph = T.Phases(tr, ds, "upload", ds.t_start)
        try:
            batch = np.zeros((self.batch_size,) + self.image_shape, np.float32)
            for i, r in enumerate(reqs):
                batch[i] = r.image
            # untraced, the step is called as `_step_fn(batch)`, the form
            # a stand-in step (a test's, a fault's) takes
            scores = (self._step_fn(batch) if ph is None
                      else self._step_fn(batch, ph))
        except Exception:
            # a faulted step sheds its batch (reason "fault") rather than
            # losing it: submitted == served + shed + pending must survive
            # replica death (the router treats "fault" sheds as unserved
            # and fails them over)
            if ds is not None:
                tr.end(ds, "error")
            with self._cond:
                self._in_flight = 0
                now = time.perf_counter()
                for r in reqs:
                    self._shed_locked(r.uid, "fault", r.t_submit, now,
                                      parent_span=r.parent_span, queued=True)
            raise
        t_done = time.perf_counter() if ph is None else ph.end()
        if self.min_step_s > 0.0 and t_done - t0 < self.min_step_s:
            time.sleep(self.min_step_s - (t_done - t0))
            t_done = time.perf_counter()     # the floor IS the service time
        if ds is not None:
            tr.end_at(ds, t_done)
        scores_cpu = scores.cpu()                   # one copy back per step
        preds = smallnet.predict(scores_cpu).numpy()
        scores_np = scores_cpu.numpy()
        with self._cond:
            self._m_busy.inc(t_done - t0)
            self._t_last_done = t_done
            for i, r in enumerate(reqs):
                res = VisionResult(
                    uid=r.uid, pred=int(preds[i]), scores=scores_np[i],
                    t_submit=r.t_submit, t_done=t_done,
                    batch_index=batch_idx, deadline=r.deadline)
                self._results[r.uid] = res
                self._lat_hist.observe(res.latency_s)
                if r.deadline is not None and t_done <= r.deadline:
                    self._deadline_ok += 1
            self._m_served.inc(len(reqs))
            self._m_batches.inc()
            self._m_padded.inc(self.batch_size - len(reqs))
            slots = self._m_batches.value * self.batch_size
            self._m_occupancy.set((slots - self._m_padded.value) / slots)
            self._in_flight = 0
            self._cond.notify_all()
        if tr is not None:
            # "finish": the copy back, predict and the results published,
            # from the device step's end; it ends before the request spans
            # below, so the tracer's own work is not in it
            tr.emit("finish", ds.trace_id, ds.t_end, time.perf_counter(),
                    batch_index=batch_idx, engine=self._id)
            # materialize the batch's request/queue_wait spans AFTER the
            # waiters are released, from timestamps the engine recorded
            # anyway (t_submit, batch formation, t_done): the traced submit
            # path allocates nothing, and t_done precedes the frame root's
            # end so parent-window nesting still holds
            t_formed = bf.t_end if bf is not None else t0
            for r in reqs:
                tid = (r.parent_span.trace_id if r.parent_span is not None
                       else f"req-{self._id}-{r.uid}")
                span = tr.emit("request", tid, r.t_submit, t_done, "served",
                               parent=r.parent_span, uid=r.uid,
                               batch_index=batch_idx)
                tr.emit("queue_wait", tid, r.t_submit, t_formed,
                        parent=span)
        return len(reqs)

    def run(self) -> int:
        """Synchronously drain the current queue in continuous batches;
        returns #requests served.  The intake stays open — submits during
        and after the drain serve on the next step (no wave lifecycle)."""
        served = 0
        while True:
            n = self.step()
            served += n
            if n == 0:
                with self._cond:
                    if not self._queue:
                        return served

    # -- continuous serving thread ------------------------------------------

    def start(self) -> "VisionEngine":
        """Spawn the continuous-batching loop: a daemon thread that forms a
        batch from whatever is queued whenever work exists.  Idempotent."""
        with self._cond:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True,
                name=f"vision-engine-{self.backend.name}")
            self._thread.start()
        return self

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop_flag:
                    self._cond.wait(timeout=0.05)
                if self._stop_flag and not self._queue:
                    return
            try:
                self.step()
            except Exception as e:   # noqa: BLE001 — any step fault kills serving
                with self._cond:
                    self._fault = e
                    now = time.perf_counter()
                    while self._queue:     # nothing will ever serve these
                        r = self._queue.popleft()
                        self._shed_locked(r.uid, "fault", r.t_submit, now,
                                          parent_span=r.parent_span,
                                          queued=True)
                    self._cond.notify_all()
                return

    def stop(self, drain: bool = True) -> None:
        """Stop the serving thread.  `drain=True` serves what's queued
        first; `drain=False` sheds it (reason "stopped").  No-op when no
        thread is running."""
        with self._cond:
            thread = self._thread
            self._stop_flag = True
            if not drain:
                now = time.perf_counter()
                while self._queue:
                    r = self._queue.popleft()
                    self._shed_locked(r.uid, "stopped", r.t_submit, now,
                                      parent_span=r.parent_span, queued=True)
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=60.0)
            with self._cond:
                self._thread = None
                self._stop_flag = False

    @property
    def started(self) -> bool:
        return self._thread is not None

    @property
    def fault(self) -> BaseException | None:
        return self._fault

    def queue_depth(self) -> int:
        return len(self._queue)

    def load(self) -> int:
        """Queued + in-flight requests: the router's depth signal."""
        with self._cond:
            return len(self._queue) + self._in_flight

    # -- client loop --------------------------------------------------------

    def wait(self, uids: Iterable[int], timeout: float | None = None) -> None:
        """Block until every uid is resolved (served or shed).  With the
        serving thread running this waits on its completions; without it,
        serving is driven inline on the caller's thread."""
        uids = list(uids)

        def unresolved_locked():
            return [u for u in uids
                    if u not in self._results and u not in self._shed]

        if self._thread is None:
            while True:
                with self._cond:
                    missing = unresolved_locked()
                    if not missing:
                        return
                if self.step() == 0:
                    with self._cond:
                        missing = unresolved_locked()
                        if missing and not self._queue and not self._in_flight:
                            raise KeyError(
                                f"uids {missing[:4]} are not queued, served, "
                                "or shed — were their results already "
                                "popped by another caller?")
        t_end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while unresolved_locked():
                if self._fault is not None:
                    # the serving thread is dead and shed everything it
                    # knew about — what's still unresolved never will be
                    raise EngineFaultError(
                        f"serving thread died; {len(unresolved_locked())} "
                        "uids will never resolve") from self._fault
                remaining = (None if t_end is None
                             else t_end - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{len(unresolved_locked())} of {len(uids)} requests "
                        f"unresolved after {timeout}s")
                self._cond.wait(remaining if remaining is not None else 0.1)

    def pop_results(self, uids: Iterable[int] | None = None
                    ) -> dict[int, VisionResult]:
        """Hand over (and forget) completed results — the bounded-retention
        contract: a pipeline popping per wave keeps the engine's resident
        result set O(batch) over an unbounded stream.  `None` pops all."""
        with self._cond:
            if uids is None:
                out, self._results = self._results, {}
                return out
            return {u: self._results.pop(u) for u in list(uids)
                    if u in self._results}

    def pop_shed(self, uids: Iterable[int] | None = None) -> dict[int, str]:
        """Hand over (and forget) shed records (uid -> reason).  Aggregate
        per-reason counts in stats() are unaffected."""
        with self._cond:
            if uids is None:
                out, self._shed = self._shed, {}
                return out
            return {u: self._shed.pop(u) for u in list(uids)
                    if u in self._shed}

    def serve(self, images: Iterable[np.ndarray], *,
              deadline_ms: float | None = None, parent_span: Any = None
              ) -> list["VisionResult | None"]:
        """Convenience client loop: submit a workload, wait for it, pop the
        results, return them in submission order (None where a request was
        shed).  Works with or without the serving thread."""
        uids = self.submit_many(images, deadline_ms=deadline_ms,
                                parent_span=parent_span)
        self.wait(uids)
        res = self.pop_results(uids)
        self.pop_shed(uids)
        return [res.get(u) for u in uids]

    # -- reporting ----------------------------------------------------------

    def results(self) -> dict[int, VisionResult]:
        """Currently-retained (not yet popped) results."""
        with self._cond:
            return dict(self._results)

    def service_rate_qps(self) -> float | None:
        """Observed service rate: requests served per second of BUSY time
        (idle gaps excluded).  None before any serving history exists —
        the router's dispatch falls back to fleet statistics then."""
        with self._cond:
            if self._m_busy.value <= 0 or self._m_served.value == 0:
                return None
            return self._m_served.value / self._m_busy.value

    def seed_rate_qps(self) -> float | None:
        """Deterministic service-rate bound available BEFORE any serving
        history: the `min_step_s` floor admits at most one batch per floor
        period, so capacity is batch_size / min_step_s.  None when no floor
        is configured.  This is the router's cold-start dispatch signal —
        without it a cold fleet projects 0.0 wait for any backlog and the
        slo door never sheds (the cold-fleet SLO hole)."""
        if self.min_step_s > 0.0:
            return self.batch_size / self.min_step_s
        return None

    def stats(self) -> dict:
        """Per-request latency distribution + engine throughput + the
        admission ledger (submitted == served + shed + pending), read back
        from the registry instruments.  A broken ledger trips the flight
        recorder (when tracing is on) before it is reported."""
        with self._cond:
            submitted = self._m_submitted.value
            served = self._m_served.value
            shed_by = {r: c.value for r, c in sorted(self._m_shed.items())}
            shed_total = sum(shed_by.values())
            pending = len(self._queue) + self._in_flight
            batches = self._m_batches.value
            padded = self._m_padded.value
            busy = self._m_busy.value
            slots = batches * self.batch_size
            wall = ((self._t_last_done or 0.0)
                    - (self._t_first_submit or 0.0)) if served else 0.0
            accounted = submitted == served + shed_total + pending
            out = {
                "backend": self.backend.name,
                "n": served,
                "submitted": submitted,
                "shed": shed_total,
                "shed_by_reason": shed_by,
                "pending": pending,
                # the engine-level no-silent-loss invariant
                "accounted": accounted,
                "batch_size": self.batch_size,
                "batches": batches,
                "padded_slots": padded,
                # real images / total slots across every step: the fraction
                # of compute spent on real work vs zero padding (stream
                # benchmarks report this as pad waste)
                "batch_occupancy":
                    (slots - padded) / slots if slots else 0.0,
                "queue_hwm": int(self._m_queue.hwm),
                "device": str(self.device),
                "mesh_devices": len(self._shard_devices),     # the ones that compute
                # busy = sum of per-step serving windows; wall spans idle
                # gaps too, so throughput is reported over busy time (an
                # engine serving two bursts an hour apart still reports its
                # real service rate, not served/3600)
                "busy_s": busy,
                "wall_s": wall,
            }
            if self._deadline_total:
                out["deadline_total"] = self._deadline_total
                out["served_within_deadline"] = self._deadline_ok
                # goodput under the latency SLO: requests answered in time
                # over everything that asked (sheds count against it)
                out["goodput"] = self._deadline_ok / self._deadline_total
            if served:
                out.update(latency_stats(self._lat_hist.samples(), busy))
                # percentiles come from the bounded reservoir (recent
                # window), but throughput must count EVERY served request —
                # recompute it from the exact counters
                out["throughput_qps"] = served / busy if busy > 0 else 0.0
        if not accounted:
            tr = T.get()
            if tr is not None:
                tr.recorder.trip(
                    "ledger_invariant",
                    f"engine {self._id}: submitted={submitted} != "
                    f"served={served} + shed={shed_total} + "
                    f"pending={pending}")
        return out
