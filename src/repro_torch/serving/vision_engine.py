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

The queue, the door, the serving thread, the ledger and `wait` are the
`ServingQueue` of `serving/ledger.py`, which `StageEngine` shares.

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

import dataclasses
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
from repro_torch.serving.ledger import ServingQueue


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


class VisionEngine(ServingQueue):
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
    serving synchronously on the caller's thread.  On a dead serving
    thread, `wait` raises `EngineFaultError`.
    """

    _Request = VisionRequest

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
        self.max_age_ms = None if max_age_ms is None else float(max_age_ms)
        # quantize once at engine build (the paper bakes weights at
        # synthesis), once a device on a mesh
        self._shard_params = [self.backend.prepare_params(params, d)
                              for d in self._shard_devices]
        # the ledger's counters, the queue-depth gauge and the latency
        # histogram live in the process-wide registry under this engine's
        # unique instance label; stats() reads them back
        self._id = M.instance_label(f"eng-{self.backend.name}")
        labels = {"engine": self._id, "backend": self.backend.name}
        super().__init__("engine", labels, max_queue=max_queue,
                         min_step_s=min_step_s,
                         thread_name=f"vision-engine-{self.backend.name}")
        reg = M.REGISTRY
        self._m_batches = reg.counter("engine_batches", **labels)
        self._m_padded = reg.counter("engine_padded_slots", **labels)
        self._m_occupancy = reg.gauge("engine_batch_occupancy", **labels)
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
        return super().submit(
            np.asarray(image, np.float32).reshape(self.image_shape),
            deadline_ms=deadline_ms, t_submit=t_submit,
            parent_span=parent_span)

    def submit_many(self, images: Iterable[np.ndarray], *,
                    deadline_ms: float | None = None,
                    parent_span: Any = None) -> list[int]:
        return [self.submit(img, deadline_ms=deadline_ms,
                            parent_span=parent_span) for img in images]

    def _shed_span(self, tr, uid: int, reason: str, t_submit: float,
                   t_end: float, parent_span: Any, queued: bool) -> None:
        tid = (parent_span.trace_id if parent_span is not None
               else f"req-{self._id}-{uid}")
        span = tr.emit("request", tid, t_submit, t_end, f"shed:{reason}",
                       parent=parent_span, uid=uid, engine=self._id)
        if queued:   # the request sat in the queue before being shed
            tr.emit("queue_wait", tid, t_submit, t_end,
                    "expired" if reason in ("deadline", "age") else "ok",
                    parent=span)

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
        t_done = self._held_to_floor(
            t0, time.perf_counter() if ph is None else ph.end())
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

    # -- client loop --------------------------------------------------------

    def _dead_locked(self, n_missing: int) -> bool:
        if self._fault is not None:
            # the serving thread is dead and shed everything it knew about:
            # what is still unresolved never will be
            raise EngineFaultError(
                f"serving thread died; {n_missing} uids will never "
                "resolve") from self._fault
        return False

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
            pending = len(self._queue) + self._in_flight
            batches = self._m_batches.value
            padded = self._m_padded.value
            busy = self._m_busy.value
            slots = batches * self.batch_size
            served = self._m_served.value
            wall = ((self._t_last_done or 0.0)
                    - (self._t_first_submit or 0.0)) if served else 0.0
            out = {
                "backend": self.backend.name,
                **self._ledger_locked(pending),
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
                **self._deadline_stats_locked(),
            }
            if served:
                out.update(M.summarize_latency(self._lat_hist.samples(), busy))
                # percentiles come from the bounded reservoir (recent
                # window), but throughput must count EVERY served request —
                # recompute it from the exact counters
                out["throughput_qps"] = served / busy if busy > 0 else 0.0
        return self._checked(out)
