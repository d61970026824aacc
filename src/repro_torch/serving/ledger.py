"""The serving layer's request ledger, and the serving queue two engines share.

Every server of the port answers its callers the same way: `submit`
returns a uid at once, and the uid resolves exactly once, as a result
(`pop_results`) or as a shed with its reason (`pop_shed`), so that the
no-silent-loss ledger holds:

    submitted == served + shed + pending        (stats()["accounted"])

`RequestLedger` keeps that bookkeeping for all four servers
(`VisionEngine`, `StageEngine`, `ReplicaRouter`, `DisaggServer`): the
condition variable, the result and shed tables, the uid counter, the
registry counters under each server's own names and labels, the pops and
one `wait` loop.  `ServingQueue` adds the bounded intake queue and the
serving thread of `VisionEngine` and `StageEngine`.  Each server keeps its
own request and result types, its step, its spans and its own `stats()`
keys.

The servers differ in `wait` in two ways only, which each states through a
hook: how it serves on the caller's thread when no serving thread runs
(`_inline_locked`, `_idle_locked`), and what it does once its serving
died (`_dead_locked`).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Iterable

from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T


class RequestLedger:
    """Results, sheds and waits of one server.

    `prefix` names the server's registry instruments (`<prefix>_submitted`,
    `<prefix>_served`, `<prefix>_shed` per reason, and
    `<prefix>_latency_seconds`), all under `labels`, which hold the
    server's instance label `self._id` (set before this runs).  `cond` is
    the server's one lock, a reentrant one where the server's locked code
    calls its own locking readers.  Every `_locked` method expects the
    caller to hold it."""

    _noun = "requests"      # what a TimeoutError of `wait` counts

    def __init__(self, prefix: str, labels: dict,
                 cond: threading.Condition | None = None):
        self._cond = threading.Condition() if cond is None else cond
        self._results: dict[int, Any] = {}
        self._shed: dict[int, str] = {}            # uid -> reason (unfetched)
        self._next_uid = 0
        self._deadline_total = 0                   # submits that carried one
        self._deadline_ok = 0                      # ...served in time
        self._t_first_submit: float | None = None
        self._t_last_done: float | None = None
        self._prefix, self._labels = prefix, labels
        reg = M.REGISTRY
        self._m_submitted = reg.counter(f"{prefix}_submitted", **labels)
        self._m_served = reg.counter(f"{prefix}_served", **labels)
        self._m_shed: dict[str, M.Counter] = {}    # reason -> Counter
        self._lat_hist = reg.histogram(f"{prefix}_latency_seconds", **labels)

    # -- recording ----------------------------------------------------------

    def _admit_locked(self, now: float, deadline_ms: float | None) -> int:
        """A new uid, counted as submitted at `now`."""
        uid = self._next_uid
        self._next_uid += 1
        self._m_submitted.inc()
        if self._t_first_submit is None:
            self._t_first_submit = now
        if deadline_ms is not None:
            self._deadline_total += 1
        return uid

    def _shed_uid_locked(self, uid: int, reason: str) -> None:
        """Resolve `uid` as shed for `reason`, counted per reason."""
        self._shed[uid] = reason
        c = self._m_shed.get(reason)
        if c is None:
            c = M.REGISTRY.counter(f"{self._prefix}_shed", reason=reason,
                                   **self._labels)
            self._m_shed[reason] = c
        c.inc()
        self._cond.notify_all()

    # -- client loop --------------------------------------------------------

    def _unresolved_locked(self, uids: list[int]) -> list[int]:
        return [u for u in uids
                if u not in self._results and u not in self._shed]

    def unresolved(self, uids: Iterable[int]) -> list[int]:
        """The uids of `uids` neither served nor shed yet (or popped)."""
        with self._cond:
            return self._unresolved_locked(list(uids))

    def _inline_locked(self) -> Callable[[], int] | None:
        """What serves on the caller's thread, now that no serving thread
        does: a call returning how many it served; None while a serving
        thread runs, or where nothing can serve inline."""
        return None

    def _idle_locked(self) -> bool:
        """Nothing is left that serving inline could still resolve."""
        return True

    def _dead_locked(self, n_missing: int) -> bool:
        """True when what is still unresolved never will be (the serving
        died); may raise instead."""
        return False

    def wait(self, uids: Iterable[int], timeout: float | None = None) -> None:
        """Block until every uid is resolved (served or shed).  While a
        serving thread runs this waits on its completions (TimeoutError
        after `timeout` seconds); without one, a server that can serve on
        the caller's thread does so, and a uid nothing will resolve raises
        KeyError."""
        uids = list(uids)
        t_end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while True:
                missing = self._unresolved_locked(uids)
                if not missing:
                    return
                serve = self._inline_locked()
                if serve is not None:
                    break
                if self._dead_locked(len(missing)):
                    return
                remaining = (None if t_end is None
                             else t_end - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{len(missing)} of {len(uids)} {self._noun} "
                        f"unresolved after {timeout}s")
                self._cond.wait(remaining if remaining is not None else 0.1)
        while True:
            served = serve()
            with self._cond:
                missing = self._unresolved_locked(uids)
                if not missing:
                    return
                if served == 0 and self._idle_locked():
                    raise KeyError(
                        f"uids {missing[:4]} are not queued, served, or "
                        "shed — were their results already popped?")

    def _pop_results_locked(self, uids: Iterable[int] | None) -> dict:
        if uids is None:
            out, self._results = self._results, {}
            return out
        return {u: self._results.pop(u) for u in list(uids)
                if u in self._results}

    def pop_results(self, uids: Iterable[int] | None = None) -> dict:
        """Hand over (and forget) completed results, the bounded-retention
        contract: a client popping as it goes keeps the server's resident
        result set O(in flight) over an unbounded stream.  `None` pops
        all."""
        with self._cond:
            return self._pop_results_locked(uids)

    def pop_shed(self, uids: Iterable[int] | None = None) -> dict[int, str]:
        """Hand over (and forget) shed records (uid -> reason).  The
        per-reason counts of `stats()` are unaffected."""
        with self._cond:
            if uids is None:
                out, self._shed = self._shed, {}
                return out
            return {u: self._shed.pop(u) for u in list(uids)
                    if u in self._shed}

    def results(self) -> dict:
        """Currently-retained (not yet popped) results."""
        with self._cond:
            return dict(self._results)

    # -- reporting ----------------------------------------------------------

    def _ledger_locked(self, pending: int) -> dict:
        """The ledger's keys of `stats()`, read back from the counters."""
        submitted, served = self._m_submitted.value, self._m_served.value
        shed_by = {r: c.value for r, c in sorted(self._m_shed.items())}
        shed = sum(shed_by.values())
        return {"n": served, "submitted": submitted, "shed": shed,
                "shed_by_reason": shed_by, "pending": pending,
                # the no-silent-loss invariant
                "accounted": submitted == served + shed + pending}

    def _deadline_stats_locked(self) -> dict:
        """Goodput under the deadlines: requests answered in time over
        every request that carried one (sheds count against it)."""
        if not self._deadline_total:
            return {}
        return {"deadline_total": self._deadline_total,
                "served_within_deadline": self._deadline_ok,
                "goodput": self._deadline_ok / self._deadline_total}

    def _checked(self, out: dict) -> dict:
        """`out`, once a broken ledger in it has tripped the flight
        recorder (when tracing is on).  Called without the lock."""
        if not out["accounted"]:
            tr = T.get()
            if tr is not None:
                tr.recorder.trip(
                    "ledger_invariant",
                    f"{self._prefix} {self._id}: "
                    f"submitted={out['submitted']} != served={out['n']} + "
                    f"shed={out['shed']} + pending={out['pending']}")
        return out


class ServingQueue(RequestLedger):
    """A request ledger fed by a bounded intake queue and served a step at
    a time, inline (`step()`) or on a serving thread (`start()`).

    The door sheds a request to a faulted server ("fault") or past
    `max_queue` ("queue_depth"); a step that raises on the serving thread
    kills it and sheds the queue ("fault"); `stop(drain=False)` sheds the
    queue ("stopped").  `min_step_s` is a service-time floor a step: a
    deterministic rate limiter, so a test of the router's dispatch has a
    known capacity whatever the host's speed (0 disables it; only tests
    set it).

    A subclass defines `_Request` (built as `_Request(uid, payload,
    t_submit, deadline, parent_span)`), `step()` (serve from the queue;
    return how many were served, keeping `_in_flight` while it computes),
    `_shed_span` and `seed_rate_qps`."""

    _Request: type

    def __init__(self, prefix: str, labels: dict, *, thread_name: str,
                 max_queue: int | None, min_step_s: float):
        super().__init__(prefix, labels)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.min_step_s = float(min_step_s)
        self._queue: collections.deque = collections.deque()
        self._in_flight = 0
        self._thread: threading.Thread | None = None
        self._thread_name = thread_name
        self._stop_flag = False
        self._fault: BaseException | None = None
        reg = M.REGISTRY
        self._m_busy = reg.counter(f"{prefix}_busy_seconds", **labels)
        self._m_queue = reg.gauge(f"{prefix}_queue_depth", **labels)

    # -- request side -------------------------------------------------------

    def submit(self, payload: Any, *, deadline_ms: float | None = None,
               t_submit: float | None = None, parent_span: Any = None) -> int:
        """Queue one request; returns its uid at once.  A shed request's
        uid resolves through `pop_shed()`.  `t_submit` stamps the request
        with its scheduled arrival (latency and deadline count from it);
        `parent_span` is the caller's trace context, under which the
        request's terminal span is emitted."""
        with self._cond:
            now = time.perf_counter() if t_submit is None else float(t_submit)
            uid = self._admit_locked(now, deadline_ms)
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
                self._queue.append(
                    self._Request(uid, payload, now, deadline, parent_span))
                self._m_queue.set(len(self._queue))
                self._cond.notify_all()
            return uid

    def _shed_locked(self, uid: int, reason: str,
                     t_submit: float, t_end: float, *,
                     parent_span: Any = None, queued: bool = False) -> None:
        """Shed `uid` and emit its terminal span (`queued`: it sat in the
        queue before)."""
        self._shed_uid_locked(uid, reason)
        tr = T.get()
        if tr is not None:
            self._shed_span(tr, uid, reason, t_submit, t_end, parent_span,
                            queued)

    def _shed_span(self, tr, uid: int, reason: str, t_submit: float,
                   t_end: float, parent_span: Any, queued: bool) -> None:
        raise NotImplementedError

    def _shed_queue_locked(self, reason: str) -> None:
        now = time.perf_counter()
        while self._queue:
            r = self._queue.popleft()
            self._shed_locked(r.uid, reason, r.t_submit, now,
                              parent_span=r.parent_span, queued=True)

    def _held_to_floor(self, t0: float, t_done: float) -> float:
        """A step's end: `t_done`, or the `min_step_s` floor from `t0`
        slept out (the floor IS the service time)."""
        if self.min_step_s > 0.0 and t_done - t0 < self.min_step_s:
            time.sleep(self.min_step_s - (t_done - t0))
            return time.perf_counter()
        return t_done

    # -- serving thread -----------------------------------------------------

    def start(self):
        """Spawn the serving thread, which serves a step whenever work is
        queued.  Idempotent."""
        with self._cond:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True, name=self._thread_name)
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
                    self._shed_queue_locked("fault")   # nothing will serve these
                    self._cond.notify_all()
                return

    def stop(self, drain: bool = True) -> None:
        """Stop the serving thread.  `drain=True` serves what's queued
        first; `drain=False` sheds it (reason "stopped")."""
        with self._cond:
            thread = self._thread
            self._stop_flag = True
            if not drain:
                self._shed_queue_locked("stopped")
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

    def service_rate_qps(self) -> float | None:
        """Observed service rate: requests served per second of BUSY time
        (idle gaps excluded).  None before any serving history exists —
        dispatch falls back to fleet statistics then."""
        with self._cond:
            if self._m_busy.value <= 0 or self._m_served.value == 0:
                return None
            return self._m_served.value / self._m_busy.value

    # -- wait's hooks -------------------------------------------------------

    def _inline_locked(self) -> Callable[[], int] | None:
        return self.step if self._thread is None else None

    def _idle_locked(self) -> bool:
        return not self._queue and not self._in_flight
