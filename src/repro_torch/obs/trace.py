"""Lightweight runtime spans: the per-frame waterfall of the serving stack.

A `Span` is one timed region on the monotonic clock (`perf_counter` — the
same clock every latency number in the repo is measured on, so span
durations and stats() latencies are directly comparable): name, trace id
(which frame / request it belongs to), span id + parent id (nesting),
tags, and a TERMINAL STATUS.  The status convention is the contract the
CI trace smoke reconciles against the serving ledgers:

  root spans ("frame", "request") end in exactly one terminal state —
  "served", "dropped:<stage>/<reason>", or "shed:<reason>" — matching the
  component's own accounting (pipeline `frames_in == served + dropped`,
  engine `submitted == served + shed + pending`).  Interior spans
  ("tile", "infer", "queue_wait", "device_step", ...) end "ok" unless the
  work they cover failed.

Tracing is OFF by default and costs one `trace.get()` (a module attribute
read) + None check per instrumentation site until `trace.enable()` turns
it on; enabling installs a process-wide `Tracer` whose finished spans land
in a bounded `recorder.FlightRecorder` ring.

The opt-in torch.profiler bridge (`profile_device_steps()`) wraps every
engine device step in `torch.profiler.record_function`, so a
`torch.profiler` trace of the card shows the same step boundaries the spans
do.  (Port of `repro.obs.trace`; only that bridge changed.)
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:                                      # pragma: no cover
    from repro_torch.obs.recorder import FlightRecorder


@dataclasses.dataclass(slots=True)
class Span:
    """One timed region.  `t_start`/`t_end` are perf_counter seconds;
    `status` is "open" until ended.  Slotted: span construction sits on
    the traced hot path (two spans per engine request), and the dict-free
    layout is worth ~0.5 µs per span there."""
    name: str
    trace_id: str
    span_id: int
    parent_id: int | None
    t_start: float
    t_end: float | None = None
    status: str = "open"
    tags: dict = dataclasses.field(default_factory=dict)

    @property
    def terminal(self) -> bool:
        """True for a span that records a request's FATE (the states the
        ledger reconciliation counts), not just a timed region."""
        return (self.status == "served" or self.status.startswith("shed:")
                or self.status.startswith("dropped:"))

    @property
    def duration_s(self) -> float | None:
        return None if self.t_end is None else self.t_end - self.t_start

    def to_dict(self) -> dict:
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "t_start": self.t_start, "t_end": self.t_end,
             "status": self.status}
        if self.tags:
            d["tags"] = self.tags
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(name=d["name"], trace_id=d["trace_id"],
                   span_id=d["span_id"], parent_id=d.get("parent_id"),
                   t_start=d["t_start"], t_end=d.get("t_end"),
                   status=d.get("status", "open"),
                   tags=d.get("tags", {}))

class Tracer:
    """Hands out spans and pushes finished ones to the flight recorder.
    Span ids are process-unique (an itertools counter — thread-safe under
    the GIL for the single `next()` bytecode); starting/ending a span
    never blocks on anything but the recorder ring append."""

    def __init__(self, recorder: "FlightRecorder"):
        self.recorder = recorder
        self._ids = itertools.count(1)
        self._record = recorder.record        # bound once: end() hot path

    def start(self, name: str, trace_id: str, *,
              parent: Span | None = None, **tags) -> Span:
        return Span(name=name, trace_id=trace_id,
                    span_id=next(self._ids),
                    parent_id=parent.span_id if parent is not None else None,
                    t_start=time.perf_counter(), tags=tags)

    def end(self, span: Span, status: str = "ok", **tags) -> Span:
        if span.t_end is not None:
            raise RuntimeError(f"span {span.name}#{span.span_id} already "
                               f"ended ({span.status!r})")
        span.t_end = time.perf_counter()
        span.status = status
        if tags:
            span.tags.update(tags)
        self._record(span)
        return span

    def end_at(self, span: Span, t: float, status: str = "ok") -> Span:
        """Fast-path end with a pre-read clock value: hot loops (the engine
        ending a whole batch's request spans at one step boundary) pay one
        perf_counter read and no tag kwargs for the lot.  Tags can be set
        directly on `span.tags` before the call."""
        if span.t_end is not None:
            raise RuntimeError(f"span {span.name}#{span.span_id} already "
                               f"ended ({span.status!r})")
        span.t_end = t
        span.status = status
        self._record(span)
        return span

    def emit(self, name: str, trace_id: str, t_start: float, t_end: float,
             status: str = "ok", *, parent: Span | None = None,
             **tags) -> Span:
        """Materialize an already-finished span from timestamps recorded
        elsewhere: one allocation + one ring append, no clock reads.  The
        engine's per-request spans use this — the request path records
        plain floats (t_submit, batch formation, step completion) and the
        spans are built once, at batch completion, OFF the submit critical
        path."""
        # manual slot assignment instead of the dataclass __init__: this
        # runs twice per engine request and the generated __init__'s call
        # overhead is measurable there (~0.7 us/span)
        s = object.__new__(Span)
        s.name = name
        s.trace_id = trace_id
        s.span_id = next(self._ids)
        s.parent_id = parent.span_id if parent is not None else None
        s.t_start = t_start
        s.t_end = t_end
        s.status = status
        s.tags = tags
        self._record(s)
        return s

    def point(self, name: str, trace_id: str, status: str = "ok", *,
              parent: Span | None = None, **tags) -> Span:
        """A zero-duration event span (a dispatch decision, an
        at-the-door shed): started and ended at the same instant."""
        return self.end(self.start(name, trace_id, parent=parent, **tags),
                        status)

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str, *,
             parent: Span | None = None, **tags):
        s = self.start(name, trace_id, parent=parent, **tags)
        try:
            yield s
        except BaseException:
            self.end(s, "error")
            raise
        self.end(s)


# -- the process-wide switch --------------------------------------------------

_TRACER: Tracer | None = None


def enable(capacity: int = 65536, *,
           dump_dir: str | None = None) -> Tracer:
    """Install (or replace) the process-wide tracer over a fresh bounded
    flight-recorder ring.  Returns the tracer (its `.recorder` is where
    dumps come from).  Idempotent in effect — calling again starts a new
    ring."""
    from repro_torch.obs.recorder import FlightRecorder
    global _TRACER
    _TRACER = Tracer(FlightRecorder(capacity=capacity, dump_dir=dump_dir))
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def get() -> Tracer | None:
    """The process-wide tracer, or None when tracing is off.  Every
    instrumentation site is `tr = trace.get()` + `if tr is not None` — the
    whole cost of the subsystem when disabled."""
    return _TRACER


# -- torch.profiler bridge ----------------------------------------------------

_PROFILE_STEPS = False


def profile_device_steps(on: bool = True) -> None:
    """Opt in to wrapping every engine device step in a
    `torch.profiler.record_function` range so spans and profiler timelines
    line up.  Off by default: a range costs a little even without a live
    profiler session."""
    global _PROFILE_STEPS
    _PROFILE_STEPS = bool(on)


def device_step_annotation(name: str):
    """Context manager for the engine's device step: a profiler range when
    `profile_device_steps()` is on, a nullcontext otherwise."""
    if _PROFILE_STEPS:
        import torch.profiler
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
