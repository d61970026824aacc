"""Flight recorder: a bounded ring of recent spans + crash-dump triggers.

A copy of `repro.obs.recorder` (the port imports nothing from `repro`);
keep the two in step.

The recorder is the retention policy of the tracing layer: finished spans
land in a `deque(maxlen=capacity)` — a year of serving retains exactly as
many spans as the last `capacity` finished ones — and the ring dumps
itself to JSONL when something goes wrong:

  trip("slo_violation", ...)      a frame blew its deadline
  trip("ledger_invariant", ...)   an accounting identity broke
                                  (submitted != served + shed + pending)

Trips are rate-limited per reason (`trip_limit` dumps each; the first
failures are the diagnosable ones, the ten-thousandth is noise) and write
`flight_<reason>_<n>.jsonl` under `dump_dir` (default: cwd).

Dump format: one span per line (see `trace.Span.to_dict`), sorted by
`t_start`, preceded by one header line `{"flight_recorder": {...}}` with
the dump reason/detail/capacity.  `load_jsonl` round-trips it.

`reconcile()` is the span/ledger cross-check:
every root span ends in exactly ONE terminal state, terminal counts equal
the component ledger's served/dropped/shed counters, and clocks are sane
(end >= start, children nested inside their parent's window).
"""
from __future__ import annotations

import collections
import json
import os
import threading

from repro_torch.obs.trace import Span


class FlightRecorder:
    """Bounded span ring + rate-limited auto-dump."""

    def __init__(self, capacity: int = 65536, *,
                 dump_dir: str | None = None, trip_limit: int = 3):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.trip_limit = int(trip_limit)
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._trips: dict[str, int] = {}
        self.dumps: list[str] = []            # paths written by trips/dumps
        self._recorded = 0                    # total spans ever recorded

    def record(self, span: Span) -> None:
        # Lock-free hot path: a bounded deque append is thread-safe under
        # the GIL, and the eviction count is DERIVED (recorded - len) in
        # the `evicted` property instead of tracked here, so the serving
        # threads never contend on a lock per finished span.
        self._recorded += 1
        self._ring.append(span)

    def __len__(self) -> int:
        return len(self._ring)

    def spans(self) -> list[Span]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    @property
    def evicted(self) -> int:
        """Spans pushed out by the capacity bound (0 means the ring still
        holds the whole run — reconciliation is only meaningful then)."""
        return max(0, self._recorded - len(self._ring))

    # -- dumping ------------------------------------------------------------

    def dump_jsonl(self, path: str, *, reason: str = "manual",
                   detail: str = "") -> str:
        """Write the ring to `path`: a header line, then one span per
        line sorted by start time."""
        spans = sorted(self.spans(), key=lambda s: s.t_start)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"flight_recorder": {
                "reason": reason, "detail": detail, "n_spans": len(spans),
                "capacity": self.capacity, "evicted": self.evicted}}) + "\n")
            for s in spans:
                f.write(json.dumps(s.to_dict()) + "\n")
        self.dumps.append(path)
        return path

    def trip(self, reason: str, detail: str = "") -> str | None:
        """Auto-dump on a fault condition.  Rate-limited: only the first
        `trip_limit` trips per reason write a file; later ones are counted
        but silent.  Returns the path written, or None when suppressed."""
        with self._lock:
            n = self._trips.get(reason, 0)
            self._trips[reason] = n + 1
            if n >= self.trip_limit:
                return None
        d = self.dump_dir or "."
        path = os.path.join(d, f"flight_{reason}_{n}.jsonl")
        return self.dump_jsonl(path, reason=reason, detail=detail)

    def trip_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._trips)


def load_jsonl(path: str) -> tuple[dict, list[Span]]:
    """Read a dump back: (header dict, spans)."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or "flight_recorder" not in lines[0]:
        raise ValueError(f"{path}: not a flight-recorder dump "
                         "(missing header line)")
    return lines[0]["flight_recorder"], [Span.from_dict(d) for d in lines[1:]]


def dump_prometheus(path: str, registry=None) -> str:
    """Write the registry's Prometheus text exposition next to the trace
    dump (the other half of the `--trace` artifact pair)."""
    from repro_torch.obs import metrics
    reg = registry if registry is not None else metrics.REGISTRY
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(reg.to_prometheus())
    return path


# -- span/ledger reconciliation ----------------------------------------------

ROOT_NAMES = ("frame", "request")


def reconcile(spans: list[Span], *, frames_served: int | None = None,
              frames_dropped: int | None = None,
              served: int | None = None, shed: int | None = None,
              root_name: str = "frame") -> list[str]:
    """Cross-check a span set against a component ledger.  Returns a list
    of human-readable failures (empty == reconciled).

    Checks, in order:
      1. every `root_name` span ended in a terminal state, and every
         trace_id carries exactly ONE such root (no double-fates),
      2. terminal counts match the ledger: #served roots == frames_served
         (or `served`), #dropped+#shed roots == frames_dropped (or `shed`),
      3. clock sanity: every ended span has t_end >= t_start, and every
         child lies inside its parent's [t_start, t_end] window (1 µs
         grace for clock-read ordering at the boundaries).
    """
    failures: list[str] = []
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.name == root_name]

    # 1. one terminal root per trace.  The uniqueness check applies only to
    # true trace roots (parent_id is None): request spans nested under a
    # frame legitimately share the frame's trace_id, one per tile wave.
    seen: dict[str, Span] = {}
    for r in roots:
        if not r.terminal:
            failures.append(f"root span {r.trace_id} ended non-terminally: "
                            f"{r.status!r}")
        if r.parent_id is not None:
            continue
        prev = seen.get(r.trace_id)
        if prev is not None:
            failures.append(f"trace {r.trace_id} has more than one root "
                            f"span ({prev.status!r} and {r.status!r})")
        seen[r.trace_id] = r

    # 2. ledger counts
    n_served = sum(1 for r in roots if r.status == "served")
    n_lost = sum(1 for r in roots if r.status.startswith("dropped:")
                 or r.status.startswith("shed:"))
    want_served = frames_served if frames_served is not None else served
    want_lost = frames_dropped if frames_dropped is not None else shed
    if want_served is not None and n_served != want_served:
        failures.append(f"{n_served} served root spans != ledger "
                        f"served={want_served}")
    if want_lost is not None and n_lost != want_lost:
        failures.append(f"{n_lost} dropped/shed root spans != ledger "
                        f"dropped+shed={want_lost}")

    # 3. clock sanity + nesting
    grace = 1e-6
    for s in spans:
        if s.t_end is None:
            if s.name == root_name:
                failures.append(f"root span {s.trace_id} never ended")
            continue
        if s.t_end < s.t_start:
            failures.append(f"span {s.name}#{s.span_id} runs backwards: "
                            f"{s.t_start} -> {s.t_end}")
        p = by_id.get(s.parent_id) if s.parent_id is not None else None
        if p is not None and p.t_end is not None:
            if (s.t_start < p.t_start - grace
                    or s.t_end > p.t_end + grace):
                failures.append(
                    f"span {s.name}#{s.span_id} escapes its parent "
                    f"{p.name}#{p.span_id}'s window")
    return failures


def waterfall(spans: list[Span], trace_id: str, *, width: int = 48,
              max_spans: int | None = None) -> str:
    """Render one trace as an ASCII waterfall (the stream_demo view):
    each span a bar positioned on the trace's own clock.  `max_spans`
    truncates busy traces (a frame fans out into dozens of request spans)
    with an explicit "+N more" line."""
    ts = [s for s in spans if s.trace_id == trace_id and s.t_end is not None]
    if not ts:
        return f"(no spans for trace {trace_id})"
    ts.sort(key=lambda s: (s.t_start, s.span_id))
    hidden = 0
    if max_spans is not None and len(ts) > max_spans:
        hidden = len(ts) - max_spans
        ts = ts[:max_spans]
    t0 = min(s.t_start for s in ts)
    t1 = max(s.t_end for s in ts)
    total = max(t1 - t0, 1e-9)
    depth = {}
    for s in ts:
        depth[s.span_id] = (depth.get(s.parent_id, -1) + 1
                            if s.parent_id in depth or s.parent_id is None
                            else 1)
    lines = [f"trace {trace_id}  ({total * 1e3:.1f} ms total)"]
    for s in ts:
        a = int((s.t_start - t0) / total * width)
        b = max(a + 1, int((s.t_end - t0) / total * width))
        bar = " " * a + "#" * (b - a) + " " * (width - b)
        label = "  " * depth.get(s.span_id, 0) + s.name
        lines.append(f"  {label:<22s} |{bar}| {s.duration_s * 1e3:7.2f} ms"
                     f"  {s.status}")
    if hidden:
        lines.append(f"  ... (+{hidden} more spans)")
    return "\n".join(lines)
