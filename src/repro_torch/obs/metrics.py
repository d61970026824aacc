"""Low-overhead metrics: counters, gauges, bounded histograms, one registry.

A copy of `repro.obs.metrics` (the port imports nothing from `repro`);
keep the two in step.  For the same instruments, `to_prometheus` gives
the reference's text.

The serving stack used to keep ad-hoc python lists for every latency
distribution (`StreamingPipeline._stage_s`, `VisionEngine._latencies`,
`ReplicaRouter._latencies`) — each grows per event forever, the same
unbounded-retention class of bug PR 7 fixed for engine results.  This
module replaces them:

  Counter     monotonic value (int or float increments).
  Gauge       last-set value + high-water mark (queue depths).
  Histogram   fixed bucket ladder (Prometheus-style cumulative `le`
              counts) + exact count/sum/min/max + a BOUNDED reservoir of
              the most recent `reservoir` raw samples for percentile
              reporting.  Memory is O(buckets + reservoir) regardless of
              how many observations arrive; for runs shorter than the
              reservoir the reported percentiles are exact.

  Registry    process-wide get-or-create by (name, labels); the default
              `REGISTRY` is what `recorder.dump_prometheus` exports.
              Components label their instruments with a unique instance
              label so fleets of engines coexist in one registry.

Percentile convention (the ONE shared helper): `percentile(xs, q)` is
NEAREST-RANK — the smallest sample whose cumulative fraction reaches q% —
so a reported p99 is always a sample that actually occurred, never an
interpolated value between two (np.percentile's default linear
interpolation invents latencies nobody measured, and did so differently
in the engine vs the pipeline).  `summarize_latency`, which every
server's `stats()` calls, routes through it.

Thread model: instrument mutation is a single `+=` / `append` under the
GIL and every serving-stack caller already holds its component lock at
the call site; the exporter takes per-instrument snapshots, so a dump
concurrent with serving sees a consistent (if momentarily stale) view.
"""
from __future__ import annotations

import itertools
import math
import threading
from collections import deque
from typing import Iterable, Sequence

# default reservoir: exact percentiles for every CI-sized run, O(16 KB)
# per histogram at the cap no matter how long the stream runs
RESERVOIR = 2048

# default bucket ladder (seconds): 0.5 ms .. 10 s, roughly x2.5 per rung —
# spans engine step times on a laptop CPU through interpret-mode megakernel
# frames; +inf is implicit
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest observed sample whose
    cumulative fraction reaches q% (ceil(q/100 * n), 1-indexed).  On tiny
    samples this is deliberately pessimistic-honest: percentile([a], 99)
    is a, percentile([1, 2, 3, 4], 50) is 2 — a value that happened, not
    an interpolation.  Raises on an empty sample set (an all-shed window
    has no distribution; callers guard n == 0 explicitly)."""
    n = len(xs)
    if n == 0:
        raise ValueError("percentile: empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile: q={q} outside [0, 100]")
    s = sorted(xs)
    k = max(1, math.ceil(q / 100.0 * n))
    return float(s[min(k, n) - 1])


class Counter:
    """Monotonic counter (int or float increments — busy-seconds are a
    float counter).  `inc()` must never be called with a negative delta."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"Counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Last-set value + high-water mark (`hwm`) — queue depths, batch
    occupancy.  `set()` keeps the mark; `reset_hwm()` re-arms it."""

    __slots__ = ("name", "labels", "value", "hwm")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.hwm = 0.0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.hwm:
            self.hwm = v

    def reset_hwm(self) -> None:
        self.hwm = self.value


class Histogram:
    """Fixed-bucket histogram + bounded sample reservoir.

    `observe(x)` is O(log buckets); memory is bounded by construction —
    the cumulative bucket counts never grow and the reservoir holds only
    the most recent `reservoir` samples (a deque maxlen, so a year-long
    stream retains exactly as much as a minute-long one).  Percentiles
    over `samples()` are exact when the stream fits the reservoir,
    recent-window otherwise.
    """

    __slots__ = ("name", "labels", "buckets", "bucket_counts", "count",
                 "sum", "min", "max", "_samples")

    def __init__(self, name: str, labels: dict,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S,
                 reservoir: int = RESERVOIR):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"Histogram {name}: buckets must be strictly "
                             f"increasing, got {buckets}")
        self.name = name
        self.labels = labels
        self.buckets = tuple(float(b) for b in buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)   # +inf last
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: deque[float] = deque(maxlen=int(reservoir))

    def observe(self, x: float) -> None:
        x = float(x)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                       # first bucket with le >= x
            mid = (lo + hi) // 2
            if x <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.bucket_counts[lo] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        self._samples.append(x)

    def samples(self) -> list[float]:
        """The bounded reservoir (most recent observations), as a list."""
        return list(self._samples)

    def percentile(self, q: float) -> float:
        return percentile(self._samples, q)

    def summary_ms(self) -> dict:
        """The pipeline's per-stage distribution block: n / mean / p50 /
        p99 / max in milliseconds.  n and mean/max are EXACT over the whole
        stream (O(1) accumulators); percentiles are over the reservoir."""
        if self.count == 0:
            return {"n": 0}
        return {"n": self.count,
                "mean_ms": self.sum / self.count * 1e3,
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3,
                "max_ms": self.max * 1e3}

class Registry:
    """Get-or-create instrument store keyed by (name, sorted labels).
    Re-requesting an existing key returns the SAME instrument (a metric is
    process state, not call state); requesting it as a different type
    raises.  `to_prometheus()` renders the whole registry in the text
    exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def _get_or_make(self, cls, name, labels, **kw):
        key = self._key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, dict(labels), **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} {labels} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_make(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_make(Gauge, name, labels)

    def histogram(self, name: str, *,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  reservoir: int = RESERVOIR, **labels) -> Histogram:
        return self._get_or_make(Histogram, name, labels,
                                 buckets=buckets, reservoir=reservoir)

    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    def clear(self) -> None:
        """Drop every instrument (test isolation, or a dump scoped to one
        run; the serving stack never calls this)."""
        with self._lock:
            self._instruments.clear()

    # -- export -------------------------------------------------------------

    @staticmethod
    def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
        merged = {**labels, **(extra or {})}
        if not merged:
            return ""
        body = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
        return "{" + body + "}"

    @staticmethod
    def _fmt_val(v) -> str:
        if isinstance(v, float) and math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v) if isinstance(v, float) else str(v)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format.  Counters exported as
        `<name>_total`, gauges as `<name>` (+ `<name>_hwm`), histograms as
        the standard cumulative `_bucket{le=...}` / `_sum` / `_count`
        triple.  Values round-trip through `parse_prometheus` exactly
        (repr for floats)."""
        lines: list[str] = []
        for inst in sorted(self.instruments(),
                           key=lambda i: (i.name, sorted(i.labels.items()))):
            lab = self._fmt_labels(inst.labels)
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {inst.name}_total counter")
                lines.append(
                    f"{inst.name}_total{lab} {self._fmt_val(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {inst.name} gauge")
                lines.append(f"{inst.name}{lab} {self._fmt_val(inst.value)}")
                lines.append(
                    f"{inst.name}_hwm{lab} {self._fmt_val(inst.hwm)}")
            elif isinstance(inst, Histogram):
                lines.append(f"# TYPE {inst.name} histogram")
                cum = 0
                for le, n in zip(list(inst.buckets) + [math.inf],
                                 inst.bucket_counts):
                    cum += n
                    le_lab = self._fmt_labels(
                        inst.labels, {"le": self._fmt_val(float(le))})
                    lines.append(f"{inst.name}_bucket{le_lab} {cum}")
                lines.append(
                    f"{inst.name}_sum{lab} {self._fmt_val(inst.sum)}")
                lines.append(f"{inst.name}_count{lab} {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse the text exposition format back to {'name{labels}': value}.
    Enough of the grammar for the round-trip tests and the reconciliation
    tooling (one metric per line, no escapes inside label values)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if not key:
            raise ValueError(f"unparseable metric line: {line!r}")
        v = math.inf if val == "+Inf" else (-math.inf if val == "-Inf"
                                            else float(val))
        out[key] = v
    return out


# the process-wide registry: every serving component registers here
REGISTRY = Registry()

# unique instance labels so N engines / pipelines / routers coexist in the
# one process-wide registry without clobbering each other's instruments
_instance_seq = itertools.count()


def instance_label(kind: str) -> str:
    """`kind#<seq>` — a process-unique instance label for a component's
    instruments (engines die with their owner; their metrics stay
    readable in the registry until process exit)."""
    return f"{kind}#{next(_instance_seq)}"


def summarize_latency(latencies_s: Iterable[float], window_s: float) -> dict:
    """The shared latency/throughput stats block (engine, fleet, pipeline
    benches): mean/p50/p95/p99/max in ms + qps over `window_s`.  Nearest-
    rank percentiles via the one shared helper.  Empty input raises (see
    `percentile`); a zero-length window yields 0.0 qps, never inf."""
    lat = list(latencies_s)
    if not lat:
        raise ValueError(
            "summarize_latency: empty latency set — an all-shed or "
            "never-run window has no distribution; guard n == 0 at the "
            "caller")
    return {
        "latency_mean_ms": sum(lat) / len(lat) * 1e3,
        "latency_p50_ms": percentile(lat, 50) * 1e3,
        "latency_p95_ms": percentile(lat, 95) * 1e3,
        "latency_p99_ms": percentile(lat, 99) * 1e3,
        "latency_max_ms": max(lat) * 1e3,
        "throughput_qps": len(lat) / window_s if window_s > 0 else 0.0,
    }
