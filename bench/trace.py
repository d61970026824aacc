"""The traced run's readings: the card's activity from torch.profiler, and
spans that the benchmark records on the host around its calls into the
program's layers.

`DeviceTrace` profiles CUDA activity only, with `PAD_S` of host idle at
each end of the window: the profiler has dropped all device activity of
short unpadded windows on this card (`analysis/profiler_windows.py`).
A spin kernel launched at a known host time ties the device's timeline to
`time.perf_counter`, so a gap on the card can be named by the host span
that was open across it.
"""
from __future__ import annotations

import array
import bisect
import collections
import gc
import threading
import time

PAD_S = 0.02
_MARK_CYCLES = 20_000          # the alignment kernel spins ~10 us


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


class DeviceTrace:
    """Profile the card over a `with` block; afterwards `events` holds every
    device operation as (name, start, end) in perf_counter seconds."""

    def __init__(self):
        self.events: list[tuple[str, float, float]] = []
        self.window: tuple[float, float] | None = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(_MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events, mark = [], None
        for e in self._prof.profiler.kineto_results.events():
            if "cuda" not in str(e.device_type()).lower():
                continue
            name, start, dur = e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            if "spin_kernel" in name and mark is None:
                mark = start
                continue
            events.append((name, start, dur))
        if mark is None:
            raise RuntimeError("the trace holds no alignment kernel: the profiler "
                               "lost the window's device activity")
        shift = self._t_mark - mark
        self.events = [(n, s + shift, s + shift + d) for n, s, d in events]
        self.window = (self._t0, t1)
        return False

    # -- readings -------------------------------------------------------------

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of every device operation's interval, clipped to the
        window, as sorted disjoint intervals."""
        lo, hi = self.window
        out: list[list[float]] = []
        for _, s, e in sorted(self.events, key=lambda ev: ev[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def summary(self) -> dict:
        lo, hi = self.window
        busy = self.busy_intervals()
        by_name = collections.Counter()
        kernel_s = 0.0
        for name, s, e in self.events:
            by_name[name] += e - s
            if not _is_copy(name):
                kernel_s += e - s
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if hi > prev:
            gaps.append((prev, hi))
        return {"window_s": hi - lo, "busy_s": sum(e - s for s, e in busy),
                "kernel_s": kernel_s, "n_ops": len(self.events),
                "device_ops": by_name.most_common(10), "gaps": gaps}


class HostSpans:
    """Spans recorded on the host around calls into the program (the traced
    run only): `wrap(obj, method, label)` times every call of a method of
    one object, on whatever thread it runs.  Starts and ends are kept in
    flat float arrays, which the collector does not track."""

    def __init__(self):
        self._times: dict[str, array.array] = collections.defaultdict(lambda: array.array("d"))
        self._lock = threading.Lock()

    def wrap(self, obj, method: str, label: str) -> None:
        inner = getattr(obj, method)
        times, lock = self._times[label], self._lock

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with lock:
                    times.append(t0)
                    times.append(t1)
        object.__setattr__(obj, method, timed)      # frozen dataclasses too

    def spans(self, label: str) -> list[tuple[float, float]]:
        t = self._times.get(label, array.array("d"))
        return list(zip(t[0::2], t[1::2]))

    def label_gaps(self, gaps: list[tuple[float, float]], order: list[str],
                   otherwise: str) -> list[list]:
        """Idle seconds on the card by what the host was doing at each gap's
        midpoint: the first label in `order` with a span open there, else
        `otherwise`; [[label (n gaps), seconds]], longest first, at most 10."""
        index = {}
        for label in order:
            spans = sorted(self.spans(label))
            index[label] = ([s for s, _ in spans], spans)
        total, count = collections.Counter(), collections.Counter()
        for a, b in gaps:
            m = 0.5 * (a + b)
            name = otherwise
            for label in order:
                starts, spans = index[label]
                i = bisect.bisect_right(starts, m) - 1
                if i >= 0 and spans[i][1] >= m:
                    name = label
                    break
            total[name] += b - a
            count[name] += 1
        return [[f"{name} ({count[name]} gaps)", sec] for name, sec in total.most_common(10)]


class GcPauses:
    """The interpreter's garbage collections during a `with` block, as
    (generation, seconds) pairs: a collection stops every thread of the
    process, the router's and the client's alike."""

    def __init__(self):
        self.pauses: list[tuple[int, float]] = []
        self._t = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False

    def summary(self) -> str:
        full = [s for g, s in self.pauses if g == 2]
        longest = max((s for _, s in self.pauses), default=0.0)
        return (f"{len(self.pauses)} collections, {len(full)} full "
                f"({1e3 * sum(full):.1f} ms), longest {1e3 * longest:.1f} ms")
