"""The program's own spans in a traced window, and a command that reads them.

The port's tracer (`repro_torch.obs.trace`) records spans at the layer
boundaries inside the program: the router's `dispatch` (one a request, over
the whole `submit`) and `drain` (one a lane drained); the engine step's
`batch_form`, `device_step` with its children `upload`, `forward` and
`device_wait`, and `finish`; the frame sweep's `score` with its children
`trunk`, `masks`, `head` and `device_wait`, tagged with its `launches`.
They are taken on `time.perf_counter`, the clock onto which `DeviceTrace`
maps the card's timeline, so a gap on the card can be named by the
innermost program span open across it.

`ProgramTrace` turns the tracer on around a window and keeps its spans as
plain tuples; the readers in `bench/metrics/` whose names `METRICS` lists
read them from a run's record (`program_spans`, `program_spans_evicted`)
and read nothing (None) where the record has none or the ring evicted any.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> [--tracer 0|1]

runs one cell as `bench/run.py --trace 1` does, with the tracer on around
the traced window (`--tracer 0` leaves it off, to measure what it costs),
and prints one JSON line: every per-layer metric of the cell, the metrics
of `METRICS`, the idle gaps named by program spans, each phase's share of
its parent span, the clock check (fleet cells) and the run's notes.  Its
device trace launches a second alignment kernel as the window closes, so
the gaps and the clock check are given again with the card's clock mapped
by that mark (`*_end_mark`), beside how far the first mark's map puts it
from its launch (`second_mark_off_us`): the first mark, the first launch
after the profiler starts, lands late.
"""
from __future__ import annotations

import bisect
import collections
import statistics
import typing

CAPACITY = 1 << 19          # a 20 s fleet window ends ~240k spans

# the readers of program spans, by kind of traffic
METRICS = {
    "fleet": ["submit_us.fleet", "drain_us.fleet", "step_ms.upload", "step_ms.forward",
              "step_ms.wait", "step_ms.finish"],
    "sweep": ["score_ms.masks", "score_ms.trunk", "score_ms.head", "score_ms.wait",
              "launches_per_frame.sweep"],
}
# program spans that name an idle gap, innermost first, ahead of the
# traffic module's own wraps
GAP_ORDER = {
    "fleet": ["device_wait", "upload", "forward", "finish", "batch_form", "drain", "dispatch"],
    "sweep": ["device_wait", "masks", "trunk", "head", "score"],
}
# a parent span and the children that split its time
PHASES = {
    "fleet": ("device_step", ("upload", "forward", "device_wait")),
    "sweep": ("score", ("masks", "trunk", "head", "device_wait")),
}
# the engine's spans that run inside a router's drain, on its thread
ENGINE_SPANS = ("batch_form", "device_step", "finish")


class ProgramSpan(typing.NamedTuple):
    name: str
    span_id: int
    parent_id: int | None
    t_start: float
    t_end: float
    status: str
    tags: dict


class ProgramTrace:
    """The port's tracer on over a `with` block, on a ring of `capacity`
    spans whose trips dump under `dump_dir`; afterwards `spans` holds every
    span that ended, in the order they ended, and `evicted` how many the
    ring lost."""

    def __init__(self, dump_dir, capacity: int = CAPACITY):
        self.dump_dir, self.capacity = str(dump_dir), capacity
        self.spans: list[ProgramSpan] = []
        self.evicted = 0

    def __enter__(self):
        from repro_torch.obs import trace as T
        self._tracer = T.enable(capacity=self.capacity, dump_dir=self.dump_dir)
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import trace as T
        rec = self._tracer.recorder
        self.spans = [ProgramSpan(s.name, s.span_id, s.parent_id, s.t_start, s.t_end,
                                  s.status, s.tags) for s in rec.spans() if s.t_end is not None]
        self.evicted = rec.evicted
        T.disable()
        return False


# -- readings -----------------------------------------------------------------

def spans_of(rec: dict, kind: str) -> list[ProgramSpan] | None:
    """A record's program spans, or None: another kind of cell, no spans,
    or a ring that lost some (never a partial figure)."""
    spans = rec.get("program_spans")
    if rec.get("kind") != kind or not spans or rec.get("program_spans_evicted", 1) > 0:
        return None
    return spans


def median(values) -> float | None:
    values = list(values)
    return float(statistics.median(values)) if values else None


def durations(spans, name: str, parent: str | None = None) -> list[float]:
    """Seconds of every span called `name`, those under a `parent` span
    of that name only where it is given."""
    if parent is None:
        return [s.t_end - s.t_start for s in spans if s.name == name]
    parents = {s.span_id for s in spans if s.name == parent}
    return [s.t_end - s.t_start for s in spans if s.name == name and s.parent_id in parents]


def summed_by_parent(spans, name: str, parent: str) -> list[float]:
    """Seconds of the `name` spans summed under each `parent` span that has
    any: a frame's masks, which come in several spans."""
    parents = {s.span_id for s in spans if s.name == parent}
    total: dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.name == name and s.parent_id in parents:
            total[s.parent_id] += s.t_end - s.t_start
    return list(total.values())


def drain_self_s(spans) -> float | None:
    """The `drain` spans' summed seconds less those of the engine spans
    (`ENGINE_SPANS`) that lie inside them; None without drains."""
    drains = sorted((s.t_start, s.t_end) for s in spans if s.name == "drain")
    if not drains:
        return None
    inner = sorted((s.t_start, s.t_end) for s in spans if s.name in ENGINE_SPANS)
    starts = [a for a, _ in inner]
    total = 0.0
    for a, b in drains:
        total += b - a
        i = bisect.bisect_left(starts, a)
        while i < len(inner) and inner[i][0] < b:
            if inner[i][1] <= b:
                total -= inner[i][1] - inner[i][0]
            i += 1
    return total


def phase_shares(spans, parent: str, children: tuple[str, ...]) -> list[float]:
    """For each `parent` span, the share of its length that its `children`
    spans cover."""
    length = {s.span_id: s.t_end - s.t_start for s in spans if s.name == parent}
    covered: dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.name in children and s.parent_id in length:
            covered[s.parent_id] += s.t_end - s.t_start
    return [covered[i] / n if n > 0 else 1.0 for i, n in length.items()]


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def name_gaps(gaps, labelled, otherwise: str, top: int | None = 10) -> list[list]:
    """Idle seconds on the card by the first label of `labelled`, a list of
    (label, intervals) innermost first, with an interval open at the gap's
    midpoint, else `otherwise`: [[label (n gaps), seconds]], longest
    first, at most `top` (None: all)."""
    index = []
    for label, intervals in labelled:
        merged = _union(intervals)
        index.append((label, [a for a, _ in merged], merged))
    total, count = collections.Counter(), collections.Counter()
    for a, b in gaps:
        m = 0.5 * (a + b)
        name = otherwise
        for label, starts, merged in index:
            i = bisect.bisect_right(starts, m) - 1
            if i >= 0 and merged[i][1] >= m:
                name = label
                break
        total[name] += b - a
        count[name] += 1
    return [[f"{name} ({count[name]} gaps)", sec] for name, sec in total.most_common(top)]


def program_labels(spans, names) -> list[tuple[str, list[tuple[float, float]]]]:
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append((s.t_start, s.t_end))
    return [(n, by_name.get(n, [])) for n in names]


def clock_check(events, spans, kernel: str = "fixed_smallnet") -> dict | None:
    """How well one mark ties the card's clock to the host's: for each
    engine step, whether its `kernel` (the device trace's events as (name,
    start, end) on perf_counter) starts after the step's `forward` span
    starts and ends before its `device_wait` span ends, and the offset of
    the kernel's start from the forward's, in microseconds, over the first
    and the last tenth of the steps (median and quartiles).  Steps and
    kernels are paired in order where their counts agree, else each step
    takes the first kernel that starts after its upload began."""
    kernels = sorted((s, e) for n, s, e in events if kernel in n)
    phase = {}
    for s in spans:
        if s.name in ("upload", "forward", "device_wait"):
            phase[(s.parent_id, s.name)] = s
    steps = sorted((s for s in spans if s.name == "device_step"
                    and (s.span_id, "forward") in phase and (s.span_id, "device_wait") in phase),
                   key=lambda s: s.t_start)
    if not steps or not kernels:
        return None
    if len(kernels) == len(steps):
        pairs = list(zip(steps, kernels))
    else:
        starts = [k[0] for k in kernels]
        pairs = []
        for st in steps:
            i = bisect.bisect_left(starts, st.t_start)
            if i < len(kernels):
                pairs.append((st, kernels[i]))
    within, offsets = 0, []
    for st, (ks, ke) in pairs:
        fwd, wait = phase[(st.span_id, "forward")], phase[(st.span_id, "device_wait")]
        within += int(fwd.t_start <= ks and ke <= wait.t_end)
        offsets.append(1e6 * (ks - fwd.t_start))
    tenth = max(len(offsets) // 10, 1)

    def q(values):
        if len(values) < 4:
            return [round(v, 3) for v in sorted(values)]
        lo, mid, hi = statistics.quantiles(values, n=4)
        return [round(lo, 3), round(mid, 3), round(hi, 3)]
    return {"steps": len(steps), "kernels": len(kernels), "paired": len(pairs),
            "within_share": within / len(steps),
            "offset_us_first_tenth": q(offsets[:tenth]),
            "offset_us_last_tenth": q(offsets[-tenth:])}


# -- the command ----------------------------------------------------------------

class _Capture:
    """Keeps what a traffic module's traced window computes and drops: the device
    trace (its events and gaps) and the benchmark's host wraps with the
    order and fallback label it names gaps by.  The device trace also
    launches a second alignment kernel as the window closes, at a known
    host time, so that `remapped()` can map the card's clock onto the
    host's by the second mark."""

    def __init__(self, traffic):
        import time

        from bench import trace as BT
        cap = self

        class Device(BT.DeviceTrace):
            def __exit__(self, *exc):
                if exc[0] is None:
                    import torch
                    torch.cuda.synchronize()
                    cap.t_mark2 = time.perf_counter()
                    torch.cuda._sleep(BT._MARK_CYCLES)
                return super().__exit__(*exc)

            def summary(self):
                s = super().summary()
                cap.device, cap.gaps = self, list(s["gaps"])
                return s

        class Host(BT.HostSpans):
            def label_gaps(self, gaps, order, otherwise):
                cap.host, cap.order, cap.otherwise = self, list(order), otherwise
                return super().label_gaps(gaps, order, otherwise)

        self.traffic, self.saved = traffic, (traffic.DeviceTrace, traffic.HostSpans)
        traffic.DeviceTrace, traffic.HostSpans = Device, Host
        self.device = self.gaps = self.host = self.order = self.otherwise = None
        self.t_mark2 = None

    def restore(self):
        self.traffic.DeviceTrace, self.traffic.HostSpans = self.saved

    def second_mark(self) -> float | None:
        """Seconds by which the one-mark map puts the second mark before
        the host's clock read at its launch, or None without it."""
        dev = self.device
        marks = [e for e in dev.events if "spin_kernel" in e[0]] if dev else []
        if self.t_mark2 is None or not marks:
            return None
        return self.t_mark2 - marks[-1][1]

    def remapped(self, off: float):
        """-> (the device's events moved `off` seconds later, their idle
        gaps)."""
        from bench import trace as BT
        fixed = BT.DeviceTrace()
        fixed.window = self.device.window
        fixed.events = [(n, s + off, e + off) for n, s, e in self.device.events
                        if "spin_kernel" not in n]
        return fixed.events, fixed.summary()["gaps"]


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import pathlib
    import sys
    import time
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    sys.path[:0] = [str(root), str(root / "src")]

    import torch
    from bench import harness
    from bench.work.peaks import peaks_for
    if not torch.cuda.is_available():
        raise SystemExit("spans: no CUDA card")
    benchmark = json.loads((root / "BENCHMARK.json").read_text())
    cell = harness.cell(args.workload)
    kind = cell.driver
    traffic = harness.load_driver(kind)
    run = traffic.Run(cell, args.seed % 2 ** 63, args.seconds)
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start - getattr(run, "reference_s", 0.0)
    cap = _Capture(traffic)
    try:
        if args.tracer:
            with ProgramTrace(build / "flight") as pt:
                run.window(trace=True)
        else:
            pt = None
            run.window(trace=True)
    finally:
        cap.restore()
    run.release()
    compared = run.check()
    rec = run.record()
    rec.update(setup_s=setup_s, peaks=peaks_for(torch.cuda.get_device_name(0)),
               program_spans=pt.spans if pt else None,
               program_spans_evicted=pt.evicted if pt else None)
    names = [m["name"] for m in harness.metrics_for(benchmark, args.workload, "per_layer")]
    metrics = {}
    for name in names + (METRICS[kind] if pt else []):
        value = harness.load_metric(name)(rec)
        if value is not None:
            metrics[name] = value
    out = {"workload": args.workload, "seed": args.seed, "tracer": args.tracer,
           "correct": all(c.ok for c in compared), "metrics": metrics,
           "idle_gaps": rec["trace"]["idle_gaps"],
           "card": torch.cuda.get_device_name(0), "notes": rec["notes"]}
    if pt:
        labelled = (program_labels(pt.spans, GAP_ORDER[kind])
                    + [(label, cap.host.spans(label)) for label in cap.order])
        idle = sum(b - a for a, b in cap.gaps)
        named = name_gaps(cap.gaps, labelled, cap.otherwise, top=None)
        out["idle_gaps_program"] = named[:10]
        out["idle_s"] = idle
        out["wraps_share"] = sum(sec for lab, sec in named
                                 if lab.rsplit(" (", 1)[0] in cap.order) / idle
        off = cap.second_mark()
        if off is not None:
            out["second_mark_off_us"] = 1e6 * off
            events2, gaps2 = cap.remapped(off)
            out["idle_gaps_program_end_mark"] = name_gaps(gaps2, labelled, cap.otherwise)
            if kind == "fleet":
                out["clock_check_end_mark"] = clock_check(events2, pt.spans)
        out["spans"], out["evicted"] = len(pt.spans), pt.evicted
        parent, children = PHASES[kind]
        shares = sorted(phase_shares(pt.spans, parent, children))
        if shares:
            out["phase_share"] = {"parent": parent, "n": len(shares), "min": shares[0],
                                  "p1": shares[len(shares) // 100], "median": median(shares)}
        if kind == "fleet":
            out["clock_check"] = clock_check(cap.device.events, pt.spans)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
