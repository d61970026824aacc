"""The readers of the program's spans on synthetic span lists, the naming
of idle gaps by program spans, the clock check, and each cell's run on
the CPU with the port's tracer on around its window."""
import dataclasses
import types

import pytest
import torch

from bench import harness
from bench import spans as S
from bench.trace import HostSpans

_ids = iter(range(1, 10**9))


def span(name, t0, t1, parent=None, status="ok", **tags):
    return S.ProgramSpan(name, next(_ids), parent.span_id if parent else None, t0, t1,
                         status, tags)


def read(name, rec):
    return harness.load_metric(name)(rec)


def _fleet_spans():
    """Two drains on the router thread; the first runs two steps, the second
    one; three requests served, one a shed at the door."""
    out = [span("dispatch", 0.0, 10e-6), span("dispatch", 1.0, 1.00003),
           span("dispatch", 2.0, 2.00002), span("dispatch", 3.0, 3.00004, status="shed:slo_wait")]
    d1, d2 = span("drain", 10.0, 10.010, replica=0, lane=2), span("drain", 20.0, 20.004,
                                                                   replica=1, lane=1)
    out += [d1, d2]
    for t, n in ((10.001, 1), (10.005, 1), (20.001, 1)):
        bf = span("batch_form", t, t + 0.0001)
        ds = span("device_step", t + 0.0002, t + 0.0022, n_real=n)
        out += [bf, ds,
                span("upload", ds.t_start, t + 0.0007, ds),
                span("forward", t + 0.0007, t + 0.0012, ds),
                span("device_wait", t + 0.0012, t + 0.0022, ds),
                span("finish", ds.t_end, t + 0.0030)]
    out += [span("request", 0.0, 10.003, status="served") for _ in range(3)]
    return out


def _fleet_rec(spans, evicted=0):
    return {"kind": "fleet", "program_spans": spans, "program_spans_evicted": evicted}


def test_fleet_readers():
    rec = _fleet_rec(_fleet_spans())
    assert read("submit_us.fleet", rec) == pytest.approx(25.0)      # of 10, 20, 30, 40 us
    # drains 14 ms, less three steps of 0.1 + 2.0 + 0.8 ms inside them
    assert read("drain_us.fleet", rec) == pytest.approx(1e6 * (0.014 - 3 * 0.0029) / 3)
    assert read("step_ms.upload", rec) == pytest.approx(0.5)
    assert read("step_ms.forward", rec) == pytest.approx(0.5)
    assert read("step_ms.wait", rec) == pytest.approx(1.0)
    assert read("step_ms.finish", rec) == pytest.approx(0.8)
    shares = S.phase_shares(rec["program_spans"], *S.PHASES["fleet"])
    assert shares == pytest.approx([1.0, 1.0, 1.0])
    for name in S.METRICS["sweep"]:
        assert read(name, rec) is None


def test_drain_self_time_leaves_out_only_the_steps_inside():
    d = span("drain", 0.0, 1.0)
    inside, outside = span("device_step", 0.2, 0.5), span("device_step", 1.5, 1.9)
    straddling = span("finish", 0.9, 1.2)          # not inside: not taken off
    assert S.drain_self_s([d, inside, outside, straddling]) == pytest.approx(0.7)
    assert S.drain_self_s([inside]) is None


def test_readers_read_nothing_from_partial_or_missing_spans():
    spans = _fleet_spans()
    for rec in (_fleet_rec(spans, evicted=1), _fleet_rec(None), _fleet_rec([]),
                {"kind": "fleet", "program_spans": spans},          # evictions unknown
                dict(_fleet_rec(spans), kind="sweep")):
        for name in S.METRICS["fleet"] + S.METRICS["sweep"]:
            assert read(name, rec) is None, name


def test_point_dispatch_spans_read_nothing():
    """A program whose dispatch is a point span, and which has no drain
    span, reads no submit time."""
    spans = [s for s in _fleet_spans() if s.name != "drain"]
    assert read("submit_us.fleet", _fleet_rec(spans)) is None
    for name in ("step_ms.upload", "step_ms.finish"):
        assert read(name, _fleet_rec(spans)) is not None


def _sweep_spans(n_frames=3):
    out = []
    for k in range(n_frames):
        t = 10.0 * k
        sc = span("score", t, t + 0.010, launches=34 + (k == 2))
        out.append(sc)
        bounds = [("trunk", 0.0, 0.001), ("masks", 0.001, 0.0015), ("trunk", 0.0015, 0.002),
                  ("masks", 0.002, 0.003), ("trunk", 0.003, 0.006), ("head", 0.006, 0.008),
                  ("device_wait", 0.008, 0.0095 + 0.0001 * k)]
        out += [span(n, t + a, t + b, sc) for n, a, b in bounds]
        out.append(span("device_wait", t + 20.0, t + 20.001))        # another parent's
    return out


def test_sweep_readers():
    rec = {"kind": "sweep", "program_spans": _sweep_spans(), "program_spans_evicted": 0}
    assert read("score_ms.masks", rec) == pytest.approx(1.5)
    assert read("score_ms.trunk", rec) == pytest.approx(4.5)
    assert read("score_ms.head", rec) == pytest.approx(2.0)
    assert read("score_ms.wait", rec) == pytest.approx(1.6)        # 1.5, 1.6, 1.7: the score's only
    assert read("launches_per_frame.sweep", rec) == 34
    shares = S.phase_shares(rec["program_spans"], *S.PHASES["sweep"])
    assert shares == pytest.approx([0.95, 0.96, 0.97])
    for name in S.METRICS["fleet"]:
        assert read(name, rec) is None


def test_gaps_go_to_the_innermost_program_span_then_to_the_wraps():
    drain, step = span("drain", 0.0, 1.0), span("device_step", 0.2, 0.4)
    wait = span("device_wait", 0.3, 0.4, step)
    host = HostSpans()
    host._times["ReplicaRouter.run"].extend([0.0, 1.5])
    gaps = [(0.31, 0.39),      # device_wait, inside device_step and drain
            (0.1, 0.15),       # the drain alone
            (0.25, 0.27),      # device_step: no phase of it is listed
            (1.2, 1.4),        # past the drain: the wrap
            (2.0, 2.5)]        # nothing open: the fallback
    labelled = (S.program_labels([drain, step, wait], ["device_wait", "drain"])
                + [("ReplicaRouter.run", host.spans("ReplicaRouter.run"))])
    got = dict(S.name_gaps(gaps, labelled, "waiting"))
    assert got == pytest.approx({"device_wait (1 gaps)": 0.08, "drain (2 gaps)": 0.07,
                                 "ReplicaRouter.run (1 gaps)": 0.2, "waiting (1 gaps)": 0.5})


def test_overlapping_spans_of_one_name_are_one_interval():
    """A long span that starts before a short one still covers a gap past
    the short one's end."""
    long_, short = span("score", 0.0, 1.0), span("score", 0.1, 0.2)
    got = S.name_gaps([(0.5, 0.6)], S.program_labels([long_, short], ["score"]), "idle")
    assert got[0][0] == "score (1 gaps)"


def test_clock_check():
    steps, events = [], []
    for k in range(20):
        t = float(k)
        ds = span("device_step", t, t + 0.003)
        steps += [ds, span("upload", t, t + 0.001, ds), span("forward", t + 0.001, t + 0.002, ds),
                  span("device_wait", t + 0.002, t + 0.003, ds)]
        off = 0.0002 if k else -0.0005                 # the first kernel before its forward
        events.append(("void fixed_smallnet_kernel<16, 32>", t + 0.001 + off,
                       t + 0.0012 + off))
        events.append(("Memcpy HtoD (Pageable -> Device)", t + 0.0005, t + 0.0006))
    got = S.clock_check(events, steps)
    assert got["steps"] == got["kernels"] == got["paired"] == 20
    assert got["within_share"] == pytest.approx(19 / 20)
    assert got["offset_us_first_tenth"] == pytest.approx([-500.0, 200.0])
    assert got["offset_us_last_tenth"] == pytest.approx([200.0, 200.0])
    assert S.clock_check([], steps) is None


def test_capture_keeps_what_the_window_drops_and_restores_the_module():
    from bench import trace as BT
    traffic = types.SimpleNamespace(DeviceTrace=BT.DeviceTrace, HostSpans=BT.HostSpans)
    cap = S._Capture(traffic)
    host = traffic.HostSpans()
    assert host.label_gaps([(0.0, 1.0)], ["a"], "idle") == [["idle (1 gaps)", 1.0]]
    assert cap.host is host and cap.order == ["a"] and cap.otherwise == "idle"
    dt = traffic.DeviceTrace()
    dt.window, dt.events = (0.0, 1.0), [("k", 0.2, 0.3)]
    dt.summary()
    assert cap.device is dt and cap.gaps == [(0.0, 0.2), (0.3, 1.0)]
    cap.restore()
    assert traffic.DeviceTrace is BT.DeviceTrace and traffic.HostSpans is BT.HostSpans


def test_the_second_mark_remaps_the_card_clock():
    from bench import trace as BT
    traffic = types.SimpleNamespace(DeviceTrace=BT.DeviceTrace, HostSpans=BT.HostSpans)
    cap = S._Capture(traffic)
    cap.restore()
    assert cap.second_mark() is None                    # no window traced
    dev = BT.DeviceTrace()
    dev._t_mark, dev.window = 0.0, (0.0, 11.0)
    # by the first mark alone the second lies 100 us before its launch
    dev.events = [("k", 1.0, 1.5), ("spin_kernel", 10.0 - 1e-4, 10.0)]
    cap.device, cap.t_mark2 = dev, 10.0
    off = cap.second_mark()
    assert off == pytest.approx(1e-4)
    events, gaps = cap.remapped(off)
    assert events == [("k", pytest.approx(1.0001), pytest.approx(1.5001))]
    assert gaps[0] == (0.0, pytest.approx(1.0001))


SMALL = {"q16-fleet-tail": {"rate_qps": 150.0, "image_pool": 128},
         "plan-sweep-112": {"distinct_frames": 3}}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_cells_window_with_the_tracer_on(name, tmp_path):
    """On the CPU every reader of the cell's program spans reads a number;
    each phase split covers its parent span; the run stays correct."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        c = harness.cell(name)
        cell = dataclasses.replace(c, mix=dict(c.mix, **SMALL[name]))
        run = harness.load_driver(cell.driver).Run(cell, 2**31 + 17, 1.0, device="cpu")
        run.setup()
        with S.ProgramTrace(tmp_path / "flight") as pt:
            run.window()
        run.release()
        assert all(x.ok for x in run.check())
    finally:
        torch.set_num_threads(n)
    rec = dict(run.record(), program_spans=pt.spans, program_spans_evicted=pt.evicted)
    assert pt.evicted == 0 and pt.spans
    for metric in S.METRICS[cell.driver]:
        assert read(metric, rec) is not None, metric
    shares = S.phase_shares(pt.spans, *S.PHASES[cell.driver])
    assert shares and min(shares) > 0.5
    from repro_torch.obs import trace as T
    assert T.get() is None
