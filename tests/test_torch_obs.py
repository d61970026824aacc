"""The port's observability export against the JAX reference's.

`repro_torch.obs` carries the reference's Prometheus export
(`Registry.to_prometheus`, `parse_prometheus`), the flight recorder's dump
reader and Prometheus dump (`load_jsonl`, `dump_prometheus`), the ASCII
waterfall, and the span helpers (`Span.duration_s`, `Span.from_dict`,
`Tracer.end_at`, `Tracer.span`).  For the same instruments and the same
spans, every one of them gives the reference's text, byte for byte.  Pure
Python, no device.
"""
import pytest

from repro.obs import metrics as JM
from repro.obs import recorder as JR
from repro.obs import trace as JT
from repro_torch.obs import metrics as M
from repro_torch.obs import recorder as R
from repro_torch.obs import trace as T


def _fill(mod):
    """The same instruments in a fresh registry of `mod` (either package)."""
    reg = mod.Registry()
    reg.counter("requests", engine="e#0").inc(3)
    reg.counter("requests", engine="e#1").inc(2.5)
    reg.counter("bare").inc()
    g = reg.gauge("queue_depth", engine="e#0")
    for v in (4, 9, 2):
        g.set(v)
    reg.gauge("occupancy").set(0.75)
    h = reg.histogram("latency_seconds", stage="infer", buckets=(0.001, 0.01, 0.1))
    for x in (0.0005, 0.002, 0.003, 0.05, 2.0, 1e-9):
        h.observe(x)
    reg.histogram("empty_seconds")
    return reg


def _spans(mod):
    """One traced frame: a root span, three children, a nested grandchild,
    an open span and another trace's span, with fixed clocks."""
    S = mod.Span
    return [
        S("frame", "frame-0", 0, None, 10.0, 10.012, "served", {"index": 0}),
        S("tile", "frame-0", 1, 0, 10.0005, 10.001),
        S("infer", "frame-0", 2, 0, 10.001, 10.010, "ok", {"route": "disagg"}),
        S("stage_request", "frame-0", 3, 2, 10.002, 10.009, "served", {"uid": 4}),
        S("aggregate", "frame-0", 4, 0, 10.010, 10.0118),
        S("open", "frame-0", 5, 0, 10.011),
        S("frame", "frame-1", 6, None, 11.0, 11.5, "dropped:infer/shed"),
    ]


def test_prometheus_text_is_the_reference_text():
    text = _fill(M).to_prometheus()
    assert text == _fill(JM).to_prometheus()
    assert "requests_total{engine=\"e#0\"} 3" in text
    assert 'latency_seconds_bucket{le="+Inf",stage="infer"} 6' in text
    assert M.Registry().to_prometheus() == JM.Registry().to_prometheus() == ""


def test_parse_prometheus_round_trips_like_the_reference():
    text = _fill(M).to_prometheus()
    parsed = M.parse_prometheus(text)
    assert parsed == JM.parse_prometheus(text)
    assert parsed['queue_depth_hwm{engine="e#0"}'] == 9
    assert parsed['requests_total{engine="e#1"}'] == 2.5
    assert parsed['latency_seconds_bucket{le="0.01",stage="infer"}'] == 4
    assert parsed["latency_seconds_count{stage=\"infer\"}"] == 6
    with pytest.raises(ValueError, match="unparseable"):
        M.parse_prometheus("lonely_token")


def test_registry_instruments_clear_and_reset_hwm():
    reg = _fill(M)
    jreg = _fill(JM)
    names = lambda r: sorted((i.name, sorted(i.labels.items())) for i in r.instruments())
    assert names(reg) == names(jreg) and len(reg.instruments()) == 7
    g, jg = reg.gauge("queue_depth", engine="e#0"), jreg.gauge("queue_depth", engine="e#0")
    assert (g.value, g.hwm) == (jg.value, jg.hwm) == (2, 9)
    g.reset_hwm()
    jg.reset_hwm()
    assert (g.value, g.hwm) == (jg.value, jg.hwm) == (2, 2)
    reg.clear()
    assert reg.instruments() == [] and reg.to_prometheus() == ""


def test_dump_prometheus_writes_the_reference_file(tmp_path):
    got = R.dump_prometheus(str(tmp_path / "port" / "metrics.prom"), registry=_fill(M))
    want = JR.dump_prometheus(str(tmp_path / "ref" / "metrics.prom"), registry=_fill(JM))
    text = open(got).read()
    assert text == open(want).read() == _fill(M).to_prometheus()


def test_dump_prometheus_defaults_to_the_process_registry(tmp_path):
    c = M.REGISTRY.counter("obs_test_default_dump", probe=M.instance_label("t"))
    c.inc(7)
    text = open(R.dump_prometheus(str(tmp_path / "m.prom"))).read()
    assert M.parse_prometheus(text)[
        f'obs_test_default_dump_total{{probe="{c.labels["probe"]}"}}'] == 7


def test_load_jsonl_round_trips_a_dump_like_the_reference(tmp_path):
    rec = R.FlightRecorder(capacity=16, dump_dir=str(tmp_path))
    for s in _spans(T):
        rec.record(s)
    assert len(rec) == 7
    path = rec.dump_jsonl(str(tmp_path / "dump.jsonl"), reason="manual", detail="test")
    header, spans = R.load_jsonl(path)
    jheader, jspans = JR.load_jsonl(path)
    assert header == jheader and header["n_spans"] == 7 and header["reason"] == "manual"
    assert [s.to_dict() for s in spans] == [s.to_dict() for s in jspans]
    assert [s.to_dict() for s in spans] == \
        [s.to_dict() for s in sorted(_spans(T), key=lambda s: s.t_start)]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"not": "a dump"}\n')
    with pytest.raises(ValueError, match="flight-recorder"):
        R.load_jsonl(str(bad))


def test_trip_counts_and_len():
    rec = R.FlightRecorder(capacity=2, trip_limit=1, dump_dir=None)
    jrec = JR.FlightRecorder(capacity=2, trip_limit=1, dump_dir=None)
    for r in (rec, jrec):
        for s in _spans(T)[:3]:
            r.record(s)
    assert len(rec) == len(jrec) == 2
    assert rec.trip_counts() == jrec.trip_counts() == {}


def test_trip_counts_count_suppressed_trips(tmp_path):
    rec = R.FlightRecorder(capacity=4, trip_limit=1, dump_dir=str(tmp_path))
    assert rec.trip("slo_violation", "first") is not None
    assert rec.trip("slo_violation", "second") is None       # rate-limited
    rec.trip("ledger_invariant")
    assert rec.trip_counts() == {"slo_violation": 2, "ledger_invariant": 1}


@pytest.mark.parametrize("kw", [{}, {"width": 20}, {"max_spans": 3}])
def test_waterfall_is_the_reference_view(kw):
    got = R.waterfall(_spans(T), "frame-0", **kw)
    assert got == JR.waterfall(_spans(JT), "frame-0", **kw)
    assert got.startswith("trace frame-0  (12.0 ms total)")
    assert R.waterfall(_spans(T), "frame-9") == JR.waterfall(_spans(JT), "frame-9")
    if "max_spans" in kw:
        assert got.endswith("(+2 more spans)")


def test_span_duration_and_from_dict_match_the_reference():
    for s, js in zip(_spans(T), _spans(JT)):
        assert s.duration_s == js.duration_s
        d = s.to_dict()
        assert T.Span.from_dict(d) == s
        assert T.Span.from_dict(d).to_dict() == JT.Span.from_dict(js.to_dict()).to_dict()
    assert _spans(T)[5].duration_s is None
    assert T.Span.from_dict({"name": "n", "trace_id": "t", "span_id": 1,
                             "t_start": 1.0}).status == "open"


def test_tracer_end_at_and_span_context():
    tr = T.enable(capacity=64)
    try:
        s = tr.start("device_step", "req-1", batch=4)
        s.tags["n"] = 4
        assert tr.end_at(s, s.t_start + 0.25, "served") is s
        assert (s.status, s.tags) == ("served", {"batch": 4, "n": 4})
        assert s.duration_s == pytest.approx(0.25)
        with pytest.raises(RuntimeError, match="already ended"):
            tr.end_at(s, s.t_start + 1.0)
        with tr.span("outer", "req-2", k=1) as outer:
            with tr.span("inner", "req-2", parent=outer):
                pass
        with pytest.raises(KeyError):
            with tr.span("failing", "req-3"):
                raise KeyError("boom")
        by_name = {x.name: x for x in tr.recorder.spans()}
        assert by_name["outer"].status == by_name["inner"].status == "ok"
        assert by_name["inner"].parent_id == by_name["outer"].span_id
        assert by_name["outer"].tags == {"k": 1}
        assert by_name["failing"].status == "error"
        assert len(tr.recorder) == 4
    finally:
        T.disable()
