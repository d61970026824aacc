"""Each metric's arithmetic on synthetic readings, the frozen work counts,
and the trace's interval arithmetic."""
import numpy as np
import pytest

from bench import harness
from bench.trace import DeviceTrace, HostSpans
from bench.work import peaks as P
from bench.work import smallnet as W

PEAKS = P.PEAKS["H100"]


def read(name, rec):
    return harness.load_metric(name)(rec)


def test_work_counts_are_todays_numbers():
    b1, o1 = W.smallnet_work(1, 28, 28, 10)
    b2, o2 = W.smallnet_work(2, 28, 28, 10)
    assert b2 - b1 == 3176 and o1 == 8820
    nb, ops = W.frame_trunk_work(1080, 1920)
    assert (nb - 40) / (1080 * 1920) == 5.0 and ops / (1080 * 1920) == 18.5
    assert W.window_head_work(144, 28, 28, 49, 10) == (4 * (4 * 784 + 288 + 490 + 10 + 1440),
                                                       2 * 144 * 490)
    assert W.float_smallnet_work(1, 28, 28, 10, "plan")[1] == 13515
    assert W.conv_float_work(1, 28, 28, 1, 2, 2, 1, 28, 28, "plan") == (4 * (784 + 4 + 1 + 784),
                                                                       784 * 12)
    assert W.PARAM_WORDS == 510


def test_function_level_work():
    assert W.served_step_work(100, 2, "int32") == (4 * (100 * 794 + 2 * 510), 100 * 8820)
    assert W.served_step_work(1, 1, "float32")[1] == 13515
    nb, ops = W.sweep_frame_work(720, 1280, 13904)
    assert nb == 4 * (720 * 1280 + 510 + 139040)
    assert ops == 296 * 180 * 320 + 2 * 13904 * 490


def test_peaks_and_bound():
    assert P.peaks_for("NVIDIA H100 80GB HBM3")["int32"] == pytest.approx(16.727e12, rel=1e-3)
    with pytest.raises(KeyError):
        P.peaks_for("NVIDIA A100-SXM4-80GB")
    assert P.bound_s(3.35e6, 0, "int32", PEAKS) == pytest.approx(1e-6)
    assert P.bound_s(0, 67e6, "float32", PEAKS) == pytest.approx(1e-6)


def _fleet(**kw):
    rec = {"kind": "fleet", "seconds": 10.0, "limit_ms": 50.0,
           "latency_ms": np.concatenate([np.full(98, 5.0), [60.0, 10_000.0]]),
           "late_ms": np.linspace(0, 1, 100), "answered_in_time": 98, "answered": 99,
           "submitted": 100, "shed": 1,
           "engines": [{"batches": 10, "padded_slots": 540, "busy_s": 0.02, "batch_size": 64},
                       {"batches": 5, "padded_slots": 270, "busy_s": 0.01, "batch_size": 64}],
           "config": {"arithmetic": "int32"}, "peaks": PEAKS, "setup_s": 12.5,
           "trace": {"kernel_s": 1e-4, "busy_s": 0.5, "window_s": 10.0}}
    rec.update(kw)
    return rec


def test_fleet_metrics():
    rec = _fleet()
    assert read("requests_per_s", rec) == 9.8
    assert read("request_p99_ms", rec) == 60.0              # nearest rank 99 of 100
    assert read("loadgen_late_ms.tail", rec) == pytest.approx(98 / 99)
    assert read("batch_occupancy.fleet", rec) == pytest.approx(100 * 150 / 960)
    assert read("engine_step_ms.fleet", rec) == pytest.approx(2.0)
    assert read("device_idle_share.fleet", rec) == pytest.approx(95.0)
    assert read("mfu.fleet", rec) == pytest.approx(100 * 99 * 8820 / (10 * PEAKS["int32"]))
    bound = 4 * (150 * 794 + 15 * 510) / PEAKS["hbm_bytes_per_s"]
    assert read("serve_step_roofline", rec) == pytest.approx(100 * bound / 1e-4)
    assert read("setup_s", rec) == 12.5
    for name in ("frames_per_s", "stage_ms.infer", "sweep_frame_roofline", "mfu.sweep",
                 "device_idle_share.sweep"):
        assert read(name, rec) is None


def test_metrics_read_nothing_without_a_trace():
    rec = _fleet(trace=None)
    for name in ("serve_step_roofline", "device_idle_share.fleet", "mfu.fleet"):
        assert read(name, rec) is None


def test_sweep_metrics():
    rec = {"kind": "sweep", "seconds": 10.0, "frames_done": 20, "frames_swept": 22,
           "frame_shape": (112, 112), "n_windows": 144,
           "stage_p50_ms": {"aggregate": 1.5, "infer": 3.0, "tile": 0.1},
           "config": {"arithmetic": "float32"}, "peaks": PEAKS, "setup_s": 3.0,
           "trace": {"kernel_s": 0.01, "busy_s": 0.2, "window_s": 10.0}}
    assert read("frames_per_s", rec) == 2.0
    assert read("stage_ms.aggregate", rec) == 1.5 and read("stage_ms.infer", rec) == 3.0
    nb, ops = W.sweep_frame_work(112, 112, 144)
    assert read("sweep_frame_roofline", rec) == pytest.approx(
        100 * 22 * P.bound_s(nb, ops, "float32", PEAKS) / 0.01)
    assert read("mfu.sweep", rec) == pytest.approx(100 * 20 * ops / (10.0 * 67e12))
    assert read("device_idle_share.sweep", rec) == pytest.approx(98.0)
    assert read("requests_per_s", rec) is None and read("request_p99_ms", rec) is None


def test_trace_union_gaps_and_labels():
    dt = DeviceTrace()
    dt.window = (0.0, 1.0)
    dt.events = [("k1", 0.1, 0.2), ("Memcpy HtoD (Pageable -> Device)", 0.15, 0.3),
                 ("k2", 0.5, 0.6), ("k3", 0.95, 1.2)]
    assert dt.busy_intervals() == [(0.1, 0.3), (0.5, 0.6), (0.95, 1.0)]
    s = dt.summary()
    assert s["busy_s"] == pytest.approx(0.35) and s["kernel_s"] == pytest.approx(0.45)
    assert s["n_ops"] == 4 and s["device_ops"][0][0] == "k3"
    assert [tuple(round(x, 6) for x in g) for g in s["gaps"]] == [(0.0, 0.1), (0.3, 0.5),
                                                                   (0.6, 0.95)]
    spans = HostSpans()
    spans._times["step"].extend([0.25, 0.45])
    spans._times["drain"].extend([0.0, 0.9])
    got = spans.label_gaps(s["gaps"], ["step", "drain"], "idle")
    assert got[0][0] == "drain (2 gaps)" and got[0][1] == pytest.approx(0.45)
    assert got[1][0] == "step (1 gaps)" and got[1][1] == pytest.approx(0.2)


def test_host_spans_wrap_times_each_call():
    class Thing:
        def work(self, x):
            return x + 1
    t, spans = Thing(), HostSpans()
    spans.wrap(t, "work", "work")
    assert t.work(1) == 2 and t.work(2) == 3
    assert len(spans.spans("work")) == 2
