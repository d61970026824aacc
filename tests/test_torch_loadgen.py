"""The port's open-loop load generator against the JAX package's.

`repro.streaming.loadgen` is numpy-only, so both packages run the same
code path: equal constructor arguments must give byte-identical
schedules (every arrival's uid, stream, time and label) and images
(tolerance 0).  Also the reference's own loadgen tests, on the port.
"""
import time

import numpy as np
import pytest

from repro.streaming import loadgen as J
from repro_torch.streaming import loadgen as T

ARGS = [dict(process="poisson", rate_qps=400, duration_s=2.0, n_streams=4, seed=11),
        dict(process="bursty", rate_qps=800, n_requests=300, n_streams=3, seed=5,
             burst_on_s=0.1, burst_off_s=0.3),
        dict(process="diurnal", rate_qps=600, duration_s=1.5, n_streams=2, seed=9,
             diurnal_floor=0.25),
        dict(process="poisson", rate_qps=50, n_requests=40, n_streams=1, seed=0)]


@pytest.mark.parametrize("kw", ARGS, ids=lambda kw: f"{kw['process']}-{kw['seed']}")
def test_schedule_and_images_byte_identical_to_reference(kw):
    got, want = T.LoadGen(**kw), J.LoadGen(**kw)
    a, b = got.schedule(), want.schedule()
    assert len(a) == len(b) > 0
    assert [(x.uid, x.stream, x.t, x.label) for x in a] == \
        [(x.uid, x.stream, x.t, x.label) for x in b]
    assert got.describe() == want.describe()
    assert got.offered_qps == want.offered_qps
    assert T.arrival_cv(got) == J.arrival_cv(want)
    imgs_got, imgs_want = got.images(), want.images()
    assert imgs_got.dtype == imgs_want.dtype == np.float32
    assert imgs_got.tobytes() == imgs_want.tobytes()


def test_sweep_processes_match_reference():
    got = T.sweep_processes(300.0, n_requests=60, n_streams=2, seed=4)
    want = J.sweep_processes(300.0, n_requests=60, n_streams=2, seed=4)
    assert [g.process for g in got] == [w.process for w in want] == list(T.PROCESSES)
    for g, w in zip(got, want):
        assert [x.t for x in g.schedule()] == [x.t for x in w.schedule()]


# -- the reference's own tests, on the port ----------------------------------------

@pytest.mark.parametrize("process", T.PROCESSES)
def test_schedule_deterministic_per_seed(process):
    mk = lambda: T.LoadGen(process=process, rate_qps=400, duration_s=2.0,  # noqa: E731
                           n_streams=4, seed=11)
    a, b = mk().schedule(), mk().schedule()
    assert a == b and len(a) > 0
    c = T.LoadGen(process=process, rate_qps=400, duration_s=2.0, n_streams=4,
                  seed=12).schedule()
    assert [x.t for x in a] != [x.t for x in c]


@pytest.mark.parametrize("process", T.PROCESSES)
def test_schedule_shape(process):
    gen = T.LoadGen(process=process, rate_qps=600, duration_s=2.0, n_streams=3, seed=0)
    sched = gen.schedule()
    ts = [a.t for a in sched]
    assert ts == sorted(ts)
    assert [a.uid for a in sched] == list(range(len(sched)))
    assert all(0.0 <= a.t < gen.duration_s for a in sched)
    assert {a.stream for a in sched} <= set(range(3))
    assert all(0 <= a.label <= 9 for a in sched)
    lo, hi = (0.5, 1.7) if process == "bursty" else (0.7, 1.3)
    assert lo * 600 <= gen.offered_qps <= hi * 600


def test_images_deterministic_and_shaped():
    gen = T.LoadGen(process="poisson", rate_qps=100, n_requests=32, seed=3)
    imgs = gen.images()
    assert imgs.shape == (len(gen), 28, 28, 1) and imgs.dtype == np.float32
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0
    a = gen.schedule()[5]
    np.testing.assert_array_equal(gen.image(a), imgs[5])


def test_fixed_count_mode_and_bad_args():
    gen = T.LoadGen(process="poisson", rate_qps=500, n_requests=250, seed=0)
    assert gen.duration_s == pytest.approx(0.5)
    for kw in (dict(rate_qps=10, duration_s=1.0, n_requests=10), dict(rate_qps=10),
               dict(process="lunar", rate_qps=10, duration_s=1.0),
               dict(rate_qps=0, duration_s=1.0), dict(rate_qps=10, duration_s=1.0, n_streams=0),
               dict(rate_qps=10, duration_s=1.0, diurnal_floor=0.0)):
        with pytest.raises(ValueError):
            T.LoadGen(**kw)


def test_bursty_is_burstier_than_poisson():
    kw = dict(rate_qps=800, duration_s=4.0, n_streams=2, seed=5)
    assert T.arrival_cv(T.LoadGen(process="bursty", **kw)) > \
        1.3 * T.arrival_cv(T.LoadGen(process="poisson", **kw))


def test_replay_open_loop_clocking():
    gen = T.LoadGen(process="poisson", rate_qps=200, duration_s=0.4, n_streams=2, seed=1)
    got = []
    t0 = time.perf_counter()
    n = gen.replay(lambda a, t: got.append((a, t)))
    wall = time.perf_counter() - t0
    assert n == len(gen) == len(got)
    stamps = [t for _, t in got]
    assert stamps == sorted(stamps)
    assert stamps[-1] - stamps[0] == pytest.approx(
        gen.schedule()[-1].t - gen.schedule()[0].t, abs=1e-6)
    assert wall >= gen.schedule()[-1].t * 0.9
    t0 = time.perf_counter()
    gen.replay(lambda a, t: None, speed=20.0)
    assert time.perf_counter() - t0 < 0.3
