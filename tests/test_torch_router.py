"""The port's ReplicaRouter and the engine knobs it reads, on the CPU.

Mirrors `tests/test_router_dispatch.py` (the router's three dispatch fixes: the
cold-fleet SLO hole, round-robin re-aliasing under churn, the torn slo
snapshot) and the router and engine-knob cases of
`tests/test_continuous_serving.py`, on the port's `fixed` and `ref`
backends on `device="cpu"`.  `_projected_waits_from` is held to the
reference's on the same frozen snapshots (equal floats).  Served scores
are held to the reference's `smallnet.apply` (int32 words exact on
`fixed`, float within 1e-5 on `ref`).  A deterministic-capacity step (a
sleep, then zero scores) stands in where a test needs a known service
rate, as in the reference's tests.
"""
import collections
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import smallnet as jsn  # noqa: E402
from repro.serving.router import ReplicaRouter as JRouter  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.data import synth_mnist  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.serving.router import (FleetExhaustedError,  # noqa: E402
                                        ReplicaRouter, RoutedResult)
from repro_torch.serving.vision_engine import VisionEngine  # noqa: E402
from repro_torch.streaming.loadgen import LoadGen  # noqa: E402

BACKENDS = ["fixed", "ref"]
IMG = np.zeros((28, 28, 1), np.float32)


def numpy_params(seed=0):
    rng = np.random.default_rng(seed)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, 0.5, (1,))},
         "dense": {"w": rng.uniform(-0.6, 0.6, (49, 10)),
                   "b": rng.normal(0, 0.5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


@pytest.fixture(scope="module")
def setup():
    images, _ = synth_mnist.make_dataset(104, seed=31)
    return numpy_params(3), images


def _params(setup):
    return params_from_jax(setup[0], "cpu")


def _engine(setup, **kw):
    kw.setdefault("backend", "ref")
    kw.setdefault("batch_size", 1)
    kw.setdefault("warmup", False)
    return VisionEngine(_params(setup), device="cpu", **kw)


def _router(setup, backends, **kw):
    kw.setdefault("warmup", False)
    return ReplicaRouter.from_backends(_params(setup), backends, device="cpu", **kw)


def _slow_step(batch_size: int, delay_s: float):
    """Deterministic-capacity stand-in for the device step: the service
    rate is exactly batch_size/delay_s, independent of the host."""
    def f(batch):
        time.sleep(delay_s)
        return torch.zeros((batch_size, 10), dtype=torch.float32)
    return f


def _reference_scores(params, images, backend):
    fn = jax.jit(lambda p, x: jsn.apply(p, x, backend=backend))
    return np.asarray(fn(params, jnp.asarray(images)))


# -- the engine knobs ----------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_seed_rate_comes_from_min_step_floor(setup, backend):
    eng = _engine(setup, backend=backend, batch_size=4, min_step_s=0.05)
    assert eng.service_rate_qps() is None
    assert eng.seed_rate_qps() == pytest.approx(80.0)     # 4 / 0.05
    assert _engine(setup, backend=backend).seed_rate_qps() is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_min_step_floor_is_the_service_time(setup, backend):
    eng = _engine(setup, backend=backend, batch_size=4, min_step_s=0.03)
    eng.serve(list(setup[1][:8]))                          # two steps
    st = eng.stats()
    assert st["batches"] == 2 and st["busy_s"] >= 2 * 0.03
    assert eng.service_rate_qps() <= eng.seed_rate_qps() * 1.0001


@pytest.mark.parametrize("backend", BACKENDS)
def test_load_counts_queued_requests_until_they_end(setup, backend):
    eng = _engine(setup, backend=backend, batch_size=4)
    uids = eng.submit_many(list(setup[1][:3]), deadline_ms=0.01)
    assert eng.load() == 3
    time.sleep(0.01)
    assert eng.run() == 0                                  # every deadline lapsed
    assert eng.pop_shed(uids) == {u: "deadline" for u in uids}
    assert eng.load() == 0
    st = eng.stats()
    assert st["deadline_total"] == 3 and st["goodput"] == 0.0 and st["accounted"]
    kept = eng.submit(setup[1][0], deadline_ms=60_000.0)
    assert eng.load() == 1
    assert eng.run() == 1 and kept in eng.pop_results([kept]) and eng.load() == 0


# -- 1. cold-fleet SLO hole ----------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_cold_fleet_slo_door_sheds_on_burst(setup, backend):
    router = ReplicaRouter([_engine(setup, backend=backend, min_step_s=0.05)
                            for _ in range(2)], policy="slo", slo_ms=100.0)
    uids = [router.submit(IMG) for _ in range(40)]
    shed = router.pop_shed(uids)
    st = router.stats()
    assert st["n"] == 0 and shed
    assert set(shed.values()) == {"slo_wait"}
    assert 2 <= len(uids) - len(shed) <= 8
    assert st["accounted"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_cold_fleet_unknown_rate_with_backlog_is_pessimistic(setup, backend):
    router = ReplicaRouter([_engine(setup, backend=backend)], policy="slo", slo_ms=50.0)
    first, second = router.submit(IMG), router.submit(IMG)
    shed = router.pop_shed([first, second])
    assert first not in shed and shed.get(second) == "slo_wait"


# -- 2. round-robin re-aliasing under churn ------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_round_robin_no_double_dispatch_on_failover(setup, backend):
    router = ReplicaRouter([_engine(setup, backend=backend) for _ in range(3)],
                           policy="round_robin")
    assert [router._pick()[0] for _ in range(3)] == [0, 1, 2]
    router._errors[0] = RuntimeError("replica 0 died")
    assert router._pick()[0] == 1
    assert router._pick()[0] == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_robin_near_uniform_under_spawn_retire_churn(setup, backend):
    router = ReplicaRouter([_engine(setup, backend=backend) for _ in range(3)],
                           policy="round_robin")
    phases = []

    def run_phase(n_picks):
        phases.append(collections.Counter(router._pick()[0] for _ in range(n_picks)))

    run_phase(7)
    router._errors[1] = RuntimeError("fault")
    run_phase(8)
    router.replicas.append(_engine(setup, backend=backend))
    router._pending.append([])
    router._served_by.setdefault(3, 0)
    run_phase(9)
    router._retired.add(0)
    run_phase(8)
    for counts in phases:
        assert max(counts.values()) - min(counts.values()) <= 1, phases
    picks = [router._pick()[0] for _ in range(6)]
    assert all(a != b for a, b in zip(picks, picks[1:]))


# -- 3. torn slo pick snapshot -------------------------------------------------------

class _ShiftyReplica:
    """A replica whose load() changes between successive reads."""

    def __init__(self, loads, rate):
        self._loads = list(loads)
        self._rate = rate
        self.load_calls = 0
        self.batch_size = 8

    def load(self):
        self.load_calls += 1
        return self._loads.pop(0) if len(self._loads) > 1 else self._loads[0]

    def service_rate_qps(self):
        return self._rate

    def seed_rate_qps(self):
        return None


def test_slo_pick_reads_one_snapshot():
    shifty = _ShiftyReplica(loads=[0, 100], rate=50.0)
    steady = _ShiftyReplica(loads=[0], rate=50.0)
    router = ReplicaRouter([shifty, steady], policy="slo", slo_ms=100.0)
    i, shed = router._pick(100.0)
    assert shed is None and i == 0
    assert shifty.load_calls == 1 and steady.load_calls == 1


SNAPSHOTS = [
    {0: (4, 50.0, None, 8), 1: (4, None, 25.0, 8), 2: (0, None, None, 8),
     3: (9, None, None, 8)},
    {0: (4, None, 25.0, 8), 1: (2, None, None, 8)},
    {0: (8, None, None, 8), 1: (7, None, None, 8)},
    {0: (0, None, None, 1), 1: (1, None, None, 0)},
    {0: (3, 10.0, 40.0, 4), 1: (5, 30.0, None, 4), 2: (7, None, None, 4)},
]


@pytest.mark.parametrize("snapshot", SNAPSHOTS)
def test_projected_waits_equal_reference_on_frozen_snapshots(snapshot):
    got = ReplicaRouter._projected_waits_from(dict(snapshot))
    assert got == JRouter._projected_waits_from(dict(snapshot))
    assert got == ReplicaRouter._projected_waits_from(dict(snapshot))


def test_projected_waits_on_random_snapshots_equal_reference():
    rng = np.random.default_rng(17)
    for _ in range(50):
        n = int(rng.integers(1, 6))
        snap = {i: (int(rng.integers(0, 20)),
                    float(rng.uniform(5, 500)) if rng.uniform() < 0.5 else None,
                    float(rng.uniform(5, 500)) if rng.uniform() < 0.3 else None,
                    int(rng.integers(1, 9))) for i in range(n)}
        assert ReplicaRouter._projected_waits_from(snap) == JRouter._projected_waits_from(snap)


def test_projected_waits_pure_given_frozen_snapshot():
    waits = ReplicaRouter._projected_waits_from(SNAPSHOTS[0])
    assert waits[0] == pytest.approx(4 / 50.0) and waits[1] == pytest.approx(4 / 50.0)
    assert waits[2] == 0.0 and waits[3] == pytest.approx(9 / 50.0)
    waits = ReplicaRouter._projected_waits_from(SNAPSHOTS[1])
    assert waits[0] == pytest.approx(4 / 25.0) and waits[1] == pytest.approx(2 / 25.0)
    waits = ReplicaRouter._projected_waits_from(SNAPSHOTS[2])
    assert waits[0] == float("inf") and waits[1] == 0.0


# -- serving through the fleet --------------------------------------------------------

@pytest.mark.parametrize("policy", ReplicaRouter.POLICIES)
def test_fleet_serves_the_reference_words_on_fixed(setup, policy):
    params, images = setup
    router = _router(setup, ["fixed", "fixed_cuda"], batch_size=8, policy=policy)
    res = router.serve(list(images[:40]))
    assert all(isinstance(r, RoutedResult) for r in res)
    want = _reference_scores(params, images[:40], "fixed")
    np.testing.assert_array_equal(np.stack([r.scores for r in res]), want)
    assert [r.pred for r in res] == np.argmax(want, axis=1).tolist()
    st = router.stats()
    assert st["accounted"] and st["n"] == 40 and st["shed"] == 0
    assert sum(st["served_by"].values()) == 40


def test_fleet_serves_the_reference_scores_on_ref(setup):
    params, images = setup
    router = _router(setup, ["ref", "ref"], batch_size=8)
    res = router.serve(list(images[:24]))
    np.testing.assert_allclose(np.stack([r.scores for r in res]),
                               _reference_scores(params, images[:24], "ref"),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_router_resident_results_stay_bounded(setup, backend):
    images = setup[1]
    router = _router(setup, [backend, backend], batch_size=8)
    for i in range(40):
        res = router.serve([images[i % 100], images[(i + 1) % 100]])
        assert len(res) == 2
        assert router.results() == {} and len(router._assignment) == 0
        assert router.pop_shed() == {}
    assert router.stats()["n"] == 80


@pytest.mark.parametrize("backend", BACKENDS)
def test_admission_shed_accounting_under_2x_poisson(setup, backend):
    eng = _engine(setup, backend=backend, batch_size=8, max_queue=16)
    eng._step_fn = _slow_step(8, 0.010)                  # capacity: 800 qps
    gen = LoadGen(process="poisson", rate_qps=1600, n_requests=200, n_streams=4, seed=7)
    eng.start()
    try:
        gen.replay(lambda a, t: eng.submit(IMG, t_submit=t))
    finally:
        eng.stop(drain=True)
    s = eng.stats()
    assert s["submitted"] == len(gen) and s["shed"] > 0
    assert s["shed_by_reason"].get("queue_depth", 0) == s["shed"]
    assert s["pending"] == 0 and s["n"] + s["shed"] == len(gen) and s["accounted"]
    assert s["queue_hwm"] <= 16


@pytest.mark.parametrize("backend", BACKENDS)
def test_slo_router_sheds_instead_of_blowing_p99(setup, backend):
    def mk(policy, **kw):
        r = _router(setup, [backend], batch_size=8, policy=policy, **kw)
        r.replicas[0]._step_fn = _slow_step(8, 0.010)
        r.serve([IMG] * 8)                               # one batch: the observed rate
        return r

    ll = mk("least_loaded")
    ll.serve([IMG] * 100)
    slo = mk("slo", slo_ms=25.0)
    res = slo.serve([IMG] * 100)
    s_ll, s_slo = ll.stats(), slo.stats()
    assert s_ll["shed"] == 0
    assert s_slo["shed_by_reason"]["slo_wait"] >= 30
    assert s_slo["latency_p99_ms"] < s_ll["latency_p99_ms"]
    assert s_slo["latency_p99_ms"] < 100.0
    assert s_slo["accounted"] and s_slo["goodput"] > 0.0
    assert sum(r is None for r in res) == s_slo["shed"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_slo_dispatch_prefers_faster_replica(setup, backend):
    router = _router(setup, [backend, backend], batch_size=8, policy="slo")
    router.replicas[0]._step_fn = _slow_step(8, 0.050)   # 160 qps
    router.replicas[1]._step_fn = _slow_step(8, 0.005)   # 1600 qps
    router.serve([IMG] * 32)
    with router._cond:
        router._pending[0] = []
        router._pending[1] = []
    assigned = [router._assignment[router.submit(IMG)] for _ in range(6)]
    assert assigned.count(1) > assigned.count(0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_router_fleet_ledger_reconciles_with_engine_sheds(setup, backend):
    images = setup[1]
    router = _router(setup, [backend], batch_size=4, engine_kw={"max_queue": 4})
    uids = router.submit_many(list(images[:12]))
    router.run()
    router.wait(uids)
    s = router.stats()
    assert s["submitted"] == 12 and s["accounted"] and s["n"] + s["shed"] == 12
    assert s["shed"] > 0 and set(s["shed_by_reason"]) <= {"queue_depth"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_failover_serves_everything_on_the_survivors(setup, backend):
    params, images = setup
    router = _router(setup, [backend, backend, backend], batch_size=4,
                     policy="round_robin")

    def broken(batch):
        raise RuntimeError("device fault")
    router.replicas[1]._step_fn = broken
    res = router.serve(list(images[:30]))
    assert all(r is not None for r in res)
    assert {r.replica for r in res} == {0, 2}
    if backend == "fixed":
        np.testing.assert_array_equal(np.stack([r.scores for r in res]),
                                      _reference_scores(params, images[:30], "fixed"))
    st = router.stats()
    assert st["failed"] == [1] and st["healthy"] == 2
    assert st["accounted"] and st["n"] == 30 and st["shed"] == 0
    # every replica dead: the fleet says so instead of losing the requests
    for eng in router.replicas:
        eng._step_fn = broken
    router.submit_many(list(images[:4]))
    with pytest.raises(FleetExhaustedError):
        router.run()


@pytest.mark.parametrize("backend", BACKENDS)
def test_autoscale_spawns_under_backlog_and_retires_idle(setup, backend):
    images = setup[1]
    spawned = []

    def spawn():
        eng = _engine(setup, backend=backend, batch_size=4)
        spawned.append(eng)
        return eng

    router = _router(setup, [backend], batch_size=4, spawn=spawn, min_replicas=1,
                     max_replicas=3, scale_up_depth=2.0, scale_down_idle=2)
    router.submit_many(list(images[:20]))                # 20 > 2.0 * 4 capacity
    assert router.autoscale() == "spawn:1"
    assert len(router.replicas) == 2 and len(spawned) == 1
    uids = list(router._assignment)
    router.submit_many(list(images[20:24]))
    assert any(i == 1 for i in router._assignment.values())
    router.run()
    router.wait(uids)
    assert router.stats()["healthy"] == 2
    assert router.autoscale() is None
    retire = router.autoscale()
    assert retire is not None and retire.startswith("retire:")
    s = router.stats()
    assert s["healthy"] == 1 and len(s["retired"]) == 1
    assert router.autoscale() is None and router.autoscale() is None
    assert router.stats()["healthy"] == 1
    retired = int(retire.split(":")[1])
    live = [router._assignment[router.submit(images[0])] for _ in range(4)]
    assert retired not in live
    assert router.stats()["accounted"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_threaded_fleet_under_open_loop_replay(setup, backend):
    """start()/stop(): the serving thread drains what a LoadGen replay
    submits; every request ends served or shed and the ledger holds."""
    params, _ = setup
    gen = LoadGen(process="bursty", rate_qps=800, n_requests=120, n_streams=3, seed=2)
    images = gen.images()
    router = _router(setup, [backend, backend], batch_size=8, policy="slo", slo_ms=500)
    router.start()
    uids = []
    try:
        gen.replay(lambda a, t: uids.append(router.submit(images[a.uid], t_submit=t)))
        router.wait(uids, timeout=60)
    finally:
        router.stop()
    res, shed = router.pop_results(uids), router.pop_shed(uids)
    assert len(res) + len(shed) == len(uids) == len(gen)
    st = router.stats()
    assert st["accounted"] and st["pending"] == 0 and st["n"] == len(res)
    if backend == "fixed" and res:
        served = sorted(res)
        want = _reference_scores(params, images[served], "fixed")
        np.testing.assert_array_equal(np.stack([res[u].scores for u in served]), want)


def test_dispatch_emits_point_spans(setup):
    """One dispatch span a submit, over the whole call."""
    tr = T.enable(capacity=1024)
    try:
        router = ReplicaRouter([_engine(setup)], policy="slo", slo_ms=50.0)
        t0 = time.perf_counter()
        first = router.submit(IMG)
        t1 = time.perf_counter()
        second = router.submit(IMG)                              # a door shed
        t2 = time.perf_counter()
        router.run()
        spans = [s for s in tr.recorder.spans() if s.name == "dispatch"]
    finally:
        T.disable()
    assert [s.status for s in spans] == ["ok", "shed:slo_wait"]
    assert t0 <= spans[0].t_start < spans[0].t_end <= t1
    assert t1 <= spans[1].t_start < spans[1].t_end <= t2
    assert spans[0].tags["replica"] == 0 and spans[1].tags["uid"] == second
    assert router.pop_shed([second]) == {second: "slo_wait"}
    assert first in router.pop_results([first])


def test_unresolved_names_the_uids_neither_served_nor_shed(setup):
    router = ReplicaRouter([_engine(setup, max_queue=2)], policy="round_robin")
    uids = router.submit_many([IMG] * 3)
    assert router.unresolved(uids) == uids                  # still on the lane
    router.wait(uids)
    assert router.unresolved(uids) == []
    assert router.pop_shed(uids) == {uids[2]: "queue_depth"}
    assert sorted(router.pop_results(uids)) == uids[:2]
    assert router.unresolved(uids) == uids                  # popped: unknown again
    with pytest.raises(KeyError):
        router.wait(uids)
    assert router.stats()["accounted"]


def test_dispatch_span_counts_the_wait_for_the_lock(setup):
    router = ReplicaRouter([_engine(setup)], policy="round_robin")
    held, release = threading.Event(), threading.Event()

    def hold():
        with router._cond:
            held.set()
            release.wait(5)
    th = threading.Thread(target=hold)
    th.start()
    held.wait(5)
    tr = T.enable(capacity=64)
    try:
        threading.Timer(0.05, release.set).start()
        t0 = time.perf_counter()
        router.submit(IMG)
        spans = tr.recorder.spans()
    finally:
        T.disable()
        release.set()
        th.join()
    (d,) = spans
    assert d.name == "dispatch" and d.t_start - t0 < 0.01 and d.duration_s >= 0.04


def test_drain_span_contains_the_steps_it_ran(setup):
    tr = T.enable(capacity=4096)
    try:
        router = ReplicaRouter([_engine(setup, batch_size=4), _engine(setup, batch_size=4)],
                               policy="round_robin")
        router.submit_many([IMG] * 10)
        assert router.run() == 10
        spans = tr.recorder.spans()
    finally:
        T.disable()
    drains = {s.tags["replica"]: s for s in spans if s.name == "drain"}
    assert sorted(drains) == [0, 1] and sum(d.tags["lane"] for d in drains.values()) == 10
    assert all(d.status == "ok" for d in drains.values())
    ran = collections.Counter()
    for s in spans:
        if s.name in ("batch_form", "device_step", "finish"):
            i = next(i for i, e in enumerate(router.replicas) if e._id == s.tags["engine"])
            assert drains[i].t_start <= s.t_start and s.t_end <= drains[i].t_end, s
            ran[s.name] += 1
    assert ran["device_step"] == ran["finish"] == 4          # 5 a lane, 4 a step


def test_untraced_fleet_records_nothing(setup):
    tr = T.enable(capacity=64)
    T.disable()
    router = ReplicaRouter([_engine(setup, batch_size=4)], policy="slo", slo_ms=50.0)
    router.submit_many([IMG] * 3)
    assert router.run() == 3 and len(tr.recorder) == 0
