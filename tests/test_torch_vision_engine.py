"""The port's VisionEngine on the CPU, held to the JAX reference's words.

The engine runs on `device="cpu"`, where the `fixed_cuda` backend's
wrappers take their plain PyTorch versions.  Served score words must equal
the reference's `smallnet.apply` (tolerance 0), and the admission ledger
`submitted == served + shed + pending` must hold through sync and threaded
serving, sheds at the door and at batch forming, and a faulted step.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backends as JB  # noqa: E402
from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import smallnet as jsn  # noqa: E402
from repro_torch.core import backends as TB  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.data import synth_mnist  # noqa: E402
from repro_torch.obs import recorder as R  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.serving.vision_engine import (EngineFaultError,  # noqa: E402
                                               VisionEngine)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    params = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}
    params = {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in params.items()}
    images, _ = synth_mnist.make_dataset(20, seed=22)
    return params, images


def _reference(params, images, cfg_name="q16_16"):
    be = JB.FixedBackend(cfg=jfxp.STANDARD_CONFIGS[cfg_name])
    fn = jax.jit(lambda p, x: jsn.apply(p, x, backend=be))
    return np.asarray(fn(params, jnp.asarray(images)))


def _engine(params, **kw):
    kw.setdefault("batch_size", 8)
    return VisionEngine(params_from_jax(params, "cpu"), device="cpu", **kw)


def test_sync_run_matches_reference(setup):
    params, images = setup
    eng = _engine(params)
    uids = eng.submit_many(list(images))
    assert eng.run() == len(images)
    res = eng.pop_results(uids)
    scores = np.stack([res[u].scores for u in uids])
    want = _reference(params, images)
    np.testing.assert_array_equal(scores, want)
    assert [res[u].pred for u in uids] == np.argmax(want, axis=1).tolist()
    st = eng.stats()
    assert st["accounted"] and st["n"] == len(images) and st["batches"] == 3
    assert st["padded_slots"] == 3 * 8 - len(images) and st["device"] == "cpu"


@pytest.mark.parametrize("cfg_name", ["q16_16", "q8_8"])
def test_threaded_serve_matches_reference(setup, cfg_name):
    params, images = setup
    be = TB.FixedCudaBackend(cfg=tfxp.STANDARD_CONFIGS[cfg_name])
    eng = _engine(params, backend=be).start()
    try:
        res = eng.serve(list(images))
    finally:
        eng.stop()
    assert not eng.started
    np.testing.assert_array_equal(np.stack([r.scores for r in res]),
                                  _reference(params, images, cfg_name))
    st = eng.stats()
    assert st["accounted"] and st["n"] == len(images) and st["pending"] == 0
    assert st["throughput_qps"] > 0 and eng.service_rate_qps() > 0


def test_max_queue_sheds_at_the_door(setup):
    params, images = setup
    eng = _engine(params, max_queue=3, warmup=False)
    res = eng.serve(list(images[:5]))                  # 3 queued, 2 shed
    assert sum(r is None for r in res) == 2
    st = eng.stats()
    assert st["shed_by_reason"] == {"queue_depth": 2} and st["n"] == 3
    assert st["accounted"] and st["submitted"] == 5


def test_deadline_and_age_sheds_at_batch_forming(setup):
    params, images = setup
    eng = _engine(params, warmup=False)
    uids = [eng.submit(img, deadline_ms=0.01) for img in images[:3]]
    time.sleep(0.01)
    assert eng.run() == 0
    assert eng.pop_shed(uids) == {u: "deadline" for u in uids}
    assert eng.stats()["goodput"] == 0.0 and eng.stats()["accounted"]
    aged = _engine(params, warmup=False, max_age_ms=0.01)
    aged.submit_many(list(images[:2]))
    time.sleep(0.01)
    assert aged.run() == 0
    assert set(aged.pop_shed().values()) == {"age"}
    assert aged.stats()["accounted"]


def test_faulted_step_sheds_and_keeps_the_ledger(setup):
    params, images = setup
    eng = _engine(params, warmup=False)

    def broken(batch):
        raise RuntimeError("device fault")
    eng._step_fn = broken
    eng.start()
    uids = eng.submit_many(list(images[:6]))
    eng.wait(uids, timeout=30)
    assert isinstance(eng.fault, RuntimeError)
    assert set(eng.pop_shed(uids).values()) == {"fault"}
    late = eng.submit(images[0])
    assert eng.pop_shed([late]) == {late: "fault"}
    assert eng.stats()["accounted"]
    with pytest.raises(EngineFaultError):
        eng.wait([10 ** 9], timeout=5)
    eng.stop()


def test_traced_run_reconciles_spans_with_the_ledger(setup):
    params, images = setup
    tr = T.enable(capacity=4096)
    try:
        eng = _engine(params, max_queue=12, warmup=False)
        eng.serve(list(images[:16]))                   # 12 served, 4 shed
        spans = tr.recorder.spans()
    finally:
        T.disable()
    st = eng.stats()
    assert st["n"] == 12 and st["shed"] == 4
    assert R.reconcile(spans, served=st["n"], shed=st["shed"], root_name="request") == []
    assert any(s.name == "device_step" for s in spans)


def test_traced_step_splits_into_phases(setup):
    """A traced step's upload, forward and device_wait follow one another
    inside its device_step and cover it; finish follows it."""
    params, images = setup
    tr = T.enable(capacity=4096)
    try:
        eng = _engine(params, warmup=False)
        eng.submit_many(list(images[:10]))
        assert eng.run() == 10                         # two steps of 8
        spans = tr.recorder.spans()
    finally:
        T.disable()
    assert R.reconcile(spans, served=10, shed=0, root_name="request") == []
    steps = [s for s in spans if s.name == "device_step"]
    assert len(steps) == 2
    for ds in steps:
        kids = sorted((s for s in spans if s.parent_id == ds.span_id), key=lambda s: s.t_start)
        assert [k.name for k in kids] == ["upload", "forward", "device_wait"]
        assert kids[0].t_start == ds.t_start and kids[-1].t_end == ds.t_end
        assert all(a.t_end == b.t_start for a, b in zip(kids, kids[1:]))
        assert sum(k.duration_s for k in kids) >= ds.duration_s - 1e-6
        finish = [s for s in spans if s.name == "finish" and s.trace_id == ds.trace_id]
        assert len(finish) == 1 and finish[0].t_start == ds.t_end
        assert finish[0].t_end > finish[0].t_start and finish[0].parent_id is None


def test_untraced_step_records_nothing(setup):
    """With the tracer off a step passes no phases and records no span."""
    params, images = setup
    tr = T.enable(capacity=64)
    T.disable()
    eng = _engine(params, warmup=False)
    calls, inner = [], eng._step_fn
    eng._step_fn = lambda batch: calls.append(len(batch)) or inner(batch)
    eng.submit_many(list(images[:3]))
    assert eng.run() == 3
    assert calls == [8] and len(tr.recorder) == 0


def test_engine_without_a_device_needs_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    params, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        VisionEngine(params, batch_size=4, warmup=False)
