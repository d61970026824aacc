"""The serving queue's contract, held on the port and on the JAX reference.

`VisionEngine` (backend "fixed" on the CPU, batch 4) and `StageEngine` (a
stub compute, one request a step) keep one discipline over their queue and
their request ledger.  Every case below runs the same assertions on the
port's engine and on the reference's, so the port is held to the
reference wherever the two behave alike:

  * the door sheds "queue_depth" past `max_queue`, and "fault" once the
    serving thread died;
  * `stop(drain=False)` sheds what is queued as "stopped", with and
    without a serving thread;
  * a serving-thread fault sheds the step in flight and the whole queue
    as "fault";
  * `wait` on a dead started server: `VisionEngine` raises
    `EngineFaultError`, `StageEngine` returns with the uids unresolved;
  * `wait` without a thread serves inline; an unknown uid raises
    KeyError; a wait past its timeout raises TimeoutError;
  * an inline step fault raises through `wait`: `StageEngine` closes its
    door, `VisionEngine` keeps it open;
  * a deadline that lapsed in the queue sheds at batch forming;
  * pops hand over and forget, and leave the counts as they were;
  * `stats()["accounted"]` (submitted == served + shed + pending) after
    each of them.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import disagg as jdis  # noqa: E402
from repro.serving import vision_engine as jve  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.serving import disagg as tdis  # noqa: E402
from repro_torch.serving import vision_engine as tve  # noqa: E402

BATCH = 4
SUBJECTS = [("vision", "port"), ("vision", "ref"), ("stage", "port"), ("stage", "ref")]


def _params():
    rng = np.random.default_rng(30)
    p = {"conv1": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
         "conv2": {"w": rng.uniform(-1.5, 1.5, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
         "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}
    return {k: {n: a.astype(np.float32) for n, a in v.items()} for k, v in p.items()}


class Subject:
    """One server under the contract: how to build it, what it takes, how
    to break its step, and what `wait` does once its serving thread died."""

    def __init__(self, kind: str, pkg: str):
        self.kind, self.pkg = kind, pkg
        self.per_step = BATCH if kind == "vision" else 1
        self.fault_error = (tve if pkg == "port" else jve).EngineFaultError
        self._step = None

    def make(self, **kw):
        if self.kind == "stage":
            cls = (tdis if self.pkg == "port" else jdis).StageEngine

            def compute(payload):
                return (self._step or (lambda p: 2 * p))(payload)
            return cls(compute, name="contract", **kw)
        if self.pkg == "port":
            return tve.VisionEngine(params_from_jax(_params(), "cpu"), backend="fixed",
                                    device="cpu", batch_size=BATCH, warmup=False, **kw)
        return jve.VisionEngine(_params(), backend="fixed", batch_size=BATCH,
                                warmup=False, **kw)

    def payload(self, i: int):
        if self.kind == "stage":
            return i
        return np.full((28, 28, 1), (i % 7) / 7.0, np.float32)

    def break_step(self, eng, fn) -> None:
        """Make every later step of `eng` call `fn` (which may block or
        raise) in place of its compute."""
        if self.kind == "stage":
            self._step = fn
        else:
            eng._step_fn = lambda *args: fn(args)


@pytest.fixture(params=SUBJECTS, ids=["-".join(s) for s in SUBJECTS])
def subject(request):
    return Subject(*request.param)


def _blocker():
    """A step that blocks until released, then raises."""
    entered, release = threading.Event(), threading.Event()

    def step(_):
        entered.set()
        release.wait(10)
        raise RuntimeError("device fault")
    return step, entered, release


def _accounted(eng) -> dict:
    st = eng.stats()
    assert st["accounted"], st
    return st


def _killed(subject, n=6):
    """A started server whose serving thread died on its first step, with
    `n` requests submitted before it did: -> (engine, uids)."""
    eng = subject.make()
    step, entered, release = _blocker()
    subject.break_step(eng, step)
    uids = [eng.submit(subject.payload(i)) for i in range(n)]
    eng.start()
    assert entered.wait(10)
    release.set()
    t_end = time.perf_counter() + 10
    while eng.fault is None or eng.stats()["pending"]:
        assert time.perf_counter() < t_end, "the serving thread never died"
        time.sleep(0.001)
    return eng, uids


def test_door_sheds_queue_depth_past_max_queue(subject):
    eng = subject.make(max_queue=3)
    uids = [eng.submit(subject.payload(i)) for i in range(5)]
    assert eng.pop_shed(uids) == {uids[3]: "queue_depth", uids[4]: "queue_depth"}
    st = _accounted(eng)
    assert st["submitted"] == 5 and st["pending"] == 3
    assert st["shed_by_reason"] == {"queue_depth": 2}


def test_thread_fault_sheds_the_step_and_the_queue_as_fault(subject):
    eng, uids = _killed(subject)
    assert isinstance(eng.fault, RuntimeError)
    assert eng.pop_shed(uids) == {u: "fault" for u in uids}
    st = _accounted(eng)
    assert st["n"] == 0 and st["pending"] == 0 and st["shed_by_reason"] == {"fault": 6}
    eng.stop()


def test_door_sheds_fault_once_serving_died(subject):
    eng, _ = _killed(subject)
    late = [eng.submit(subject.payload(i)) for i in range(2)]
    assert eng.pop_shed(late) == {u: "fault" for u in late}
    assert _accounted(eng)["shed_by_reason"] == {"fault": 8}
    eng.stop()


def test_wait_on_a_dead_started_server(subject):
    eng, uids = _killed(subject)
    eng.wait(uids, timeout=5)                 # every one of them was shed
    if subject.kind == "vision":
        with pytest.raises(subject.fault_error):
            eng.wait([10 ** 9], timeout=5)
    else:
        t0 = time.perf_counter()
        assert eng.wait([10 ** 9], timeout=5) is None
        assert time.perf_counter() - t0 < 1.0      # returns, not times out
    _accounted(eng)
    eng.stop()


def test_stop_without_drain_sheds_stopped(subject):
    idle = subject.make()
    queued = [idle.submit(subject.payload(i)) for i in range(3)]
    idle.stop(drain=False)
    assert idle.pop_shed(queued) == {u: "stopped" for u in queued}
    assert _accounted(idle)["pending"] == 0

    eng = subject.make()
    entered, release = threading.Event(), threading.Event()

    def held(payload):
        entered.set()
        release.wait(10)
        return 2 * payload
    if subject.kind == "vision":
        eng._step_fn = _held_stand_in(eng._step_fn, entered, release)
    else:
        subject.break_step(eng, held)
    uids = [eng.submit(subject.payload(i)) for i in range(subject.per_step + 3)]
    eng.start()                           # its first step takes `per_step` of them
    assert entered.wait(10)

    def release_once_stopped():
        t_end = time.perf_counter() + 10
        while eng.stats()["shed"] < 3 and time.perf_counter() < t_end:
            time.sleep(0.001)
        release.set()
    th = threading.Thread(target=release_once_stopped)
    th.start()
    eng.stop(drain=False)
    th.join(10)
    assert not th.is_alive()
    assert eng.pop_shed(uids) == {u: "stopped" for u in uids[subject.per_step:]}
    assert set(eng.pop_results(uids)) == set(uids[:subject.per_step])
    st = _accounted(eng)
    assert st["n"] == subject.per_step and st["pending"] == 0


def _held_stand_in(real, entered, release):
    """A `VisionEngine` stand-in step that blocks until released, then
    returns the real step's scores."""
    def step(*args):
        entered.set()
        release.wait(10)
        return real(*args)
    return step


def test_wait_without_a_thread_serves_inline(subject):
    eng = subject.make()
    uids = [eng.submit(subject.payload(i)) for i in range(6)]
    eng.wait(uids)
    res = eng.pop_results(uids)
    assert sorted(res) == uids and all(res[u].uid == u for u in uids)
    assert all(r.latency_s >= 0 and r.within_deadline for r in res.values())
    if subject.kind == "stage":
        assert [res[u].value for u in uids] == [2 * i for i in range(6)]
    st = _accounted(eng)
    assert st["n"] == 6 and st["pending"] == 0 and st["shed"] == 0


def test_wait_without_a_thread_on_an_unknown_uid_raises(subject):
    eng = subject.make()
    with pytest.raises(KeyError):
        eng.wait([10 ** 9])
    _accounted(eng)


def test_wait_past_its_timeout_raises(subject):
    eng = subject.make()
    step, entered, release = _blocker()
    subject.break_step(eng, step)
    uid = eng.submit(subject.payload(0))
    eng.start()
    assert entered.wait(10)
    with pytest.raises(TimeoutError):
        eng.wait([uid], timeout=0.05)
    release.set()
    eng.wait([uid], timeout=10)
    assert eng.pop_shed([uid]) == {uid: "fault"}
    _accounted(eng)
    eng.stop()


def test_inline_step_fault_raises_through_wait(subject):
    eng = subject.make()

    def broken(_):
        raise RuntimeError("device fault")
    subject.break_step(eng, broken)
    uids = [eng.submit(subject.payload(i)) for i in range(2)]
    with pytest.raises(RuntimeError, match="device fault"):
        eng.wait(uids)
    shed = eng.pop_shed(uids)
    assert set(shed.values()) == {"fault"} and len(shed) == min(2, subject.per_step)
    late = eng.submit(subject.payload(2))
    if subject.kind == "stage":           # a faulted compute closes the door
        assert eng.fault is not None and eng.pop_shed([late]) == {late: "fault"}
    else:                                 # only a dead thread closes it
        assert eng.fault is None and eng.pop_shed([late]) == {}
    _accounted(eng)


def test_lapsed_deadline_sheds_at_batch_forming(subject):
    eng = subject.make()
    uids = [eng.submit(subject.payload(i), deadline_ms=0.01) for i in range(3)]
    time.sleep(0.01)
    assert eng.step() == 0
    assert eng.pop_shed(uids) == {u: "deadline" for u in uids}
    st = _accounted(eng)
    assert st["pending"] == 0 and st["shed_by_reason"] == {"deadline": 3}


def test_pops_hand_over_and_forget(subject):
    eng = subject.make(max_queue=4)
    uids = [eng.submit(subject.payload(i)) for i in range(6)]
    eng.wait(uids)
    first = eng.pop_results(uids[:2])
    assert sorted(first) == uids[:2]
    assert eng.pop_results(uids[:2]) == {}
    assert sorted(eng.pop_results()) == uids[2:4]
    assert eng.pop_results() == {}
    assert eng.pop_shed(uids[4:5]) == {uids[4]: "queue_depth"}
    assert eng.pop_shed() == {uids[5]: "queue_depth"}
    assert eng.pop_shed() == {}
    st = _accounted(eng)
    assert st["n"] == 4 and st["shed_by_reason"] == {"queue_depth": 2}
