"""Each cell's run driven on the CPU at a size a test run holds, past the
run's look for a card: sound, it comes out correct; with the control
(the precision below the configuration's) in the program's place, or with
the timed path broken underneath, it comes out not correct.  On a card,
one short run of each cell through `bench/run.py`."""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import control, harness, program

SMALL = {
    "q16-fleet-tail": {"rate_qps": 150.0, "image_pool": 128},
    "plan-sweep-112": {"distinct_frames": 3},
}
SECONDS = 1.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(name):
    c = harness.cell(name)
    return dataclasses.replace(c, mix=dict(c.mix, **SMALL[name]))


def judged(run):
    run.setup()
    run.window()
    run.release()
    return run.check()


def correct(compared):
    return all(c.ok for c in compared)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    cell = small(name)
    run = harness.load_driver(cell.driver).Run(cell, 2**31 + 11, SECONDS, device="cpu")
    compared = judged(run)
    assert correct(compared), compared
    assert run.attempted > 0 and run.failed == 0
    rec = run.record()
    assert rec["kind"] == cell.driver


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name):
    run, compared = control.controlled_run(small(name), 3, SECONDS, device="cpu")
    assert run.attempted > 0
    assert not correct(compared), compared


# -- faults planted in the timed path -----------------------------------------

def _faulty_backend(config, fault):
    be = program.backend(config)

    @dataclasses.dataclass(frozen=True)
    class Faulty(type(be)):
        def net_scores(self, images, p):
            out = super().net_scores(images, p).clone()
            if fault == "answer":                 # one answer altered where it is made
                out[0, 0] += 1 if out.dtype == torch.int32 else 1e-3
            else:                                 # half of the batch left out
                out[0::2] = 0
            return out

    return dataclasses.replace(Faulty(), **{f.name: getattr(be, f.name)
                                            for f in dataclasses.fields(be)})


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_a_broken_served_step_is_not_correct(fault):
    cell = small("q16-fleet-tail")
    run = harness.load_driver("fleet").Run(cell, 21, SECONDS, device="cpu",
                                           backend=_faulty_backend(cell.config, fault))
    assert not correct(judged(run))


@pytest.mark.parametrize("fault", ["window_score", "detection"])
def test_a_broken_sweep_is_not_correct(fault):
    cell = small("plan-sweep-112")
    driver = harness.load_driver("sweep")
    run = driver.Run(cell, 22, SECONDS, device="cpu")
    run.setup()
    sweep = run.sweep
    if fault == "window_score":
        score = sweep.score

        def altered(params, frames, **kw):
            s = np.array(score(params, frames, **kw))
            s[len(s) // 2, 3] += 1 if s.dtype.kind == "i" else 1e-3
            return s
        object.__setattr__(sweep, "score", altered)
    else:
        aggregate = sweep.aggregate
        object.__setattr__(sweep, "aggregate",
                           lambda *a, **kw: aggregate(*a, **kw)[1:])   # one detection lost
    run.window()
    run.release()
    assert not correct(run.check())


# -- on the card ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
def test_one_short_run_on_the_card(card, name):
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed", "5",
                        "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["kind"] == card

