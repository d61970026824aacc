"""Fault tolerance and straggler mitigation for the training runtime.

Port of `repro.runtime.fault` (pure Python, the port's own copy):

  * checkpoint/restart: `checkpoint/ckpt.py` (atomic, crc-checked) and
    `run_with_restarts`, which resumes from the latest checkpoint after any
    failure;
  * node-failure detection: `StepWatchdog` is the in-process stand-in for a
    scheduler's missing heartbeat, a step past `timeout_s` raises
    `StepTimeout` instead of hanging;
  * stragglers: deterministic host-indexed data (`data/lm_data.py`), so a
    replacement host recomputes exactly the shard it replaces, and
    `StepStats`, which flags a step slower than `slo_factor` x the median.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable


class StepTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class StepWatchdog:
    """SIGALRM-based step timeout; the previous handler and timer are
    restored on exit.  Main thread only (Python delivers signals there).

    Python handles the signal only when control returns to the
    interpreter: a step blocked in native code, such as a CUDA
    synchronisation, is interrupted after that call returns, not during it."""
    timeout_s: float = 300.0

    def __enter__(self):
        def _handler(signum, frame):
            raise StepTimeout(f"step exceeded {self.timeout_s}s")
        self._old = signal.signal(signal.SIGALRM, _handler)
        signal.setitimer(signal.ITIMER_REAL, self.timeout_s)
        return self

    def __exit__(self, *exc):
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, self._old)
        return False


@dataclasses.dataclass
class StepStats:
    """Step-time SLO tracker: flags stragglers as median outliers."""
    window: int = 50
    slo_factor: float = 2.0

    def __post_init__(self):
        self.times: list[float] = []

    def record(self, dt: float) -> bool:
        """True if this step is a straggler (> slo_factor x the window's median)."""
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) < 5:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        return dt > self.slo_factor * med


def run_with_restarts(make_state: Callable, train_one: Callable,
                      manager, total_steps: int, *,
                      max_restarts: int = 3, timeout_s: float = 300.0):
    """Crash-safe outer loop: restore the latest checkpoint -> step ->
    checkpoint; any exception (a watchdog timeout too) restarts from the
    last checkpoint, at most `max_restarts` times.  `make_state()` builds a
    fresh state, `train_one(state, step)` returns the next; returns
    (state, restarts)."""
    restarts = 0
    while True:
        restored = manager.restore_latest(make_state())
        state, start = restored if restored is not None else (make_state(), 0)
        step = start
        try:
            while step < total_steps:
                with StepWatchdog(timeout_s):
                    state = train_one(state, step)
                step += 1
                manager.save_async(step, state)
            manager.wait()
            return state, restarts
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            manager.wait()
