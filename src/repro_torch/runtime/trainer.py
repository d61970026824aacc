"""Trainer: the composable train loop behind `launch/train.py`.

Port of `repro.runtime.trainer`: the model facade, the micro-batched train
step, deterministic host-indexed data, async checkpoints and the fault
hooks (watchdog, straggler stats, resume from the latest checkpoint).
The port cannot reproduce `jax.random`: without `params=` it draws its own
from a `torch.Generator` seeded `tcfg.seed`; `params=` hands in a tree
(the reference's, carried by `core/convert.lm_params_from_jax`), which is
copied before training updates it in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.backends import tree_map
from repro_torch.core.device import resolve_device
from repro_torch.data import lm_data
from repro_torch.models import model as M
from repro_torch.optim import AdamConfig, adam_init, cosine_schedule
from repro_torch.runtime import fault
from repro_torch.runtime.steps import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    lr: float = 3e-4
    warmup_steps: int = 20
    ckpt_dir: str | None = None
    ckpt_every: int = 25
    log_every: int = 10
    seed: int = 0
    step_timeout_s: float = 0.0        # 0 = watchdog off


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, *,
                 device: torch.device | str | None = None, params=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.model = M.build(cfg)
        self.ocfg = AdamConfig(lr=tcfg.lr, moment_dtype=cfg.param_dtype)
        self.lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
        self.step_fn = make_train_step(self.model, self.ocfg, self.lr_fn)
        self.data_cfg = lm_data.DataConfig(
            vocab=cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed)
        self.manager = CheckpointManager(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.stats = fault.StepStats()
        self.params = params

    def init_state(self) -> dict:
        if self.params is not None:
            params = tree_map(lambda t: t.to(self.device, copy=True), self.params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            params, _ = self.model.init(gen, device=self.device)
        return {"params": params, "opt": adam_init(params, self.ocfg)}

    def batch(self, step: int) -> dict:
        """The data of step `step` on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in lm_data.host_batch(self.data_cfg, step).items()}

    def train_step(self, state: dict, batch: dict) -> dict:
        """One step on `state` (updated in place); the metrics, the loss
        as a Python float."""
        state["params"], state["opt"], metrics = self.step_fn(
            state["params"], state["opt"], batch)
        metrics["loss"] = float(metrics["loss"])        # waits for the step
        return metrics

    def run(self, on_metrics: Callable[[int, dict], None] | None = None):
        """Restore the latest checkpoint (if any), train to `total_steps`,
        checkpoint every `ckpt_every` steps; returns (state, history), the
        history a list of the steps' losses as Python floats."""
        state, start = self.init_state(), 0
        if self.manager is not None:
            restored = self.manager.restore_latest(state)
            if restored is not None:
                state, start = restored
        history = []
        for step in range(start, self.tcfg.total_steps):
            batch = self.batch(step)
            t0 = time.perf_counter()
            if self.tcfg.step_timeout_s > 0:
                with fault.StepWatchdog(self.tcfg.step_timeout_s):
                    metrics = self.train_step(state, batch)
            else:
                metrics = self.train_step(state, batch)
            dt = time.perf_counter() - t0
            if self.stats.record(dt):
                metrics["straggler"] = True
            history.append(metrics["loss"])
            if on_metrics and step % self.tcfg.log_every == 0:
                on_metrics(step, {k: (float(v) if isinstance(v, torch.Tensor) else v)
                                  for k, v in metrics.items()})
            if self.manager is not None and (step + 1) % self.tcfg.ckpt_every == 0:
                self.manager.save_async(step + 1, state)
        if self.manager is not None:
            self.manager.wait()
        return state, history
