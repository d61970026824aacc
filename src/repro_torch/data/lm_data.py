"""Deterministic, host-sharded synthetic token pipeline.

Port of `repro.data.lm_data` (numpy only, the port's own copy): batch
content is a pure function of (seed, step, host_index, n_hosts), so a
replacement host regenerates exactly the shard of the machine it replaces
and no data-server state exists to lose.  `host_batch` gives the
reference's bytes for equal arguments; the trainer moves them to its
device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0


def host_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """This host's slice of the global batch for `step`: int32 `tokens` and
    `labels` (the tokens shifted by one), order-1 markov-ish tokens so the
    LM loss is learnable, not uniform noise."""
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} does not split over "
                         f"{cfg.n_hosts} hosts")
    b = cfg.global_batch // cfg.n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
    # order-1 structure: next token = (prev * a + noise) % vocab
    a = 31
    x0 = rng.integers(0, cfg.vocab, size=(b, 1))
    noise = rng.integers(0, 17, size=(b, cfg.seq_len + 1))
    toks = np.empty((b, cfg.seq_len + 1), np.int64)
    toks[:, 0:1] = x0
    for t in range(1, cfg.seq_len + 1):
        toks[:, t] = (toks[:, t - 1] * a + noise[:, t]) % cfg.vocab
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield host_batch(cfg, step)
        step += 1
