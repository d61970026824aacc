"""Step functions: the micro-batched train step, prefill, decode.

Port of `repro.runtime.steps`.  The train step splits the batch into
`n_micro = max(1, B // cfg.micro_batch)` contiguous micro-batches (the
reference's reshape), takes each one's loss and gradients by autograd,
accumulates the gradients in `cfg.param_dtype` (float32 for the <=100B
configs, bfloat16 for the giants), divides by `n_micro`, and applies Adam
(`optim/adam.py`) at the schedule's lr for `opt_state.step`, inside a
`torch.profiler.record_function` range, `ADAM_RANGE`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.backends import tree_leaves, tree_map
from repro_torch.optim import AdamConfig, adam_update

# the profiler range around the optimizer update (the device time of a
# step's Adam is read under this name)
ADAM_RANGE = "train_step/adam"


def make_train_step(model, optim_cfg: AdamConfig,
                    lr_schedule: Callable | None = None) -> Callable:
    """`train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})`.  Params and moments are updated in place
    (`adam_update(donate=True)`), as the reference's jitted step donates
    them: the trees passed in are the trees returned."""
    cfg = model.cfg

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        n_micro = max(1, B // max(1, cfg.micro_batch))
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} micro-batches")
        m = B // n_micro
        acc_dtype = cfg.param_dtype
        leaves = tree_leaves(params)
        gsum = None
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n_micro):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            req = [p.detach().requires_grad_() for p in leaves]
            it = iter(req)
            loss, _ = model.loss(tree_map(lambda _: next(it), params), micro)
            grads = torch.autograd.grad(loss, req)
            if gsum is None:            # 0 + g, without a zeroed copy of the params
                gsum = [g.to(acc_dtype) for g in grads]
            else:
                gsum = [a + g.to(acc_dtype) for a, g in zip(gsum, grads)]
            lsum = lsum + loss.detach()
            del loss, grads, req
        if n_micro > 1:
            gsum = [g / n_micro for g in gsum]
        it = iter(gsum)
        grads = tree_map(lambda _: next(it), params)
        lr = lr_schedule(opt_state.step) if lr_schedule else None
        with torch.profiler.record_function(ADAM_RANGE):
            params, opt_state, om = adam_update(grads, opt_state, params, optim_cfg, lr,
                                                donate=True)
        return params, opt_state, {"loss": lsum / n_micro, **om}

    return train_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)
    return decode_step
