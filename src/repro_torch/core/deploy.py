"""The paper's end-to-end flow: train float -> extract -> quantize -> bake -> serve.

Port of `repro.core.deploy`, on the card unless the caller passes
`device="cpu"`.

Training is `loss.backward()` over `smallnet.loss_fn`, which runs the `ref`
backend's plain PyTorch ops, then `optim.adam_update`.  That is the
reference's own step, not a fallback: its `jax.value_and_grad` runs over
plain XLA ops and reaches no Pallas kernel, and no kernel of either package
has a backward pass, so there is no backward kernel to port.

`evaluate_all_paths` scores the reference's four paths through the kernel
backends: `float32` on `cuda` and `float32_plan_sigmoid` on `cuda_plan`
(one `float_smallnet` launch a batch), `fixed_q16_16` on `fixed_cuda` (one
`fixed_smallnet` launch), `int8_ptq` on `int8` (one `quant_matmul` launch).
On CPU tensors the same backends run their kernels' plain versions.

`bake` mirrors "weights ... hardcoded into the hardware": the reference
closes over the params as `jax.jit` constants; here the params are put on
the device once and closed over, so a call uploads no weights.  Pass them
in the backend's native form (`smallnet.quantize_params_fixed`,
`quantize_params_int8`), as `evaluate_all_paths` does, and `apply` finds
them ready and does no work on them per call.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch.core import backends as B
from repro_torch.core import smallnet
from repro_torch.core.device import as_device_tensor, resolve_device
from repro_torch.data import synth_mnist
from repro_torch.optim import AdamConfig, adam_init, adam_update


@dataclasses.dataclass
class TrainResult:
    params: dict
    history: list
    train_acc: float
    test_acc: float


def _value_and_grad(params: dict, xb: torch.Tensor, yb: torch.Tensor):
    """(loss, grads) of `smallnet.loss_fn` at `params` by autograd."""
    leaves = B.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = smallnet.loss_fn(leaves, xb, yb)
    loss.backward()
    return loss.detach(), B.tree_map(lambda p: p.grad, leaves)


def train_smallnet(n_train: int = 8000, n_test: int = 2000, epochs: int = 8,
                   batch_size: int = 64, lr: float = 2e-2, seed: int = 0, *,
                   device: torch.device | str | None = None) -> TrainResult:
    """Paper §III-A: Adam, batch 64, 8 epochs, at the reference's lr of 2e-2
    (the 510-parameter net's features move glacially at small steps; see
    `smallnet.loss_fn`).  The init is drawn from `torch.Generator` seeded
    with `seed`; the data and the batch order are the reference's
    (`synth_mnist`, numpy).  Train and test accuracy are scored on `cuda`,
    the float kernel backend of the reference's `smallnet.forward`."""
    dev = resolve_device(device)
    xtr, ytr = synth_mnist.make_dataset(n_train, seed=seed)
    xte, yte = synth_mnist.make_dataset(n_test, seed=seed + 1)
    params = smallnet.init_params(torch.Generator().manual_seed(seed), device=dev)
    cfg = AdamConfig(lr=lr, clip_norm=None)
    state = adam_init(params, cfg)
    losses = []
    for xb, yb in synth_mnist.batches(xtr, ytr, batch_size, seed=seed, epochs=epochs):
        loss, grads = _value_and_grad(params, torch.from_numpy(xb).to(dev),
                                      torch.from_numpy(yb).to(dev))
        params, state, _ = adam_update(grads, state, params, cfg)
        losses.append(loss)
    history = torch.stack(losses).tolist() if losses else []
    fwd = functools.partial(smallnet.apply, backend="cuda")
    with torch.inference_mode():
        train_acc = smallnet.accuracy(fwd, params, torch.from_numpy(xtr).to(dev), ytr)
        test_acc = smallnet.accuracy(fwd, params, torch.from_numpy(xte).to(dev), yte)
    return TrainResult(params, history, train_acc, test_acc)


def bake(apply_fn: Callable, params: Any, *,
         device: torch.device | str | None = None) -> Callable:
    """`apply_fn(params, x)` with `params` put on `device` once and closed
    over (paper: weights hardcoded into the fabric)."""
    dev = resolve_device(device)
    baked = B.tree_map(lambda leaf: as_device_tensor(leaf, dev), params)
    return lambda x: apply_fn(baked, as_device_tensor(x, dev, dtype=torch.float32))


def evaluate_all_paths(params: dict, n_test: int = 2000, seed: int = 1, *,
                       device: torch.device | str | None = None) -> dict:
    """The paper's accuracy table: float vs PLAN sigmoid vs Q16.16 fixed point
    vs int8, on the same test set, each through its kernel backend."""
    dev = resolve_device(device)
    xte, yte = synth_mnist.make_dataset(n_test, seed=seed)
    xte = torch.from_numpy(xte).to(dev)
    params = B.tree_map(lambda leaf: as_device_tensor(leaf, dev), params)
    paths = {
        "float32": (params, "cuda"),
        "float32_plan_sigmoid": (params, "cuda_plan"),
        "fixed_q16_16": (smallnet.quantize_params_fixed(params), "fixed_cuda"),
        "int8_ptq": (smallnet.quantize_params_int8(params), "int8"),
    }
    with torch.inference_mode():
        return {name: smallnet.accuracy(functools.partial(smallnet.apply, backend=be),
                                        p, xte, yte)
                for name, (p, be) in paths.items()}


def measure_latency(apply_fn: Callable, params: Any, batch: int = 1,
                    iters: int = 50, *,
                    device: torch.device | str | None = None) -> float:
    """Wall seconds per call of `apply_fn(params, x)` on a zero batch of
    `batch` images, each call waited for (the reference's
    `block_until_ready`): the card is synchronized before the timed loop
    and after every call in it."""
    dev = resolve_device(device)
    x = torch.zeros((batch, 28, 28, 1), dtype=torch.float32, device=dev)

    def call():
        out = apply_fn(params, x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    with torch.inference_mode():
        call()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return (time.perf_counter() - t0) / iters
