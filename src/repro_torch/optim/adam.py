"""Hand-rolled Adam/AdamW over the port's parameter trees.

Port of `repro.optim.adam`.  The update is the reference's arithmetic,
term for term, in float32 whatever the leaves' dtype: the clip scale folded
into the gradient, the moments, the bias corrections `1 - b ** step`
computed in float32, `eps` added after the square root of the corrected
second moment, the decoupled weight decay, then the step.  It does not wrap
`torch.optim.Adam`, whose bias correction and `eps` differ in placement.

Trees are the port's nests of dicts, lists and tuples of tensors, walked by
`core.backends.tree_map` / `tree_leaves`.  `moment_dtype` is a torch dtype
(bfloat16 moments halve the optimizer state); `layer_chunked` updates a
leaf of rank >= 3 one slice of its leading axis at a time, as the
reference's `lax.map` does, with the same results.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.backends import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    moment_dtype: torch.dtype = torch.float32
    # update rank >= 3 leaves slice by slice over the leading (layer) axis
    layer_chunked: bool = False


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Any
    nu: Any


def _leaves_like(tree: Any, like: Any) -> list:
    """The leaves of `tree` in the order `tree_leaves(like)` lists those of
    `like`, dict entries matched by key: two trees of one structure whose
    dicts were built in different orders still pair leaf with leaf (the
    reference's pytrees flatten dicts in key order)."""
    if isinstance(like, dict):
        return [leaf for k in like for leaf in _leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [leaf for t, lk in zip(tree, like, strict=True)
                for leaf in _leaves_like(t, lk)]
    return tree_leaves(tree)


def _unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped as `like` holding `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def adam_init(params: Any, cfg: AdamConfig = AdamConfig()) -> AdamState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)  # noqa: E731
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _sumsq(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares in float32; a layer-stacked leaf reduces slice by
    slice, as the reference's `fori_loop` does."""
    if g.dim() >= 3 and g.shape[0] > 1:
        acc = torch.zeros((), dtype=torch.float32, device=g.device)
        for i in range(g.shape[0]):
            acc = acc + torch.sum(torch.square(g[i].float()))
        return acc
    return torch.sum(torch.square(g.float()))


def _global_norm(leaves: list) -> torch.Tensor:
    return torch.sqrt(sum(_sumsq(g) for g in leaves))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (global norm + 1e-9));
    returns the scaled tree and the norm."""
    gn = _global_norm(tree_leaves(grads))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adam_update(grads: Any, state: AdamState, params: Any,
                cfg: AdamConfig = AdamConfig(),
                lr: torch.Tensor | float | None = None, *, donate: bool = False):
    """Returns (new_params, new_state, metrics).  No autograd: call it on
    gradients, outside the graph.  By default the update is functional,
    as the reference's: `params` and `state` are left as they were, which
    callers that update one tree twice rely on (`tests/test_torch_optim.py`
    holds the clip fold, layer chunking and key order so; done in place,
    those comparisons would hold one tensor against itself).  `donate`
    writes the new params and moments into the tensors passed in, leaf by
    leaf (the reference's jitted train step donates them), so the update
    holds one leaf's temporaries instead of a second copy of params and
    moments; `runtime/steps.make_train_step` uses it.  The same values
    either way."""
    flat_p = tree_leaves(params)
    flat_g = _leaves_like(grads, params)
    flat_m = _leaves_like(state.mu, params)
    flat_v = _leaves_like(state.nu, params)
    dev = flat_p[0].device
    if cfg.clip_norm is not None:
        # fold the clip scale into the update (no scaled copy of the grads)
        gnorm = _global_norm(flat_g)
        gscale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        gscale = torch.ones((), dtype=torch.float32, device=dev)
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), step_f)

    def upd(p, g, m, v):
        g32 = g.float() * gscale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p.float()
        newp = p.float() - lr_t * update
        return newp.to(p.dtype), m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype)

    def upd_into(p, g, m, v):
        out = upd(p, g, m, v)
        if not donate:
            return out
        for dst, src in zip((p, m, v), out):
            dst.copy_(src)
        return p, m, v

    def upd_leaf(p, g, m, v):
        if cfg.layer_chunked and p.dim() >= 3 and p.shape[0] > 1:
            parts = [upd_into(p[i], g[i], m[i], v[i]) for i in range(p.shape[0])]
            if donate:
                return p, m, v
            return tuple(torch.stack([part[k] for part in parts]) for k in range(3))
        return upd_into(p, g, m, v)

    with torch.no_grad():
        new = [upd_leaf(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = _unflatten(params, [t[0] for t in new])
    new_m = _unflatten(params, [t[1] for t in new])
    new_v = _unflatten(params, [t[2] for t in new])
    return new_p, AdamState(step, new_m, new_v), {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup_steps: int,
                    total_steps: int) -> Callable[[Any], torch.Tensor]:
    """Linear warmup to `base_lr` over `warmup_steps`, then a half cosine
    down to 0 at `total_steps`; float32, as the reference's."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1.0, float(warmup_steps))
        t = torch.clamp((step - warmup_steps) / max(1.0, float(total_steps - warmup_steps)),
                        0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
