"""Model facade: config -> callables + abstract input specs for every shape.

Port of `repro.models.model`.  "Abstract" here means meta tensors: shapes
and dtypes with no memory (the reference's ShapeDtypeStructs).
`abstract_params` and `param_axes` run the port's init on the meta device.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer


class Model(NamedTuple):
    cfg: ArchConfig
    init: Any           # (generator, device=) -> (params, axes)
    forward: Any        # (params, batch) -> (logits, aux)
    loss: Any           # (params, batch) -> (loss, metrics)
    prefill: Any        # (params, batch) -> (last_logits, cache)
    decode_step: Any    # (params, cache, token, pos) -> (logits, cache)


def build(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg),
        forward=functools.partial(transformer.forward, cfg),
        loss=functools.partial(transformer.loss_fn, cfg),
        prefill=functools.partial(transformer.prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
    )


def abstract_params(cfg: ArchConfig):
    """(params, axes): params as meta tensors — no allocation."""
    return transformer.init_params(cfg, device="meta")


def param_axes(cfg: ArchConfig):
    """Logical-axes tree without allocating parameters."""
    return abstract_params(cfg)[1]


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                batch_override: int | None = None) -> dict:
    """Meta-tensor stand-ins for every model input of a given shape cell.
    Modality frontends are stubs: frames/vision arrive as precomputed
    embeddings."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    meta = lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": meta((B, S), i32)}
    elif shape.kind == "decode":
        return {"token": meta((B, 1), i32), "pos": meta((), i32),
                "cache": transformer.init_cache_shape(cfg, B, S)}
    else:
        raise ValueError(shape.kind)
    if cfg.family == "audio":
        specs["frames"] = meta((B, cfg.encoder_frames, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        specs["vision"] = meta((B, cfg.vision_tokens, cfg.vit_dim), cfg.dtype)
    return specs


def synth_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                batch_override: int | None = None, *, device=None) -> dict:
    """A concrete deterministic synthetic batch matching input_specs, drawn
    from a `torch.Generator` seeded `seed` (not the reference's draw):
    tokens and labels in [0, vocab), other integers in [0, 2^30), floats
    normal * 0.1; a decode batch's pos is seq_len // 2."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def gen_leaf(name, s):
        if not s.dtype.is_floating_point:
            hi = cfg.vocab if "token" in name or "label" in name else 2 ** 30
            return torch.randint(0, hi, s.shape, generator=gen, device=dev, dtype=s.dtype)
        return (torch.randn(s.shape, generator=gen, device=dev) * 0.1).to(s.dtype)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, f"{name}['{k}']") for k, v in tree.items()}
        return gen_leaf(name, tree)

    out = walk(input_specs(cfg, shape, batch_override), "")
    if shape.kind == "decode":
        out["pos"] = torch.tensor(shape.seq_len // 2, dtype=torch.int32, device=dev)
    return out
