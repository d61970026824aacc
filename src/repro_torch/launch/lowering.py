"""Cell lowering on the meta device: (arch x shape x mesh) -> the step's
abstract arguments and outputs, each leaf with its PartitionSpec, and the
bytes a device holds for them.

Port of `repro.launch.lowering`.  The reference jits the step with
in/out shardings and compiles it through XLA; the port has no
partitioning compiler, so `lower_cell` stops at what shapes and specs
decide: the params from `models.model.abstract_params` (meta tensors,
nothing allocated; int8 serving through `ptq.quantize_axes` and
`ptq.abstract_quantize_tree`), the optimizer state, the batch and decode
cache from `models.model.input_specs`, the outputs (train: params, state
and two float32 metrics; prefill: last-position logits and the cache;
decode: logits and the cache), and a spec for every leaf under the cell's
rules (`rules_for`).  A spec naming an axis the mesh lacks, an axis twice,
or more dims than its leaf has fails the cell.

`cell_report` keeps the reference's keys that shapes alone decide.  A
leaf's bytes on a device are its dims, each divided by the product of the
mesh axes its spec entry names and rounded up (an uneven dim is padded to
the ceiling, as XLA pads it), times its element size.  Arguments count
every input leaf; outputs every output leaf plus, as XLA's
`memory_analysis` counts them, the output tuple's table of one 8-byte
pointer a leaf; aliases the donated inputs (params and optimizer state of
a train step, the decode cache), each rewritten in place by the output of
its shape and spec.  `temp_bytes_per_device`, `peak_estimate_per_device`
and the `cost` block (FLOPs, bytes accessed) need a compiler's schedule
and are left out.  Never sets a device or an environment variable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec, get_config
from repro_torch.core import ptq
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.optim import AdamConfig, AdamState, adam_init

TUPLE_POINTER_BYTES = 8


def rules_for(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    return shd.make_rules(
        mesh_axes=tuple(mesh.axis_names), global_batch=shape.global_batch,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        decode=(shape.kind == "decode"), seq_len=shape.seq_len,
        family=cfg.family)


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """PartitionSpecs for the input batch (under an active rules context)."""
    sp = lambda *names: shd.logical_spec(*names)            # noqa: E731
    if shape.kind == "decode":
        return {"token": sp("batch", None), "pos": sp(), "cache": cache_pspecs(cfg)}
    specs = {"tokens": sp("batch", None)}
    if shape.kind == "train":
        specs["labels"] = sp("batch", None)
    if cfg.family == "audio":
        specs["frames"] = sp("batch", None, None)
    if cfg.family == "vlm":
        specs["vision"] = sp("batch", None, None)
    return specs


def cache_pspecs(cfg: ArchConfig):
    """Decode-cache PartitionSpecs (structure matches init_cache_shape)."""
    sp = shd.logical_spec
    fam = cfg.family
    kv_k = sp(None, "cache_batch", "cache_seq", None, None)
    if fam in ("dense", "moe", "vlm"):
        return {"k": kv_k, "v": kv_k}
    if fam == "ssm":
        return {"wkv": sp(None, "cache_batch", None, "cache_head_dim", None),
                "x_tm": sp(None, "cache_batch", None),
                "x_cm": sp(None, "cache_batch", None)}
    if fam == "hybrid":
        return {"k": kv_k, "v": kv_k,
                "mamba_conv": sp(None, None, "cache_batch", None, "ffn"),
                "mamba_ssm": sp(None, None, "cache_batch", "ffn", None)}
    if fam == "audio":
        # cross-attention cache has frames=1500 (not 16-divisible): hd-shard
        cross = sp(None, "cache_batch", None, None, "cache_head_dim")
        return {"k": kv_k, "v": kv_k, "cross_k": cross, "cross_v": cross}
    raise ValueError(fam)


def opt_pspecs(param_specs):
    return AdamState(step=shd.P(), mu=param_specs, nu=param_specs)


@dataclasses.dataclass
class CellArtifacts:
    """A lowered cell: the step's argument and output trees (meta tensors)
    beside their spec trees, and which arguments are donated."""
    arch: str
    shape: str
    mesh_kind: str
    n_devices: int
    mesh_shape: dict[str, int]
    rules: dict
    args: tuple[tuple[Any, Any], ...]        # (tree, spec tree) per argument
    outs: tuple[tuple[Any, Any], ...]        # (tree, spec tree) per output
    donated: tuple[int, ...]                 # indices into args


def _pairs(tree: Any, specs: Any):
    """(leaf, spec) for every tensor leaf of `tree`, matched by structure."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        if set(tree) != set(specs):
            raise ValueError(f"spec keys {sorted(specs)} != {sorted(tree)}")
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, ptq.QuantTensor):
        yield from _pairs(tree.q, specs.q)
        yield from _pairs(tree.scale, specs.scale)
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs, strict=True):
            yield from _pairs(t, s)
    else:
        raise TypeError(f"no tensor at a leaf: {type(tree).__name__}")


def shard_bytes(leaf: torch.Tensor, spec, mesh_shape: dict[str, int]) -> int:
    """The bytes one device holds of `leaf` laid out by `spec`."""
    if len(spec) > leaf.ndim:
        raise ValueError(f"spec {spec} has more entries than {tuple(leaf.shape)} has dims")
    n = leaf.element_size()
    seen: set[str] = set()
    for d, entry in zip(leaf.shape, tuple(spec) + (None,) * (leaf.ndim - len(spec))):
        ways = 1
        for a in shd.entry_axes(entry):
            if a not in mesh_shape or a in seen:
                raise ValueError(f"spec {spec}: mesh axis {a!r} missing or named twice "
                                 f"(mesh {mesh_shape})")
            seen.add(a)
            ways *= mesh_shape[a]
        n *= -(-d // ways)
    return n


def _bytes(trees, mesh_shape) -> tuple[int, int]:
    """(bytes per device, leaves) of (tree, specs) pairs."""
    pairs = [p for tree, specs in trees for p in _pairs(tree, specs)]
    return sum(shard_bytes(t, s, mesh_shape) for t, s in pairs), len(pairs)


def lower_cell(arch: str, shape_name: str, mesh, *,
               cfg_override: ArchConfig | None = None,
               int8_serving: bool = False) -> CellArtifacts:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    rules = rules_for(cfg, shape, mesh)
    params_abs, axes = M.abstract_params(cfg)
    if int8_serving:
        # the paper's baked-quantized deployment: int8 weights + f32 scales
        # (serving shapes only; training keeps float master weights)
        if shape.kind not in ("decode", "prefill"):
            raise ValueError("int8_serving is a serving mode")
        axes = ptq.quantize_axes(params_abs, axes)
        params_abs = ptq.abstract_quantize_tree(params_abs)

    with shd.sharding_rules(rules):
        pspecs = shd.specs_from_axes(axes)
        bspecs = batch_pspecs(cfg, shape)
        cspecs = cache_pspecs(cfg)
        inputs = M.input_specs(cfg, shape)
        logits_spec = shd.logical_spec("batch", "vocab")
    B = shape.global_batch
    logits = torch.empty((B, cfg.vocab_padded), dtype=torch.float32, device="meta")
    if shape.kind == "train":
        opt_abs = adam_init(params_abs, AdamConfig(moment_dtype=cfg.param_dtype))
        ospecs = opt_pspecs(pspecs)
        metric = torch.empty((), dtype=torch.float32, device="meta")
        args = ((params_abs, pspecs), (opt_abs, ospecs), (inputs, bspecs))
        outs = ((params_abs, pspecs), (opt_abs, ospecs),
                ({"loss": metric, "grad_norm": metric},
                 {"loss": shd.P(), "grad_norm": shd.P()}))
        donated = (0, 1)
    elif shape.kind == "prefill":
        cache = transformer.init_cache_shape(cfg, B, shape.seq_len)
        args = ((params_abs, pspecs), (inputs, bspecs))
        outs = ((logits, logits_spec), (cache, cspecs))
        donated = ()
    else:  # decode
        args = ((params_abs, pspecs), (inputs["cache"], bspecs["cache"]),
                (inputs["token"], bspecs["token"]), (inputs["pos"], bspecs["pos"]))
        outs = ((logits, logits_spec), (inputs["cache"], bspecs["cache"]))
        donated = (1,)
    art = CellArtifacts(arch, shape_name,
                        mesh_kind="multi_pod" if "pod" in mesh.axis_names else "single_pod",
                        n_devices=math.prod(mesh.shape.values()), mesh_shape=dict(mesh.shape),
                        rules=rules, args=args, outs=outs, donated=donated)
    for tree, specs in args + outs:                 # every leaf has a spec that fits
        for t, s in _pairs(tree, specs):
            shard_bytes(t, s, art.mesh_shape)
    return art


def cell_report(art: CellArtifacts) -> dict:
    """JSON-serializable summary of one lowered cell (no compiler's keys)."""
    out = {"arch": art.arch, "shape": art.shape, "mesh": art.mesh_kind,
           "devices": art.n_devices, "ok": True}
    arg_bytes, _ = _bytes(art.args, art.mesh_shape)
    out_bytes, out_leaves = _bytes(art.outs, art.mesh_shape)
    alias_bytes, _ = _bytes([art.args[i] for i in art.donated], art.mesh_shape)
    out["memory"] = {
        "argument_bytes_per_device": arg_bytes,
        "output_bytes_per_device": out_bytes + TUPLE_POINTER_BYTES * out_leaves,
        "alias_bytes_per_device": alias_bytes,
    }
    return out
