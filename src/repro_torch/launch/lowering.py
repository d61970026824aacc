"""Cell lowering on the meta device: (arch x shape x mesh) -> the step's
abstract arguments and outputs, each leaf with its PartitionSpec, the
bytes a device holds for them, the step's FLOPs and its collective bytes.

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
its shape and spec.

Of the reference's compiler keys the port now has two, each from the
cell's own step rather than from XLA's program:

  * `cost.flops` (`cell_report(art, count=True)`, `count_flops`): the
    step's FLOPs counted by `torch.utils.flop_counter.FlopCounterMode` on
    the meta device, over the devices;
  * the collective bytes the reference parsed from its partitioned HLO
    (`collective_bytes`): by kind, from the shapes and specs alone, under
    the policy of `distributed/sharding.py`.

`cost`'s "bytes accessed" stays out (the reference itself calls XLA's
byte counter double-counting and uses `analysis/roofline.analytic_bytes`),
and so do `temp_bytes_per_device` and `peak_estimate_per_device`: they
need a compiler's schedule.  Never sets a device or an environment
variable.
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
from repro_torch.runtime.steps import make_decode_step, make_prefill_step, make_train_step

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
    axes: Any                                # the params' logical axes
    cfg: ArchConfig
    spec: ShapeSpec
    int8_serving: bool = False


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


def lower_cell(arch: str, shape_name: str | ShapeSpec, mesh, *,
               cfg_override: ArchConfig | None = None,
               int8_serving: bool = False) -> CellArtifacts:
    """`shape_name` names an entry of `SHAPES`, or is a `ShapeSpec` of its
    own (a shape no sweep runs, as `chip_smoke.py`'s)."""
    cfg = cfg_override or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    shape_name = shape.name
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
                        rules=rules, args=args, outs=outs, donated=donated, axes=axes,
                        cfg=cfg, spec=shape, int8_serving=int8_serving)
    for tree, specs in args + outs:                 # every leaf has a spec that fits
        for t, s in _pairs(tree, specs):
            shard_bytes(t, s, art.mesh_shape)
    return art


def cell_report(art: CellArtifacts, count: bool = False) -> dict:
    """JSON-serializable summary of one lowered cell; with `count`, also
    the reference's `cost` block's FLOPs a device (`count_flops`)."""
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
    if count:
        out["cost"] = {"flops": count_flops(art)}
    return out


# ---------------------------------------------------------------------------
# FLOPs: the cell's own step under FlopCounterMode on the meta device
# ---------------------------------------------------------------------------

def run_step(cfg: ArchConfig, shape: ShapeSpec, params, batch):
    """The cell's step on `params` and `batch` (laid out as
    `models.model.input_specs`), on whatever device they lie: train,
    `runtime.steps.make_train_step` with fresh Adam state (moments in
    `cfg.param_dtype`, as `lower_cell`'s); prefill, `make_prefill_step`;
    decode, `make_decode_step` at pos = seq_len // 2 as a Python int (as
    `models.model.synth_batch` sets it; `int(pos)` cannot read a meta
    scalar, and the step attends over all T slots whatever pos is)."""
    model = M.build(cfg)
    if shape.kind == "train":
        ocfg = AdamConfig(moment_dtype=cfg.param_dtype)
        return make_train_step(model, ocfg)(params, adam_init(params, ocfg), batch)
    with torch.no_grad():
        if shape.kind == "prefill":
            return make_prefill_step(model)(params, batch)
        return make_decode_step(model)(params, batch["cache"], batch["token"],
                                       shape.seq_len // 2)


def _meta_flops(cfg: ArchConfig, shape: ShapeSpec, int8_serving: bool) -> int:
    """FlopCounterMode's count of one whole step on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    params, _ = M.abstract_params(cfg)
    if int8_serving:
        params = ptq.abstract_quantize_tree(params)
    with FlopCounterMode(display=False) as counter:
        run_step(cfg, shape, params, M.input_specs(cfg, shape))
    return counter.get_total_flops()


def _depths(cfg: ArchConfig) -> dict[str, tuple[int, int]]:
    """Each config field that sets a stack's depth -> (the field's value
    for one block, the number of blocks): a jamba block is `attn_period`
    sublayers; whisper stacks encoder and decoder blocks."""
    if cfg.family == "hybrid":
        return {"n_layers": (cfg.attn_period, cfg.n_layers // cfg.attn_period)}
    out = {"n_layers": (1, cfg.n_layers)}
    if cfg.family == "audio":
        out["encoder_layers"] = (1, cfg.encoder_layers)
    return out


def step_flops(cfg: ArchConfig, shape: ShapeSpec, *, int8_serving: bool = False) -> int:
    """The FLOPs of one whole step of the cell, counted by FlopCounterMode
    on the meta device (products: mm, bmm, the einsums' bmm; forward,
    backward and remat's recompute as the step runs them), with the
    port's counterpart of `hlo_parse`'s trip-count multipliers, since a
    whole count of the largest cells takes minutes:

      * depth: every block of a stack does the same products and nothing
        else depends on the depth, so the step is counted with one block
        and with two of each stack, and each stack's second block's count
        is multiplied by its number of blocks past the first;
      * micro-batches: a train step runs `n_micro` equal micro-batches,
        then Adam, which does no product; one micro-batch is counted and
        multiplied.

    `tests/test_torch_roofline.py` holds this equal to the whole count of
    every family and step kind."""
    n_micro = max(1, shape.global_batch // max(1, cfg.micro_batch)) \
        if shape.kind == "train" else 1
    unit = dataclasses.replace(shape, global_batch=shape.global_batch // n_micro)
    depths = _depths(cfg)
    one = {f: d for f, (d, _) in depths.items()}
    base = _meta_flops(dataclasses.replace(cfg, **one), unit, int8_serving)
    total = base
    for field, (d, blocks) in depths.items():
        if blocks > 1:
            two = _meta_flops(dataclasses.replace(cfg, **{**one, field: 2 * d}), unit,
                              int8_serving)
            total += (blocks - 1) * (two - base)
    return n_micro * total


def count_flops(art: CellArtifacts) -> float:
    """The FLOPs of the cell's step a device: `step_flops` over
    `art.n_devices` (the reference's `cost_analysis()["flops"]`, but
    counted, loops and all)."""
    return step_flops(art.cfg, art.spec, int8_serving=art.int8_serving) / art.n_devices


# ---------------------------------------------------------------------------
# collective bytes: from shapes and specs alone
# ---------------------------------------------------------------------------

# leaves of two or more dims that no product contracts: the decode state's
# taps, the decays, token-shift mixes and the learned position tables
_NOT_PRODUCTS = frozenset({"conv_w", "A_log", "mu", "mu_c", "u", "enc_pos", "dec_pos"})
# leaves a decode step does not read: the encoder and its cross K/V are in
# the cache, the vision tokens in the prompt
_NOT_IN_DECODE = frozenset({"enc_blocks", "enc_pos", "enc_final_norm", "vision_proj"})


def _param_leaves(tree, axes, specs, path=()):
    """(path, leaf, logical axes, spec) of every params leaf."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _param_leaves(tree[k], axes[k], specs[k], path + (k,))
    elif isinstance(tree, ptq.QuantTensor):
        yield from _param_leaves(tree.q, axes.q, specs.q, path + ("q",))
        yield from _param_leaves(tree.scale, axes.scale, specs.scale, path + ("scale",))
    else:
        yield path, tree, axes, specs


def _ways(entry, mesh_shape) -> int:
    return math.prod(mesh_shape[a] for a in shd.entry_axes(entry))


def _cross_kv(path) -> bool:
    """Whisper's cross-attention K/V projections, which read the encoder."""
    return path[1:2] == ("cross",) and path[2] in ("wk", "wv")


def _stream_tokens(path, cfg: ArchConfig, shape: ShapeSpec, b_local: int) -> int:
    """The tokens a device feeds through a product weight at `path` in one
    use: the decoder's positions (one in decode), the encoder's frames
    (whisper's encoder and its cross K/V), the vision tokens, or the
    positions the logits are taken at (the last one but in training)."""
    seq = 1 if shape.kind == "decode" else shape.seq_len
    if path[0] == "enc_blocks" or _cross_kv(path):
        return b_local * cfg.encoder_frames
    if path[0] == "vision_proj":
        return b_local * cfg.vision_tokens
    if path[0] == "lm_head":
        return b_local * (shape.seq_len if shape.kind == "train" else 1)
    return b_local * seq


def collective_bytes(art: CellArtifacts) -> dict[str, float]:
    """The bytes a device sends in one step, by kind ("all-gather",
    "reduce-scatter", "all-reduce"), from the cell's shapes and specs
    alone, under the policy of `distributed/sharding.py`:

      * each weight split over the data axes ("fsdp" -> data, pod) is
        all-gathered over them where it is used: once a step for prefill
        and decode, twice a micro-batch for train (forward, and again in
        the backward pass, where remat recomputes the block);
      * a train step reduce-scatters each such weight's gradient over the
        same axes, once a micro-batch; the gradient of a weight those axes
        do not split is all-reduced over the batch's axes instead (data
        parallelism), once a micro-batch;
      * a product whose contracted dim is split over "model" all-reduces
        its output over "model": in the forward pass, a weight whose input
        dim is (attention and MLP outputs, mamba's x_proj and out_proj,
        the embedding's lookup over a split vocab), recomputed under remat
        inside a block; in a train step's backward pass, the input
        gradient of a weight whose output dim is (the column-parallel
        projections, the tied embedding's logits).

    Each collective is counted at ring cost: an all-gather or
    reduce-scatter of b bytes over n devices sends b (n - 1) / n, an
    all-reduce twice that.  A weight's bytes are its stored dtype's, an
    activation's the compute dtype's.  Not counted: the all-to-all an
    expert-parallel MoE dispatch would need (the port's MoE einsums are
    not split over experts by any product above), and the sequence
    parallelism of "res_seq" (the port's models carry no activation
    constraints)."""
    cfg, shape, ms = art.cfg, art.spec, art.mesh_shape
    rules = art.rules
    params, pspecs = art.args[0]
    data_axes = set(shd.entry_axes(rules["fsdp"]))
    batch_ways = _ways(rules["batch"], ms)
    train = shape.kind == "train"
    n_micro = max(1, shape.global_batch // max(1, cfg.micro_batch)) if train else 1
    b_local = -(-(shape.global_batch // n_micro) // batch_ways)
    act = torch.empty((), dtype=cfg.dtype).element_size()
    n_model = ms.get("model", 1)
    ring = lambda b, n: b * (n - 1) / n                     # noqa: E731
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for path, leaf, ax, spec in _param_leaves(params, art.axes, pspecs):
        if shape.kind == "decode" and (path[0] in _NOT_IN_DECODE or _cross_kv(path)):
            continue
        entries = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        n_data = math.prod(ms[a] for e in entries for a in shd.entry_axes(e) if a in data_axes)
        # the weight as a device holds it once gathered over the data axes
        held = _without_axes(entries, data_axes)
        full = shard_bytes(leaf, held, ms)
        if n_data > 1:
            out["all-gather"] += ring(full, n_data) * (2 * n_micro if train else 1)
            if train:
                out["reduce-scatter"] += ring(full, n_data) * n_micro
        elif train and batch_ways > 1:
            out["all-reduce"] += 2 * ring(full, batch_ways) * n_micro
        lead = sum(1 for a in ax if a == "layers")
        if leaf.ndim - lead < 2 or path[-1] in _NOT_PRODUCTS or path[-1] == "scale":
            continue
        # a product weight (..., d_in, d_out); the embedding's lookup
        # contracts its vocab (dim 0) into d
        uses = math.prod(leaf.shape[:lead])
        tokens = _stream_tokens(path, cfg, shape, b_local)
        dim_in = -(-leaf.shape[-2] // _ways(held[-2], ms))
        dim_out = -(-leaf.shape[-1] // _ways(held[-1], ms))
        model_in = "model" in shd.entry_axes(entries[-2])
        if model_in:
            fwd = 1 + (train and cfg.remat and path[0] in ("blocks", "enc_blocks"))
            out["all-reduce"] += 2 * ring(tokens * dim_out * act, n_model) * uses * fwd * n_micro
        if "model" in shd.entry_axes(entries[-1]) and train:
            out["all-reduce"] += 2 * ring(tokens * dim_in * act, n_model) * uses * n_micro
        if path[0] == "embed" and model_in and train and cfg.tie_embeddings:
            # the tied logits' product contracts d into the split vocab
            logits = b_local * shape.seq_len
            out["all-reduce"] += 2 * ring(logits * dim_out * act, n_model) * n_micro
    return out


def _without_axes(entries, drop: set[str]) -> shd.PartitionSpec:
    """A spec with the mesh axes in `drop` taken out of every entry."""
    return shd.P(*[tuple(a for a in shd.entry_axes(e) if a not in drop) for e in entries])
