"""Logical-axis sharding policy (MaxText-style rules -> PartitionSpecs).

Port of `repro.distributed.sharding`.  Model code names the axes of its
weights ("fsdp", "ffn", "heads", ...; `models.transformer.init_params`
returns them beside the params).  A `sharding_rules` context maps those
names to mesh axes; outside any rules context every mapping is empty, so
the same code runs on one device and on the (2,16,16) production mesh of
the dry run (`launch/lowering.py`).

A `PartitionSpec` here is a tuple, one entry a tensor dim: None
(replicated), a mesh-axis name, or a tuple of names (the dim split over
all of them, the first the major one).  `placements(spec, mesh)` turns it
into DTensor placements on a `DeviceMesh`, and `NamedSharding` pairs the
two, as `jax.sharding.NamedSharding` does (the checkpoint's elastic
restore takes a tree of them).

The models carry no activation `constrain` calls (`models/layers.py`):
they mean something only to a compiler that partitions the step, and the
port has none.  `constrain` itself is kept for tensors that do carry a
mesh (DTensors).

Baseline policy (DESIGN.md §5):
  * DP: "batch" -> ("pod","data") when the batch divides, else unsharded
  * TP: flattened projection outputs ("qkv", "ffn", "vocab", "experts") -> "model"
  * FSDP/ZeRO-3: every weight's d_model dim ("fsdp") -> "data" (+"pod")
  * GQA: "heads" -> "model" only when n_heads % model_size == 0;
         decode KV caches shard "head_dim" -> "model" (always divisible here)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping

import torch

from repro_torch.core.backends import tree_map

_state = threading.local()


class PartitionSpec(tuple):
    """One entry a tensor dim: None, a mesh-axis name, or a tuple of names;
    missing trailing entries are None.  Entries are normalized as JAX's
    are: a tuple of one name is that name, an empty one None."""

    def __new__(cls, *entries):
        def norm(e):
            if e is None or isinstance(e, str):
                return e
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _rules() -> Mapping[str, Any] | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Mapping[str, Any] | None):
    prev = _rules()
    _state.rules = dict(rules) if rules is not None else None
    try:
        yield
    finally:
        _state.rules = prev


def logical_spec(*names: str | None) -> PartitionSpec:
    rules = _rules() or {}
    return P(*[rules.get(n) for n in names])


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry splits its dim over (major first)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> list:
    """DTensor placements on `mesh` (a `DeviceMesh` with dim names) for
    `spec`: `Shard(d)` on every mesh dim that tensor dim d is split over,
    `Replicate()` on the others.  A dim split over several mesh dims (say
    ("pod","data")) takes `Shard(d)` on each, which DTensor applies in the
    mesh's order, so the spec must name them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A `DeviceMesh` and a spec over its dim names."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Lay `x` out by logical names; returns `x` itself without rules.

    Under rules a DTensor is redistributed onto the spec on its own mesh.
    A plain tensor is returned as it is: it lives on one device and has no
    mesh to be laid out on (the reference's `with_sharding_constraint` is a
    hint to a partitioning compiler, which the port has no counterpart
    of)."""
    if _rules() is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(logical_spec(*names), x.device_mesh))
    return x


def make_rules(*, mesh_axes: tuple[str, ...], global_batch: int,
               n_heads: int, n_kv_heads: int,
               decode: bool = False, seq_len: int = 0,
               family: str = "dense") -> dict[str, Any]:
    """Build the logical->physical mapping for one (arch, shape, mesh)."""
    has_pod = "pod" in mesh_axes
    data_axes = ("pod", "data") if has_pod else ("data",)
    # mesh sizes are fixed by make_production_mesh: pod=2, data=16, model=16
    data_size = 32 if has_pod else 16
    model_size = 16

    batch = data_axes if global_batch % data_size == 0 else (
        ("data",) if global_batch % 16 == 0 else None)
    heads = "model" if n_heads % model_size == 0 else None
    # sequence parallelism on the residual stream (train and prefill)
    res_seq = "model" if (not decode and seq_len % model_size == 0) else None
    rules = {
        # activations
        "batch": batch,
        "res_seq": res_seq,
        "seq": None,
        "embed": None,
        "heads": heads,
        "kv_heads": None,                       # kv_heads < 16 for all archs
        # context-parallel fallback when heads % 16 != 0 (qwen2.5's 40H,
        # whisper's 6H): K/V sharded over the sequence in the attention core
        "kv_seq": ("model" if heads is None and not decode
                   and seq_len % model_size == 0 else None),
        "head_dim": None,
        "qkv": "model",                         # flattened H*hd projections
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "expert_group": batch,
        "cache_batch": batch,
        "cache_head_dim": "model",              # decode state TP dim (ssm)
        # flash-decoding layout: the KV cache sharded over the sequence
        "cache_seq": ("model" if decode and seq_len % model_size == 0
                      else None),
        # weights: the ZeRO-3 dim of every weight, over the pod axis too on
        # the multi-pod mesh
        "fsdp": data_axes,
        "w_model": "model",
        "layers": None,
    }
    return rules


def vision_batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the vision serving path shards its batch over: every
    data-parallel axis present ("pod"/"data"), else the first mesh axis (a
    bare single-axis serving mesh still gets batch DP)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else (mesh.axis_names[0],)


def vision_batch_multiple(mesh) -> int:
    """Per-step batch sizes must be a multiple of this (the product of the
    batch mesh axes) so every device gets equal full shards."""
    mult = 1
    for a in vision_batch_axes(mesh):
        mult *= mesh.shape[a]
    return mult


def vision_batch_devices(mesh) -> list:
    """One device a batch shard, in the order the batch is split: row-major
    over the batch axes, the first device along every other axis (the
    others would hold replicas of the same shard)."""
    axes = vision_batch_axes(mesh)
    strides = [math.prod(mesh.axis_sizes[i + 1:]) for i in range(len(mesh.axis_sizes))]
    out = [0]
    for name, size, stride in zip(mesh.axis_names, mesh.axis_sizes, strides):
        if name in axes:
            out = [i + k * stride for i in out for k in range(size)]
    return [mesh.devices[i] for i in out]


def make_vision_rules(mesh) -> dict[str, Any]:
    """Vision-serving preset: shard ONLY the batch axis over the mesh's
    data-parallel axes and replicate everything else.

    smallNet carries 510 parameters (~2 KB), so replicating the weights is
    free and the whole scaling story is batch DP (`VisionEngine(mesh=)`
    splits each step's batch across the mesh's devices).  On a 1-device
    mesh it changes nothing.
    """
    axes = vision_batch_axes(mesh)
    batch = axes if len(axes) > 1 else axes[0]
    return {
        "batch": batch,
        # spatial / feature / class dims stay replicated
        "height": None, "width": None, "channels": None,
        "features": None, "classes": None,
    }


def specs_from_axes(axes_tree: Any) -> Any:
    """Logical-axes tree (tuples of names) -> PartitionSpec tree, under the
    active rules; a `ptq.QuantTensor` of axes becomes one of specs."""
    return tree_map(lambda axes: logical_spec(*axes), axes_tree,
                    is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields"))
