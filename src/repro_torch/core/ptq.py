"""Post-training quantization: symmetric int8 with per-channel weight scales.

Port of `repro.core.ptq` for smallNet's `int8` backend.  The paper trains
in float, extracts the weights and converts them to fixed point; the
`int8` substrate stores weights as int8 with float32 scales instead and
accumulates the dense layer's products exactly in int32
(`kernels/quant_matmul`).

The rounding is the reference's: `round(x / scale)` (half to even in
both frameworks, a true division, not a multiplication by the
reciprocal), clipped to [-qmax-1, qmax]; a scale is max|x| (or the
linear-interpolated percentile) floored at 1e-8, over qmax.

Parameter trees are nests of dicts, lists and tuples.  The reference's
`QuantTensor` is a registered pytree node and its predicate reads the
leaf's path as `jax.tree_util.keystr` prints it ("['dense']['w']"); the
port builds the same path text, so "blocks", "norm" and "pos" select the
same leaves.  `quantize_axes` keeps an LM's logical-axes tree in step
with `quantize_tree`, and `abstract_quantize_tree` is `quantize_tree` over
meta tensors: shapes and dtypes, no memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    per_channel: bool = True       # scale per output channel (last weight dim)
    percentile: float = 100.0      # 100 = absmax; <100 clips outliers
    symmetric: bool = True         # symmetric (2's complement) only, like the paper

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


@dataclasses.dataclass
class QuantTensor:
    """int values + float scale; value = q * scale."""
    q: torch.Tensor            # int8
    scale: torch.Tensor        # float32, broadcastable against q

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale


def _calib_scale(x: torch.Tensor, cfg: QuantConfig, axis: tuple[int, ...]) -> torch.Tensor:
    ax = torch.abs(x.to(torch.float32))
    if not axis:
        m = ax
    elif cfg.percentile >= 100.0:
        m = torch.amax(ax, dim=axis, keepdim=True)
    else:
        # torch.quantile reduces one dim: move the reduced axes last and
        # flatten them, then put the kept shape back (keepdims)
        keep = [d for d in range(ax.ndim) if d not in axis]
        flat = ax.permute(*keep, *axis).reshape(*[ax.shape[d] for d in keep], -1)
        m = torch.quantile(flat, cfg.percentile / 100.0, dim=-1)
        m = m.reshape([1 if d in axis else ax.shape[d] for d in range(ax.ndim)])
    # qmax as a tensor on m's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which can move the last bit of a
    # scale (and so an int8 word) away from the true quotient that XLA and
    # PyTorch's CPU division give
    return torch.clamp(m, min=1e-8) / torch.tensor(float(cfg.qmax), device=m.device)


def _round_clip(x: torch.Tensor, scale: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -cfg.qmax - 1, cfg.qmax).to(torch.int8)


def quantize(x: torch.Tensor, cfg: QuantConfig = QuantConfig()) -> QuantTensor:
    """Symmetric quantization.  Per-channel scales are over the LAST dim."""
    if cfg.per_channel and x.ndim >= 2:
        axis = tuple(range(x.ndim - 1))
    else:
        axis = tuple(range(x.ndim))
    scale = _calib_scale(x, cfg, axis)
    return QuantTensor(_round_clip(x, scale, cfg), scale)


def quantize_activation(x: torch.Tensor, scale: torch.Tensor,
                        cfg: QuantConfig = QuantConfig()) -> QuantTensor:
    """Quantize with a pre-calibrated (static) scale."""
    return QuantTensor(_round_clip(x, scale, cfg), scale)


def calibrate_activation_scale(samples: torch.Tensor,
                               cfg: QuantConfig = QuantConfig()) -> torch.Tensor:
    """Per-tensor activation scale from a calibration batch."""
    return _calib_scale(samples, dataclasses.replace(cfg, per_channel=False),
                        tuple(range(samples.ndim)))


def quantized_matmul_ref(xq: QuantTensor, wq: QuantTensor) -> torch.Tensor:
    """int8 x int8 -> exact integer sum -> dequantized float32, in PyTorch
    ops (the kernel is `kernels/quant_matmul`).  The sum is taken in
    float64, exact for these integers, as `quant_matmul_plain` takes it."""
    acc = (xq.q.to(torch.float64) @ wq.q.to(torch.float64)).to(torch.int32)
    return acc.to(torch.float32) * xq.scale * wq.scale.reshape(1, -1)


def _map_with_path(fn, tree, path: str = ""):
    """Apply `fn(path, leaf)` over a nest of dicts, lists and tuples, with
    `QuantTensor`s as leaves; `path` is the text `jax.tree_util.keystr`
    gives the same leaf ("['dense']['w']", "[0]")."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def _default_predicate(path: str, x) -> bool:
    """Quantize matrix weights only: rank>=3 (stacked-layer weights) or
    top-level rank-2 matrices (embed/lm_head).  Rank-2 leaves inside stacked
    blocks are norms/biases stacked over layers — they stay float (biases add
    post-MAC at accumulator precision, exactly like the paper)."""
    if not (isinstance(x, torch.Tensor) and x.dtype.is_floating_point):
        return False
    if x.ndim >= 3:
        return True
    return x.ndim == 2 and "blocks" not in path and "norm" not in path \
        and "pos" not in path


def quantize_tree(params: Any, cfg: QuantConfig = QuantConfig(),
                  predicate: Callable[[str, torch.Tensor], bool] | None = None):
    """Quantize every leaf the predicate selects (by default the >=2-D float
    weights) into a `QuantTensor`; biases stay float.  A rank>=3 leaf is
    a stack of layers: its per-channel scales are per (layer, channel), over
    the axes between the first and the last (smallNet's conv weight
    (2,2,1,1) gets scales of shape (2,1,1,1), the dense (49,10) of (1,10))."""
    predicate = _default_predicate if predicate is None else predicate

    def one(path, leaf):
        if not predicate(path, leaf):
            return leaf
        if cfg.per_channel:
            axis = tuple(range(1 if leaf.ndim >= 3 else 0, leaf.ndim - 1))
        else:
            axis = tuple(range(leaf.ndim))
        scale = _calib_scale(leaf.to(torch.float32), cfg, axis)
        return QuantTensor(_round_clip(leaf, scale, cfg), scale)
    return _map_with_path(one, params)


def quantize_axes(params: Any, axes: Any,
                  predicate: Callable[[str, torch.Tensor], bool] | None = None) -> Any:
    """Transform a logical-axes tree (tuples of names, one per param leaf)
    in lockstep with quantize_tree: a weight leaf's axes tuple becomes
    `QuantTensor(axes, scale_axes)`, the scale's axes (None,...,last), with
    the stacked-layer leading axis kept for rank>=3 leaves."""
    predicate = _default_predicate if predicate is None else predicate

    def walk(p, a, path):
        if isinstance(p, dict):
            return {k: walk(p[k], a[k], f"{path}[{k!r}]") for k in p}
        if not predicate(path, p):
            return a
        if p.ndim >= 3:
            sax = (a[0],) + (None,) * (len(a) - 2) + (a[-1],)
        else:
            sax = (None,) * (len(a) - 1) + (a[-1],)
        return QuantTensor(a, sax)
    return walk(params, axes, "")


def abstract_quantize_tree(params_abs: Any, cfg: QuantConfig = QuantConfig()) -> Any:
    """quantize_tree over meta tensors (`models.model.abstract_params`):
    the quantized tree's shapes and dtypes, with no memory allocated."""
    leaves = []
    _map_with_path(lambda _, x: leaves.append(x), params_abs)
    if not all(isinstance(x, torch.Tensor) and x.is_meta for x in leaves):
        raise ValueError("abstract_quantize_tree takes meta tensors only")
    return quantize_tree(params_abs, cfg)


def dequantize_tree(qparams: Any) -> Any:
    """Inverse of quantize_tree (for accuracy-gap analysis)."""
    return _map_with_path(
        lambda _, x: x.dequantize() if isinstance(x, QuantTensor) else x, qparams)


def quantization_error(params: Any, qparams: Any) -> dict:
    """Per-leaf relative L2 error of quantization — the paper's §III-B
    'limitations of numerical representations' analysis, as a tool.  Keys
    are the quantized leaves' paths ("['dense']['w']")."""
    errs: dict[str, float] = {}

    def walk(p, q, path):
        if isinstance(q, dict):
            for k in q:
                walk(p[k], q[k], f"{path}[{k!r}]")
        elif isinstance(q, (list, tuple)):
            for i, (pi, qi) in enumerate(zip(p, q)):
                walk(pi, qi, f"{path}[{i}]")
        elif isinstance(q, QuantTensor):
            p = torch.as_tensor(p, dtype=torch.float32, device=q.q.device)
            errs[path] = float(torch.linalg.norm(p - q.dequantize())
                               / (torch.linalg.norm(p) + 1e-12))
    walk(params, qparams, "")
    return errs
