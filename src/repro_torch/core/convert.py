"""Carry parameters from the JAX package into the port.

`params_from_jax(tree, device)` takes the reference's params as arrays
(numpy, anything `np.asarray` accepts, or torch tensors on any device) —
float, the int32 words of its `quantize_params_fixed`, or the int8
`QuantTensor`s of its `quantize_params_int8` (recognized by their `.q`
and `.scale`, without importing the reference) — and returns the port's
dict of tensors (and `ptq.QuantTensor`s).  The layouts stay: conv
weights (2,2,1,1) HWIO and biases (1,), dense (49,10) and (10,), so both
packages compute the same thing from the same numbers.

`lm_params_from_jax(tree, device)` carries an LM's params (the nested
dicts of `repro.models.transformer.init_params`, float or quantized by
`repro.core.ptq.quantize_tree`) leaf for leaf, each in its own dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ptq
from repro_torch.core.device import resolve_device

SHAPES = {
    "conv1": {"w": (2, 2, 1, 1), "b": (1,)},
    "conv2": {"w": (2, 2, 1, 1), "b": (1,)},
    "dense": {"w": (49, 10), "b": (10,)},
}


def _array(a) -> np.ndarray:
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _quant_leaf(name: str, a, shape: tuple, dev: torch.device) -> ptq.QuantTensor:
    """The reference's `ptq.QuantTensor` (anything with `.q` int8 words and a
    float `.scale` broadcastable against them) -> the port's."""
    q, scale = _array(a.q), _array(a.scale)
    if q.shape != shape or q.dtype != np.int8:
        raise TypeError(f"{name}.q: expected int8 words of shape {shape}, "
                        f"got {q.dtype} {q.shape}")
    try:
        fits = np.broadcast_shapes(scale.shape, shape) == shape
    except ValueError:
        fits = False
    if scale.dtype.kind != "f" or not fits:
        raise TypeError(f"{name}.scale: expected float scales broadcastable to "
                        f"{shape}, got {scale.dtype} {scale.shape}")
    return ptq.QuantTensor(torch.tensor(q, device=dev),
                           torch.tensor(scale.astype(np.float32), device=dev))


def params_from_jax(tree: dict, device: torch.device | str | None = None) -> dict:
    dev = resolve_device(device)
    out: dict = {}
    for layer, leaves in SHAPES.items():
        out[layer] = {}
        for leaf, shape in leaves.items():
            a = tree[layer][leaf]
            if hasattr(a, "q") and hasattr(a, "scale"):
                out[layer][leaf] = _quant_leaf(f"{layer}.{leaf}", a, shape, dev)
                continue
            a = _array(a)
            if a.shape != shape:
                raise ValueError(f"{layer}.{leaf}: expected shape {shape}, got {a.shape}")
            if a.dtype.kind == "f":
                a = a.astype(np.float32)
            elif a.dtype.kind in "iu" and np.all((a >= -2 ** 31) & (a < 2 ** 31)):
                a = a.astype(np.int32)
            else:
                raise TypeError(f"{layer}.{leaf}: expected float or int32 words, "
                                f"got {a.dtype}")
            out[layer][leaf] = torch.tensor(a, device=dev)
    return out


def _lm_leaf(path: str, a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.array(a)               # a writable copy, whatever held it
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    if a.dtype.kind not in "fiu":
        raise TypeError(f"{path}: expected a float or integer array, got {a.dtype}")
    return torch.from_numpy(a).to(dev)


def lm_params_from_jax(tree, device: torch.device | str | None = None):
    """The reference's LM params (a nest of dicts whose leaves are arrays:
    numpy, anything `np.asarray` accepts, or tensors) as the port's tree of
    tensors on `device`, each leaf in its own dtype; a leaf with `.q` and
    `.scale` (the reference's `ptq.QuantTensor`) becomes the port's."""
    dev = resolve_device(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return ptq.QuantTensor(_lm_leaf(path + ".q", node.q, dev),
                                   _lm_leaf(path + ".scale", node.scale, dev))
        if isinstance(node, (str, bytes)) or node is None:
            raise TypeError(f"{path}: expected an array leaf, got {type(node).__name__}")
        return _lm_leaf(path, node, dev)
    return walk(tree, "")
