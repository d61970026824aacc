"""Carry smallNet parameters from the JAX package into the port.

`params_from_jax(tree, device)` takes the reference's params as arrays
(numpy, anything `np.asarray` accepts, or torch tensors on any device) —
float, or the int32 words of its `quantize_params_fixed` — and returns the
port's dict of tensors.  The layouts stay: conv weights (2,2,1,1) HWIO and
biases (1,), dense (49,10) and (10,), so both packages compute the same
thing from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device

SHAPES = {
    "conv1": {"w": (2, 2, 1, 1), "b": (1,)},
    "conv2": {"w": (2, 2, 1, 1), "b": (1,)},
    "dense": {"w": (49, 10), "b": (10,)},
}


def params_from_jax(tree: dict, device: torch.device | str | None = None) -> dict:
    dev = resolve_device(device)
    out: dict = {}
    for layer, leaves in SHAPES.items():
        out[layer] = {}
        for leaf, shape in leaves.items():
            a = tree[layer][leaf]
            a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
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
