"""Fixed-point (Qm.n) dense layer: the CUDA kernel and its plain version.

Port of `repro.kernels.quant_matmul.fixed_dense` (`ops.py`) and
`fixed_matmul_pallas` (`kernel.py`).  `fixed_dense` checks its tensors,
sends CPU tensors to `fixed_dense_plain` and launches the kernel of
`csrc/fixed_dense.cu` for CUDA tensors.  The reference pads the batch to
its Pallas block and budgets VMEM; the kernel here is one thread per
output word, so neither carries over.  The int8 `quant_matmul` is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, on_cuda, require_words, stream_of


def fixed_dense_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """(M,K) @ (K,N) + b with the MAC-array semantics, in torch ops."""
    return fxp.fixed_add(fxp.fixed_matmul(x, w, cfg), b.reshape(1, -1), cfg)


def fixed_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                *, cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """Fixed-point dense layer: x (M,K), w (K,N), b (N,) or None, all int32
    Qm.n words -> (M,N) int32."""
    require_words("fixed_dense x", x, ndim=2)
    require_words("fixed_dense w", w, ndim=2)
    M, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"fixed_dense: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    N = w.shape[1]
    if b is None:
        b = torch.zeros((N,), dtype=torch.int32, device=x.device)
    require_words("fixed_dense b", b, numel=N)
    if not on_cuda(x, w, b):
        return fixed_dense_plain(x, w, b, cfg=cfg)
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("fixed_dense")
    dev, stream = stream_of(x)
    rc = lib.fixed_dense_launch(dev, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                out.data_ptr(), M, K, N, _build.fixed_cfg(cfg),
                                stream)
    _build.check(lib, rc, "fixed_dense")
    LAUNCHES["fixed_dense"] += 1
    return out
