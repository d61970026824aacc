"""Float PLAN sigmoid: the CUDA kernel and its plain version.

Port of `repro.kernels.sigmoid_pla` (`ops.py` wrapper, `kernel.py`
`sigmoid_pla_pallas`, `ref.py`).  `sigmoid_pla` sends CPU tensors to
`sigmoid_pla_plain` and launches `sigmoid_pla_launch` of
`csrc/float_kernels.cu` for CUDA tensors: one flat grid over every word,
any rank and size.  The reference pads to `(R, 128)` rows in blocks of
`block_rows`; that is TPU tiling and does not carry over.  The kernel's
affine pieces round as the plain version's separate ops do, so the two
give the same floats.
"""
from __future__ import annotations

import torch

from repro_torch.core.fixed_point import sigmoid_plan_f32
from repro_torch.kernels import _build
from repro_torch.kernels._launch import count_launch, on_cuda, require_tensor, stream_of

sigmoid_pla_plain = sigmoid_plan_f32


def sigmoid_pla(x: torch.Tensor) -> torch.Tensor:
    """PLAN sigmoid of a contiguous float32 tensor of any shape."""
    require_tensor("sigmoid_pla x", x, (torch.float32,))
    if not on_cuda(x):
        return sigmoid_pla_plain(x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library("float_kernels")
    dev, stream = stream_of(x)
    rc = lib.sigmoid_pla_launch(dev, x.data_ptr(), out.data_ptr(), x.numel(), stream)
    _build.check(lib, rc, "sigmoid_pla")
    count_launch("sigmoid_pla")
    return out
