"""Float NHWC 2x2/2 max pool: the CUDA kernel and its plain version.

Port of `repro.kernels.maxpool2d` (`ops.py` wrapper, `kernel.py`
`maxpool2d_pallas`, `ref.py`).  `maxpool2d` sends CPU tensors to
`maxpool2d_plain` and launches `maxpool2d_launch` of
`csrc/float_kernels.cu` for CUDA tensors.  Odd H and W are cropped, as the
reference's wrapper crops them; the kernel reads only the even part, so no
cropped copy is made.  float32 and bfloat16, returned in the input's
dtype; a NaN propagates, as in `torch.maximum`.  Exact in both types.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import count_launch, on_cuda, require_tensor, stream_of

_DTYPES = (torch.float32, torch.bfloat16)


def maxpool2d_plain(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B,H//2,W//2,C): the comparator tree, odd row/col cropped."""
    H, W = x.shape[1], x.shape[2]
    x = x[:, :H - H % 2, :W - W % 2]
    return torch.maximum(torch.maximum(x[:, ::2, ::2], x[:, ::2, 1::2]),
                         torch.maximum(x[:, 1::2, ::2], x[:, 1::2, 1::2]))


def maxpool2d(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) float32 or bfloat16 -> (B,H//2,W//2,C), VALID 2x2/2 max pool."""
    require_tensor("maxpool2d x", x, _DTYPES, ndim=4)
    if not on_cuda(x):
        return maxpool2d_plain(x)
    B, H, W, C = x.shape
    out = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("float_kernels")
    dev, stream = stream_of(x)
    rc = lib.maxpool2d_launch(dev, x.data_ptr(), out.data_ptr(), B, H, W, C,
                              int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, rc, "maxpool2d")
    count_launch("maxpool2d")
    return out
