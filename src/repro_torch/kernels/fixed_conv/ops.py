"""Fixed-point conv stage, 2x2/2 max pool and PLAN sigmoid: CUDA kernels and
their plain PyTorch versions.

Port of `repro.kernels.fixed_conv` (`ops.py` wrappers + `kernel.py` Pallas
kernels).  Each public wrapper checks its tensors, sends CPU tensors to its
`*_plain` version and launches its kernel from `csrc/fixed_conv.cu` for
CUDA tensors (see `kernels/_launch.py`):

  fixed_conv2d      2x2 SAME Qm.n conv (4-tap MAC, each product renormalized
                    and wrapped), `fixed_add` bias, optional PLAN epilogue,
                    optional fused 2x2/2 pool (odd extents cropped) or an
                    output stride (only the kept words are computed)
  fixed_maxpool2x2  (B,H,W) -> (B,H//2,W//2) comparator tree, odd cropped
  fixed_sigmoid     elementwise PLAN sigmoid over any shape

The reference wrappers budget TPU VMEM (`fixed_conv/ops.py:_check_vmem`)
because a Pallas grid step holds a whole padded image.  These kernels keep
no image resident (one thread per output word, SAME padding read as zero
taps), so there is no such limit to check.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, on_cuda, require_words, stream_of

_ACTIVATIONS = (None, "plan")
_TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))   # (dh, dw) per 2x2 kernel tap


def _check_conv_args(activation, pool: bool, stride: int) -> None:
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {_ACTIVATIONS}")
    if pool and stride > 1:
        raise ValueError("pool and stride>1 cannot be combined")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")


# -- plain PyTorch versions ---------------------------------------------------

def fixed_maxpool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W) int32 -> (B,H//2,W//2): comparator tree, odd row/col cropped."""
    H, W = x.shape[1], x.shape[2]
    x = x[:, :H - H % 2, :W - W % 2]
    return torch.maximum(torch.maximum(x[:, ::2, ::2], x[:, ::2, 1::2]),
                         torch.maximum(x[:, 1::2, ::2], x[:, 1::2, 1::2]))


def fixed_sigmoid_plain(x: torch.Tensor, *,
                        cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    return fxp.fixed_sigmoid_plan(x, cfg)


def fixed_conv2d_plain(x: torch.Tensor, w4: torch.Tensor, b: torch.Tensor, *,
                       cfg: fxp.FixedPointConfig = fxp.Q16_16,
                       activation: str | None = None, pool: bool = False,
                       stride: int = 1) -> torch.Tensor:
    """windowing -> MAC -> bias -> [PLAN] -> [stride | pool], in torch ops."""
    _check_conv_args(activation, pool, stride)
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 1, 0, 1))                     # SAME: 0 before, 1 after
    w4 = w4.reshape(4)
    acc = sum(fxp.fixed_mul(xp[:, dh:dh + H, dw:dw + W], w4[t], cfg).to(torch.int64)
              for t, (dh, dw) in enumerate(_TAPS))
    y = fxp.fixed_add(fxp._wrap(acc, 32), b.reshape(()), cfg)   # int32 MAC sum
    if activation == "plan":
        y = fxp.fixed_sigmoid_plan(y, cfg)
    if stride > 1:
        y = y[:, ::stride, ::stride].contiguous()
    if pool:
        y = fixed_maxpool2x2_plain(y)
    return y


# -- wrappers -------------------------------------------------------------------

def fixed_conv2d(x: torch.Tensor, w4: torch.Tensor, b: torch.Tensor, *,
                 cfg: fxp.FixedPointConfig = fxp.Q16_16,
                 activation: str | None = None, pool: bool = False,
                 stride: int = 1) -> torch.Tensor:
    """Fused fixed-point 2x2 SAME conv: x (B,H,W) int32, w4 (4,) taps in
    row-major (dh, dw) order, b (1,) bias word -> (B,H,W) int32, or
    (B,H//2,W//2) with `pool`, or the stride-decimated output."""
    _check_conv_args(activation, pool, stride)
    require_words("fixed_conv2d x", x, ndim=3)
    require_words("fixed_conv2d w4", w4, numel=4)
    require_words("fixed_conv2d b", b, numel=1)
    if not on_cuda(x, w4, b):
        return fixed_conv2d_plain(x, w4, b, cfg=cfg, activation=activation,
                                  pool=pool, stride=stride)
    B, H, W = x.shape
    if pool:
        Ho, Wo = H // 2, W // 2
    else:
        Ho, Wo = -(-H // stride), -(-W // stride)
    out = torch.empty((B, Ho, Wo), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("fixed_conv")
    dev, stream = stream_of(x)
    rc = lib.fixed_conv2d_launch(dev, x.data_ptr(), w4.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), B, H, W, Ho, Wo, stride,
                                 int(activation == "plan"), int(pool),
                                 _build.fixed_cfg(cfg), stream)
    _build.check(lib, rc, "fixed_conv2d")
    LAUNCHES["fixed_conv2d"] += 1
    return out


def fixed_maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W) int32 -> (B,H//2,W//2), VALID 2x2/2 comparator tree."""
    require_words("fixed_maxpool2x2 x", x, ndim=3)
    if not on_cuda(x):
        return fixed_maxpool2x2_plain(x)
    B, H, W = x.shape
    out = torch.empty((B, H // 2, W // 2), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("fixed_conv")
    dev, stream = stream_of(x)
    rc = lib.fixed_maxpool2x2_launch(dev, x.data_ptr(), out.data_ptr(), B, H, W,
                                     H // 2, W // 2, stream)
    _build.check(lib, rc, "fixed_maxpool2x2")
    LAUNCHES["fixed_maxpool2x2"] += 1
    return out


def fixed_sigmoid(x: torch.Tensor, *,
                  cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """Standalone PLAN sigmoid launch over any-shaped int32 words."""
    require_words("fixed_sigmoid x", x)
    if not on_cuda(x):
        return fixed_sigmoid_plain(x, cfg=cfg)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library("fixed_conv")
    dev, stream = stream_of(x)
    rc = lib.fixed_sigmoid_launch(dev, x.data_ptr(), out.data_ptr(), x.numel(),
                                  _build.fixed_cfg(cfg), stream)
    _build.check(lib, rc, "fixed_sigmoid")
    LAUNCHES["fixed_sigmoid"] += 1
    return out
