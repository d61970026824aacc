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
  fixed_smallnet    the whole Qm.n smallNet forward, (B,H,W) ingested words
                    -> (B,N) PLAN'd class-score words, in one launch of
                    `csrc/fixed_net.cu` (the served step on `fixed_cuda`);
                    its plain version composes the stages above and the
                    dense layer

The reference wrappers budget TPU VMEM (`fixed_conv/ops.py:_check_vmem`)
because a Pallas grid step holds a whole padded image.  The per-stage
kernels keep no image resident (one thread per output word, SAME padding
read as zero taps), so there is no such limit to check; `fixed_smallnet`
holds images and their pooled maps in shared memory, which bounds the image
(`smallnet_fits` asks the kernel's launcher).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import _build
from repro_torch.kernels._launch import count_launch, on_cuda, require_words, stream_of
from repro_torch.kernels.quant_matmul.ops import fixed_dense_plain

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
    count_launch("fixed_conv2d")
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
    count_launch("fixed_maxpool2x2")
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
    count_launch("fixed_sigmoid")
    return out


# -- the whole net ------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def smallnet_fits(H: int, W: int, N: int) -> bool:
    """Whether the whole-net kernel takes (H, W) images and N classes, as
    its launcher decides it (the library is built on first use): at least
    4x4 words (a dense input), and an image group's maps and the dense
    words within the shared memory (up to about 170x170 words with N =
    10)."""
    return bool(_build.library("fixed_net").fixed_smallnet_fits(H, W, N))


def _smallnet_args(x, c1w, c1b, c2w, c2b, dw, db) -> None:
    require_words("fixed_smallnet x", x, ndim=3)
    for name, t, n in (("c1w", c1w, 4), ("c1b", c1b, 1), ("c2w", c2w, 4), ("c2b", c2b, 1)):
        require_words(f"fixed_smallnet {name}", t, numel=n)
    require_words("fixed_smallnet dw", dw, ndim=2)
    _, H, W = x.shape
    K, N = dw.shape
    if K != (H // 4) * (W // 4):
        raise ValueError(f"fixed_smallnet: dw {tuple(dw.shape)} does not take the "
                         f"{H // 4}x{W // 4} pooled map of {H}x{W} images")
    require_words("fixed_smallnet db", db, numel=N)


def fixed_smallnet_plain(x: torch.Tensor, c1w: torch.Tensor, c1b: torch.Tensor,
                         c2w: torch.Tensor, c2b: torch.Tensor, dw: torch.Tensor,
                         db: torch.Tensor, *,
                         cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """conv + PLAN + pool twice, flatten, the dense layer, PLAN: the plain
    stages composed."""
    y = fixed_conv2d_plain(x, c1w.reshape(4), c1b, cfg=cfg, activation="plan", pool=True)
    y = fixed_conv2d_plain(y, c2w.reshape(4), c2b, cfg=cfg, activation="plan", pool=True)
    return fixed_sigmoid_plain(fixed_dense_plain(y.reshape(y.shape[0], -1), dw, db, cfg=cfg),
                               cfg=cfg)


def fixed_smallnet(x: torch.Tensor, c1w: torch.Tensor, c1b: torch.Tensor,
                   c2w: torch.Tensor, c2b: torch.Tensor, dw: torch.Tensor,
                   db: torch.Tensor, *,
                   cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """The whole smallNet forward: x (B,H,W) ingested int32 words, conv
    taps c1w, c2w (4 words in row-major (dh, dw) order, e.g. the (2,2,1,1)
    params), conv biases c1b, c2b (1 word), dense dw ((H/4)(W/4), N) and db
    (N,) -> (B,N) PLAN'd class-score words, as the per-stage route computes
    them.  The kernel takes the images `smallnet_fits` allows and raises
    ValueError for any other; the plain version takes any."""
    _smallnet_args(x, c1w, c1b, c2w, c2b, dw, db)
    if not on_cuda(x, c1w, c1b, c2w, c2b, dw, db):
        return fixed_smallnet_plain(x, c1w, c1b, c2w, c2b, dw, db, cfg=cfg)
    B, H, W = x.shape
    N = dw.shape[1]
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("fixed_net")
    dev, stream = stream_of(x)
    rc = lib.fixed_smallnet_launch(dev, x.data_ptr(), c1w.data_ptr(), c1b.data_ptr(),
                                   c2w.data_ptr(), c2b.data_ptr(), dw.data_ptr(),
                                   db.data_ptr(), out.data_ptr(), B, H, W, N,
                                   _build.fixed_cfg(cfg), stream)
    _build.check(lib, rc, f"fixed_smallnet {H}x{W} images, {N} classes")
    count_launch("fixed_smallnet")
    return out
