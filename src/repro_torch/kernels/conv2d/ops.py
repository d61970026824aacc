"""Float NHWC conv with a fused bias and activation: the CUDA kernel and its
plain version.

Port of `repro.kernels.conv2d` (`ops.py` wrapper, `kernel.py`
`conv2d_pallas`, `ref.py`).  `conv2d` sends CPU tensors to `conv2d_plain`
and launches `conv2d_launch` of `csrc/float_kernels.cu` for CUDA tensors.
Semantics are the reference's:

  * x (B,H,W,Cin) float32 NHWC, w (kh,kw,Cin,Cout) HWIO, any kh, kw, Cin,
    Cout; b (Cout,) or None;
  * SAME pads 0 before and k-1 after (the Keras even-kernel convention),
    VALID pads nothing;
  * stride is native: only the ceil(H1/stride) x ceil(W1/stride) kept
    outputs are computed, output (i, j) reading input (i*stride+dh,
    j*stride+dw);
  * then the bias, then the optional fused activation: None, "sigmoid" or
    "plan" (`apply_sigmoid=True` is the reference's spelling of
    "sigmoid").

The reference checks its image block against a 14 MB TPU VMEM budget
(`_VMEM_BUDGET`).  The kernel here keeps no image resident (one thread
per output, SAME's padding read as zero taps), so there is no such limit
and no guard.

The plain version computes each tap's shifted window times its weights
with elementwise ops, summed in the kernel's order.  It does not call
`F.conv2d`: on a CUDA float32 tensor cuDNN computes in TF32 by default,
about 1e-3 off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.fixed_point import sigmoid_plan_f32
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, on_cuda, require_tensor, stream_of

_ACTIVATIONS = (None, "sigmoid", "plan")
_ACT_CODE = {None: 0, "sigmoid": 1, "plan": 2}
_F32 = (torch.float32,)


def _activation(activation: str | None, apply_sigmoid: bool) -> str | None:
    if activation is None and apply_sigmoid:
        activation = "sigmoid"
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {_ACTIVATIONS}")
    return activation


def _geometry(x_shape, w_shape, stride: int, padding: str):
    """(pad_h, pad_w, Ho, Wo): SAME's bottom/right pad and the strided
    output extent."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    kh, kw = w_shape[0], w_shape[1]
    ph, pw = (kh - 1, kw - 1) if padding == "SAME" else (0, 0)
    H1, W1 = x_shape[1] + ph - kh + 1, x_shape[2] + pw - kw + 1
    if H1 < 1 or W1 < 1:
        raise ValueError(f"conv2d: a {kh}x{kw} {padding} kernel does not fit "
                         f"an input of shape {tuple(x_shape)}")
    return ph, pw, -(-H1 // stride), -(-W1 // stride)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                 stride: int = 1, padding: str = "SAME",
                 apply_sigmoid: bool = False,
                 activation: str | None = None) -> torch.Tensor:
    """The conv in elementwise PyTorch ops: taps in (dh, dw) order, Cin
    inside each tap, then the bias, then the activation."""
    activation = _activation(activation, apply_sigmoid)
    ph, pw, Ho, Wo = _geometry(x.shape, w.shape, stride, padding)
    kh, kw, cin, _ = w.shape
    xp = F.pad(x, (0, 0, 0, pw, 0, ph))
    hspan, wspan = (Ho - 1) * stride + 1, (Wo - 1) * stride + 1
    acc = None
    for dh in range(kh):
        for dw in range(kw):
            win = xp[:, dh:dh + hspan:stride, dw:dw + wspan:stride, :]
            for c in range(cin):
                term = win[..., c:c + 1] * w[dh, dw, c]          # (B,Ho,Wo,Cout)
                acc = term if acc is None else acc + term
    if b is not None:
        acc = acc + b
    if activation == "sigmoid":
        return torch.sigmoid(acc)
    if activation == "plan":
        return sigmoid_plan_f32(acc)
    return acc


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: str = "SAME", apply_sigmoid: bool = False,
           activation: str | None = None) -> torch.Tensor:
    """NHWC x HWIO -> NHWC float32 conv, native stride, fused bias and
    activation (None, "sigmoid" or "plan")."""
    activation = _activation(activation, apply_sigmoid)
    require_tensor("conv2d x", x, _F32, ndim=4)
    require_tensor("conv2d w", w, _F32, ndim=4)
    B, H, W, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin:
        raise ValueError(f"conv2d: x {tuple(x.shape)} has {cin} channels, "
                         f"w {tuple(w.shape)} takes {wcin}")
    _, _, Ho, Wo = _geometry(x.shape, w.shape, stride, padding)
    if b is None:
        b = torch.zeros(cout, dtype=torch.float32, device=x.device)
    require_tensor("conv2d b", b, _F32, numel=cout)
    if not on_cuda(x, w, b):
        return conv2d_plain(x, w, b, stride=stride, padding=padding,
                            activation=activation)
    out = torch.empty((B, Ho, Wo, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("float_kernels")
    dev, stream = stream_of(x)
    rc = lib.conv2d_launch(dev, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                           out.data_ptr(), B, H, W, cin, kh, kw, cout, Ho, Wo,
                           stride, _ACT_CODE[activation], stream)
    _build.check(lib, rc, "conv2d")
    LAUNCHES["conv2d"] += 1
    return out
