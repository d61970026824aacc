"""Float NHWC conv with a fused bias and activation, and the whole float
smallNet step: the CUDA kernels and their plain versions.

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
(`_VMEM_BUDGET`).  The kernel stages a tile of output pixels with its input
halo in shared memory, sized by its launcher (`conv2d_tile`), and a conv
whose single-pixel tile does not fit takes the launcher's direct kernel,
so there is no such limit and no guard.

`float_smallnet` is the served step of the float backends (`cuda`,
`cuda_plan`) in one launch of `csrc/float_net.cu`: conv + activation + max
pool twice, the dense layer and its activation, as the composed route
computes them; `float_smallnet_fits` asks its launcher which images it
takes.

`float_sweep_stage` is one stage of the float frame sweep in one launch of
`csrc/float_sweep.cu`: the conv, the activation and the 2x2/2 pool of the
four role maps (`streaming/fcn_sweep._sweep_stage`), with each masked
weight a choice of taps inside the kernel.  `float_window_head` is the
sweep's head in one launch of the same library: every window's features
read from the four pooled maps, the dense layer and the activation; its
plain version is the composed head (stack, gather, `@ w + b`, the
activation).

The plain versions compute each tap's shifted window times its weights
with elementwise ops, summed in the kernel's order.  They do not call
`F.conv2d`: on a CUDA float32 tensor cuDNN computes in TF32 by default,
about 1e-3 off.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.fixed_point import sigmoid_plan_f32
from repro_torch.kernels import _build
from repro_torch.kernels._launch import count_launch, on_cuda, require_tensor, stream_of
from repro_torch.kernels.frame_trunk.ops import (_M_00, _M_01, _M_10, _M_11, _M_ALL, _M_BOT,
                                                 _M_LEFT, _M_RIGHT, _M_TOP, pool_mix,
                                                 pool_quadrants)
from repro_torch.kernels.maxpool2d.ops import maxpool2d_plain
from repro_torch.kernels.quant_matmul.ops import window_gather_index

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
    count_launch("conv2d")
    return out


def conv2d_tile(x_shape, w_shape, *, stride: int = 1, padding: str = "SAME") -> dict | None:
    """The tile `conv2d`'s launcher takes for a conv of these shapes, as it
    decides it (the library is built on first use): output rows "TH" and
    columns "TW" a block stages, output rows "PR" a thread, output channels
    "CC" a block and "V" a thread, shared-memory "bytes"; None where it
    takes the direct kernel."""
    _, _, Ho, Wo = _geometry(x_shape, w_shape, stride, padding)
    tile = (ctypes.c_int * 6)()
    lib = _build.library("float_kernels")
    if not lib.conv2d_tile(x_shape[1], x_shape[2], x_shape[3], w_shape[0], w_shape[1],
                           w_shape[3], Ho, Wo, stride, tile):
        return None
    return dict(zip(("TH", "TW", "PR", "CC", "V", "bytes"), tile))


# -- the whole float net ----------------------------------------------------------

_NET_ACTIVATIONS = ("sigmoid", "plan")


@functools.lru_cache(maxsize=64)
def float_smallnet_fits(H: int, W: int, N: int) -> bool:
    """Whether the whole-net kernel takes (H, W) images and N classes, as
    its launcher decides it (the library is built on first use): at least
    4x4 (a dense input), and an image group's maps and the dense weights
    within the shared memory (up to about 170x170 with N = 10)."""
    return bool(_build.library("float_net").float_smallnet_fits(H, W, N))


def _net_args(x, c1w, c1b, c2w, c2b, dw, db, activation) -> None:
    if activation not in _NET_ACTIVATIONS:
        raise ValueError(f"activation must be one of {_NET_ACTIVATIONS}")
    require_tensor("float_smallnet x", x, _F32, ndim=4)
    if x.shape[3] != 1:
        raise ValueError(f"float_smallnet: x {tuple(x.shape)} must have one channel")
    for name, t, n in (("c1w", c1w, 4), ("c1b", c1b, 1), ("c2w", c2w, 4), ("c2b", c2b, 1)):
        require_tensor(f"float_smallnet {name}", t, _F32, numel=n)
    require_tensor("float_smallnet dw", dw, _F32, ndim=2)
    _, H, W, _ = x.shape
    K, N = dw.shape
    if K != (H // 4) * (W // 4):
        raise ValueError(f"float_smallnet: dw {tuple(dw.shape)} does not take the "
                         f"{H // 4}x{W // 4} pooled map of {H}x{W} images")
    require_tensor("float_smallnet db", db, _F32, numel=N)


def float_smallnet_plain(x: torch.Tensor, c1w: torch.Tensor, c1b: torch.Tensor,
                         c2w: torch.Tensor, c2b: torch.Tensor, dw: torch.Tensor,
                         db: torch.Tensor, *, activation: str = "sigmoid") -> torch.Tensor:
    """conv + activation + pool twice, flatten, the dense layer, the
    activation: the plain stages composed, as the `ref` ("sigmoid") and
    `plan` ("plan") backends compute them."""
    y = maxpool2d_plain(conv2d_plain(x, c1w.reshape(2, 2, 1, 1), c1b, activation=activation))
    y = maxpool2d_plain(conv2d_plain(y, c2w.reshape(2, 2, 1, 1), c2b, activation=activation))
    scores = y.reshape(y.shape[0], -1) @ dw + db
    return torch.sigmoid(scores) if activation == "sigmoid" else sigmoid_plan_f32(scores)


def float_smallnet(x: torch.Tensor, c1w: torch.Tensor, c1b: torch.Tensor,
                   c2w: torch.Tensor, c2b: torch.Tensor, dw: torch.Tensor,
                   db: torch.Tensor, *, activation: str = "sigmoid") -> torch.Tensor:
    """The whole float smallNet forward: x (B,H,W,1) float32 images, conv
    taps c1w, c2w (the (2,2,1,1) params), conv biases c1b, c2b (1,), dense
    dw ((H/4)(W/4), N) and db (N,) -> (B,N) scores, with one activation
    everywhere: "sigmoid" (the exact one) or "plan".  The kernel takes the
    images `float_smallnet_fits` allows and raises ValueError for any
    other; the plain version takes any."""
    _net_args(x, c1w, c1b, c2w, c2b, dw, db, activation)
    if not on_cuda(x, c1w, c1b, c2w, c2b, dw, db):
        return float_smallnet_plain(x, c1w, c1b, c2w, c2b, dw, db, activation=activation)
    B, H, W, _ = x.shape
    N = dw.shape[1]
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("float_net")
    dev, stream = stream_of(x)
    rc = lib.float_smallnet_launch(dev, x.data_ptr(), c1w.data_ptr(), c1b.data_ptr(),
                                   c2w.data_ptr(), c2b.data_ptr(), dw.data_ptr(),
                                   db.data_ptr(), out.data_ptr(), B, H, W, N,
                                   _ACT_CODE[activation], stream)
    _build.check(lib, rc, f"float_smallnet {H}x{W} images, {N} classes")
    count_launch("float_smallnet")
    return out


# -- one stage of the float frame sweep ---------------------------------------------

def _stage_args(quad, w, b, activation) -> tuple[int, int]:
    """Check a sweep stage's arguments; (h, w) of its maps."""
    if activation not in _NET_ACTIVATIONS:
        raise ValueError(f"activation must be one of {_NET_ACTIVATIONS}")
    if len(quad) != 4:
        raise ValueError(f"float_sweep_stage: expected the quad (I, B, R, C), got "
                         f"{len(quad)} maps")
    for name, m in zip("IBRC", quad):
        require_tensor(f"float_sweep_stage {name}", m, _F32, ndim=4)
    shape = tuple(quad[0].shape)
    if shape[0] != 1 or shape[3] != 1 or any(tuple(m.shape) != shape for m in quad):
        raise ValueError(f"float_sweep_stage: the maps must be one (1,h,w,1) shape, got "
                         f"{[tuple(m.shape) for m in quad]}")
    require_tensor("float_sweep_stage w", w, _F32, numel=4)
    require_tensor("float_sweep_stage b", b, _F32, numel=1)
    h, wd = shape[1], shape[2]
    if h < 2 or wd < 2 or h % 2 or wd % 2:
        raise ValueError(f"float_sweep_stage: {h}x{wd} maps cannot pool 2x2/2 on both "
                         f"axes (even extents of at least 2)")
    return h, wd


def float_sweep_stage_plain(quad, w: torch.Tensor, b: torch.Tensor, *,
                            activation: str = "plan") -> torch.Tensor:
    """The stage of `float_sweep_stage` on the plain float ops: the masked
    convs (`conv2d_plain` with zeroed taps), the activation, the
    pre-activation adds in `streaming/fcn_sweep._sweep_stage`'s association
    order, then the pools.  That order is written out twice in the port,
    here and in `_sweep_stage` (the kernel layer does not import the
    streaming layer): a change to one must be made to the other, and the
    tests hold the two against each other."""
    I, Bm, R, C = quad
    act = torch.sigmoid if activation == "sigmoid" else sigmoid_plan_f32
    w4 = w.reshape(4)
    zb = torch.zeros_like(b)

    def conv(src, mask, bias):
        m = torch.tensor(mask, dtype=w4.dtype, device=w4.device)
        return conv2d_plain(src, (w4 * m).reshape(2, 2, 1, 1), bias)

    s_ii = act(conv(I, _M_ALL, b))
    s_li = act(conv(Bm, _M_TOP, b))
    s_il = act(conv(R, _M_LEFT, b))
    s_ll = act(conv(C, _M_00, b))
    if Bm is I and R is I and C is I:                   # level 0: the collapsed quad
        s_pi = s_ip = s_pp = s_ii
        s_pl, s_lp = s_il, s_li
    else:
        s_pi = act(conv(I, _M_TOP, b) + conv(Bm, _M_BOT, zb))
        s_ip = act(conv(I, _M_LEFT, b) + conv(R, _M_RIGHT, zb))
        s_pp = act(((conv(I, _M_00, b) + conv(R, _M_01, zb)) + conv(Bm, _M_10, zb))
                   + conv(C, _M_11, zb))
        s_pl = act(conv(R, _M_00, b) + conv(C, _M_10, zb))
        s_lp = act(conv(Bm, _M_00, b) + conv(C, _M_01, zb))
    maps = (maxpool2d_plain(s_ii), pool_mix(s_pi, s_li),
            pool_quadrants(s_ip, s_il, s_ip, s_il), pool_quadrants(s_pp, s_pl, s_lp, s_ll))
    return torch.stack([m[0, ..., 0] for m in maps])


def float_sweep_stage(quad, w: torch.Tensor, b: torch.Tensor, *,
                      activation: str = "plan") -> torch.Tensor:
    """One conv -> activation -> pool stage of the float frame sweep in one
    launch.  `quad` is (I, B, R, C), four (1,h,w,1) float32 maps, the same
    tensor four times at level 0 (the frame's pixels are role-independent,
    and the stage collapses as `_sweep_stage` does); w the (2,2,1,1) conv
    taps, b the (1,) bias; `activation` "sigmoid" or "plan".  Returns the
    (4, h/2, w/2) float32 pooled quad [interior, last_row, last_col,
    corner].  h and w must be even and at least 2."""
    h, wd = _stage_args(quad, w, b, activation)
    if not on_cuda(*quad, w, b):
        return float_sweep_stage_plain(quad, w, b, activation=activation)
    I, Bm, R, C = quad
    out = torch.empty((4, h // 2, wd // 2), dtype=torch.float32, device=I.device)
    lib = _build.library("float_sweep")
    dev, stream = stream_of(I)
    rc = lib.float_sweep_stage_launch(dev, I.data_ptr(), Bm.data_ptr(), R.data_ptr(),
                                      C.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      h, wd, int(Bm is I and R is I and C is I),
                                      _ACT_CODE[activation], stream)
    _build.check(lib, rc, f"float_sweep_stage {h}x{wd} maps")
    count_launch("float_sweep_stage")
    return out


# -- the float frame sweep's window head ----------------------------------------------

def _head_args(maps, gy, gx, w, b, activation) -> int:
    """Check the float window head's arguments; k, the window's side on the
    maps."""
    if activation not in _NET_ACTIVATIONS:
        raise ValueError(f"activation must be one of {_NET_ACTIVATIONS}")
    if len(maps) != 4:
        raise ValueError(f"float_window_head: expected 4 role maps, got {len(maps)}")
    for name, m in zip("IBRC", maps):
        require_tensor(f"float_window_head map {name}", m, _F32, ndim=2)
        if m.shape != maps[0].shape:
            raise ValueError(f"float_window_head: map {name} {tuple(m.shape)}, "
                             f"map I {tuple(maps[0].shape)}")
    require_tensor("float_window_head gy", gy, (torch.int32,), ndim=1)
    require_tensor("float_window_head gx", gx, (torch.int32,), numel=gy.shape[0])
    require_tensor("float_window_head w", w, _F32, ndim=2)
    K, N = w.shape
    k = math.isqrt(K)
    if k * k != K or k < 1:
        raise ValueError(f"float_window_head: w {tuple(w.shape)} is not (k*k, N)")
    require_tensor("float_window_head b", b, _F32, numel=N)
    return k


def float_window_head_plain(maps, gy: torch.Tensor, gx: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, *, activation: str = "plan") -> torch.Tensor:
    """The composed head in torch ops: stack the four maps, gather every
    window's features (`window_gather_index`), `@ w + b`, the activation.
    Raises ValueError for a window past the maps."""
    maps = list(maps)
    k = _head_args(maps, gy, gx, w, b, activation)
    h, w_ = maps[0].shape
    if gy.numel() and (int(gy.min()) < 0 or int(gx.min()) < 0 or int(gy.max()) > h - k
                       or int(gx.max()) > w_ - k):
        raise ValueError(f"float_window_head: a window lies outside the {h}x{w_} maps")
    feats = torch.stack(maps).reshape(-1)[window_gather_index(gy, gx, k, (h, w_))]
    scores = feats @ w + b
    return torch.sigmoid(scores) if activation == "sigmoid" else sigmoid_plan_f32(scores)


def float_window_head(maps, gy: torch.Tensor, gx: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, *, activation: str = "plan") -> torch.Tensor:
    """The float frame sweep's window head in one launch: the four (h, w)
    float32 role maps [interior, last_row, last_col, corner], the windows'
    pooled-lattice offsets gy, gx (Nw,) int32, the dense w (k*k, N) and b
    (N,) -> (Nw, N) float32 scores with the activation ("sigmoid" or
    "plan").  Every window must lie inside the maps (gy + k <= h, gx + k
    <= w), as the sweep's positions do: the plain version raises
    ValueError for one that does not, the kernel stops with a CUDA error
    (a trap, as `fixed_window_head`'s does).  The kernel takes N <= 128
    and w within its shared memory (k*k*(N + 128/N) + N floats up to
    12,288) and raises ValueError for any other; the plain version takes
    any.  The kernel sums a score in another order than the plain
    version's matmul: the two agree within rounding."""
    maps = list(maps)
    k = _head_args(maps, gy, gx, w, b, activation)
    if not on_cuda(*maps, gy, gx, w, b):
        return float_window_head_plain(maps, gy, gx, w, b, activation=activation)
    Nw, N = gy.shape[0], w.shape[1]
    out = torch.empty((Nw, N), dtype=torch.float32, device=gy.device)
    if out.numel() == 0:
        return out
    lib = _build.library("float_sweep")
    dev, stream = stream_of(gy)
    mh, mw = maps[0].shape
    rc = lib.float_window_head_launch(dev, *(m.data_ptr() for m in maps), gy.data_ptr(),
                                      gx.data_ptr(), w.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), Nw, mh, mw, k, N,
                                      _ACT_CODE[activation], stream)
    _build.check(lib, rc, f"float_window_head w {tuple(w.shape)} on {mh}x{mw} maps")
    count_launch("float_window_head")
    return out
