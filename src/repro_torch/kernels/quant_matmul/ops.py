"""The two dense-layer MACs: CUDA kernels and their plain versions.

Port of `repro.kernels.quant_matmul` (`ops.py` wrappers, `kernel.py`,
`ref.py`).  Each wrapper checks its tensors, sends CPU tensors to its
plain version and launches its kernel for CUDA tensors:

  fixed_dense   the Qm.n dense layer (`fixed_matmul_pallas`), kernels in
                `csrc/fixed_dense.cu`; its launcher picks "rows" (four
                threads a row, each holding all N <= 16 sums, the block's
                rows staged in shared memory) or "generic" (one thread per
                output word, for N > 16 or rows too long for the shared
                memory), and `fixed_dense_route` asks it which; the
                reference pads the batch to its Pallas block and budgets
                VMEM, but both kernels mask the ragged last block
                themselves
  fixed_window_head
                the frame sweep's window head in one launch of
                `csrc/fixed_dense.cu` (the rows route's shapes only):
                each window's k x k features read straight from the four
                role maps, the dense layer, the PLAN; its plain version is the composed head (stack the
                maps, gather every window's features, `fixed_dense_plain`,
                the PLAN)
  quant_matmul  int8 x int8 -> exact int32 sum -> float32 dequant
                (`quant_matmul_pallas`), two kernels in
                `csrc/quant_matmul.cu`, picked by `quant_matmul_route`:
                "wgmma" (the int8 tensor cores, TMA-fed) where K % 16 ==
                N % 4 == 0, "dp4a" (the CUDA cores) elsewhere; the
                reference pads every extent to its (bm, bn, bk) blocks, a
                TPU tiling: both kernels read zeros past the edges
                themselves, so no padded copy is made
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (count_launch, on_cuda, require_tensor,
                                         require_words, stream_of)


def fixed_dense_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """(M,K) @ (K,N) + b with the MAC-array semantics, in torch ops."""
    return fxp.fixed_add(fxp.fixed_matmul(x, w, cfg), b.reshape(1, -1), cfg)


def fixed_dense_route(K: int, N: int) -> str:
    """The kernel a CUDA `fixed_dense` call of (K, N) takes, as its launcher
    decides it (the library is built on first use): "rows" where a thread
    can hold the row's N <= 16 sums and the block's rows fit the shared
    memory (K up to about 700), "generic" elsewhere."""
    return "rows" if _build.library("fixed_dense").fixed_dense_rows_route(K, N) else "generic"


def fixed_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                *, cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """Fixed-point dense layer: x (M,K), w (K,N), b (N,) or None, all int32
    Qm.n words -> (M,N) int32, on the kernel `fixed_dense_route` names."""
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
                                out.data_ptr(), M, K, N, _build.fixed_cfg(cfg), stream)
    _build.check(lib, rc, "fixed_dense")
    count_launch("fixed_dense")
    return out


def window_gather_index(gy: torch.Tensor, gx: torch.Tensor, k: int,
                        map_shape: tuple[int, int]) -> torch.Tensor:
    """Flat indices, into the stacked (4, h, w) role-map quad, of each
    window's k x k features: (Nw, k*k) int64 on gy's device.  Feature (i, j)
    of the window at pooled offset (gy, gx) comes from map is_last_row(i) +
    2 * is_last_col(j) (interior, last_row, last_col, corner) at (gy+i,
    gx+j)."""
    h, w = map_shape
    off = torch.arange(k, device=gy.device)
    last = (off == k - 1).long()
    role = last[:, None] + 2 * last[None, :]                      # (k, k)
    rows = gy.long()[:, None, None] + off[None, :, None]          # (Nw, k, 1)
    cols = gx.long()[:, None, None] + off[None, None, :]          # (Nw, 1, k)
    idx = role[None] * (h * w) + rows * w + cols                  # (Nw, k, k)
    return idx.reshape(gy.shape[0], k * k)


def _window_head_args(quad, gy, gx, w, b):
    """Check the window head's arguments; -> (the four maps, k, N)."""
    maps = list(quad)
    if len(maps) != 4:
        raise ValueError(f"fixed_window_head: expected 4 role maps, got {len(maps)}")
    for name, m in zip(("I", "B", "R", "C"), maps):
        require_words(f"fixed_window_head map {name}", m, ndim=2)
        if m.shape != maps[0].shape:
            raise ValueError(f"fixed_window_head: map {name} {tuple(m.shape)}, "
                             f"map I {tuple(maps[0].shape)}")
    require_words("fixed_window_head gy", gy, ndim=1)
    require_words("fixed_window_head gx", gx, numel=gy.shape[0])
    require_words("fixed_window_head w", w, ndim=2)
    K, N = w.shape
    k = math.isqrt(K)
    if k * k != K or k < 1:
        raise ValueError(f"fixed_window_head: w {tuple(w.shape)} is not (k*k, N)")
    require_words("fixed_window_head b", b, numel=N)
    return maps, k, N


def fixed_window_head_plain(quad, gy: torch.Tensor, gx: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, *,
                            cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """The composed head in torch ops: stack the four maps, gather every
    window's features, the dense layer, the PLAN.  Raises ValueError for a
    window past the maps."""
    maps, k, _ = _window_head_args(quad, gy, gx, w, b)
    h, w_ = maps[0].shape
    if gy.numel() and (int(gy.min()) < 0 or int(gx.min()) < 0 or int(gy.max()) > h - k
                       or int(gx.max()) > w_ - k):
        raise ValueError(f"fixed_window_head: a window lies outside the {h}x{w_} maps")
    idx = window_gather_index(gy, gx, k, tuple(maps[0].shape))
    feats = torch.stack(maps).reshape(-1)[idx]                    # (Nw, k*k)
    return fxp.fixed_sigmoid_plan(fixed_dense_plain(feats, w, b, cfg=cfg), cfg)


def fixed_window_head(quad, gy: torch.Tensor, gx: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, *,
                      cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """The frame sweep's window head: the role-map quad (a (4, h, w) int32
    tensor, or its four (h, w) maps [interior, last_row, last_col, corner]),
    the windows' pooled-lattice offsets gy, gx (Nw,) int32, the dense w
    (k*k, N) and b (N,) -> (Nw, N) PLAN'd score words.  The kernel takes
    the rows route's shapes (`fixed_dense_route(k*k, N) == "rows"`: N <=
    16), and raises ValueError for any other.  Every window must lie
    inside the maps (gy + k <= h, gx + k <= w), as the sweep's positions
    do: the plain version raises ValueError for one that does not, the
    kernel stops with a CUDA error (a trap, as a device-side
    assert), which poisons the CUDA context like any such fault."""
    maps, k, N = _window_head_args(quad, gy, gx, w, b)
    if not on_cuda(*maps, gy, gx, w, b):
        return fixed_window_head_plain(maps, gy, gx, w, b, cfg=cfg)
    Nw = gy.shape[0]
    out = torch.empty((Nw, N), dtype=torch.int32, device=gy.device)
    if out.numel() == 0:
        return out
    lib = _build.library("fixed_dense")
    dev, stream = stream_of(gy)
    mh, mw = maps[0].shape
    rc = lib.fixed_window_head_launch(dev, *(m.data_ptr() for m in maps), gy.data_ptr(),
                                      gx.data_ptr(), w.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), Nw, mh, mw, k, N,
                                      _build.fixed_cfg(cfg), stream)
    _build.check(lib, rc, f"fixed_window_head w {tuple(w.shape)}")
    count_launch("fixed_window_head")
    return out


def _scales(s, n: int, device: torch.device) -> torch.Tensor:
    """A scalar or (n,) scale -> a contiguous (n,) float32 tensor on `device`."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(-1)
    if s.numel() not in (1, n):
        raise ValueError(f"quant_matmul: expected a scalar or {n} scales, got {s.numel()}")
    return s.expand(n).contiguous()


def quant_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, sx=1.0,
                       sw=1.0) -> torch.Tensor:
    """(xq @ wq) * sx[:, None] * sw[None, :] in PyTorch ops.  The int8
    products are summed in float64, where every partial sum is an integer
    below 2**53 and so exact: the same int32 a wraparound-free int32
    accumulation gives (|sum| < 2**31 for K < 2**17).  Float64 because
    PyTorch has no integer matmul on CUDA."""
    M, N = xq.shape[0], wq.shape[1]
    acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)
    return (acc.to(torch.float32) * _scales(sx, M, xq.device)[:, None]
            * _scales(sw, N, xq.device)[None, :])


def quant_matmul_route(xq: torch.Tensor, wq: torch.Tensor) -> str:
    """The kernel a CUDA call takes.  "wgmma" where TMA can describe xq
    and the K-major copy of wq (a row stride of K bytes, a multiple of 16,
    and a 16-byte aligned xq) and the transpose kernel can move wq in
    4-byte words (N % 4 == 0, a 4-byte aligned wq).  "dp4a" elsewhere (the
    dense layer's K = 49 and N = 10), where a call is launch-bound and
    needs no copy of wq."""
    K, N = wq.shape
    aligned = xq.data_ptr() % 16 == 0 and wq.data_ptr() % 4 == 0
    return "wgmma" if K % 16 == 0 and N % 4 == 0 and aligned else "dp4a"


def transpose_wq(wq: torch.Tensor) -> torch.Tensor:
    """The (N, K) K-major copy of a CUDA int8 wq (K, N), K % 4 == N % 4 ==
    0: `wgmma` takes s8 operands only K-major.  The transpose kernel of
    `csrc/quant_matmul.cu`, one launch of the wgmma route's two."""
    K, N = wq.shape
    wt = torch.empty((N, K), dtype=torch.int8, device=wq.device)
    lib = _build.library("quant_matmul")
    dev, stream = stream_of(wq)
    rc = lib.quant_matmul_transpose_launch(dev, wq.data_ptr(), wt.data_ptr(), K, N, stream)
    _build.check(lib, rc, "quant_matmul (transpose)")
    return wt


def quant_matmul(xq: torch.Tensor, wq: torch.Tensor, sx=1.0, sw=1.0) -> torch.Tensor:
    """Dequantized float32 (xq @ wq) * sx[:, None] * sw[None, :]: xq (M,K)
    int8, wq (K,N) int8, sx a scalar or (M,), sw a scalar or (N,) -> (M,N)."""
    require_tensor("quant_matmul xq", xq, (torch.int8,), ndim=2)
    require_tensor("quant_matmul wq", wq, (torch.int8,), ndim=2)
    M, K = xq.shape
    if wq.shape[0] != K:
        raise ValueError(f"quant_matmul: xq {tuple(xq.shape)} @ wq {tuple(wq.shape)}")
    if K >= 2 ** 17:
        raise ValueError(f"quant_matmul: K={K} could overflow the int32 sum")
    N = wq.shape[1]
    if not on_cuda(xq, wq):
        return quant_matmul_plain(xq, wq, sx, sw)
    sx, sw = _scales(sx, M, xq.device), _scales(sw, N, xq.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if out.numel() == 0:
        return out
    lib = _build.library("quant_matmul")
    dev, stream = stream_of(xq)
    if quant_matmul_route(xq, wq) == "wgmma":
        wt = transpose_wq(wq)
        rc = lib.quant_matmul_wgmma_launch(dev, xq.data_ptr(), wt.data_ptr(),
                                           sx.data_ptr(), sw.data_ptr(),
                                           out.data_ptr(), M, K, N, stream)
    else:
        if -(-M // 64) >= 2 ** 16:
            raise ValueError(f"quant_matmul: M={M} exceeds the dp4a kernel's grid")
        rc = lib.quant_matmul_dp4a_launch(dev, xq.data_ptr(), wq.data_ptr(),
                                          sx.data_ptr(), sw.data_ptr(),
                                          out.data_ptr(), M, K, N, stream)
    _build.check(lib, rc, "quant_matmul")
    count_launch("quant_matmul")
    return out
