"""Whole-frame trunk: smallNet's conv->PLAN->pool->conv->PLAN->pool over one
frame, with the sweep's quad role maps, in ONE CUDA launch.

Port of `repro.kernels.frame_trunk` (`ops.py` wrapper and tile chooser,
`kernel.py` Pallas kernel, `ref.py` numpy oracle).

  frame_trunk_quad        (H, W) int32 words -> (4, H/4, W/4) int32 quad
                          [interior, last_row, last_col, corner].  A CPU
                          tensor goes to `frame_trunk_quad_plain`; a CUDA
                          tensor launches `csrc/frame_trunk.cu` or raises.
  frame_trunk_quad_plain  the untiled PyTorch port of the numpy int64
                          oracle (`frame_trunk/ref.py`): one whole-frame
                          computation from the plain conv, PLAN and add
                          word ops.  It knows nothing of tiles, halos or
                          frame-edge masking, which is what makes it a
                          check on the kernel.
  choose_tile             the kernel's (th, tw) tile for a frame

Geometry contract (`check_frame_geometry`, the reference's): H % 4 ==
W % 4 == 0 and at least 4x4.  Saturating configs are rejected: the trunk's
masked partial convs are recombined with wraparound adds, which are
associative only without saturation.

Tile choice for Hopper.  The reference sizes tiles to a 14 MB TPU VMEM
budget.  Here one block computes one (th, tw) tile and keeps in dynamic
shared memory

    (th+3)(tw+4)              the input tile plus its bottom/right halo,
                              a row padded to whole 16-byte vectors
  + 4 (th/2+1)(tw/2+1)        the level-1 quad with its pooled halo row/col

int32 words (`frame_trunk_smem_bytes`), up to the 227 KB a block may opt
in to (`SMEM_MAX`); level-0 words and level-1 role words live in
registers.  The frame's work is spread over the SMs by blocks, so
`choose_tile` takes, among the tiles that divide the frame on the pooled
lattice (multiples of 4), fit `SMEM_MAX` and give every SM a block where
the frame has that many tiles, the least

    ceil(blocks / 132) * (n1 + 2 n2 + staged / 16)

(132 = the H100's SMs; the SM with the most blocks sets the time; n1
level-1 positions with halo, each 16 products and 9 PLAN words; n2
level-2 positions, each 36 products and 16 PLAN words, about twice a
level-1 position; staged input words, a 16-byte load per four), ties to
the larger tile, then the squarer, then the taller.  Larger tiles
recompute less halo, smaller ones balance the SMs better.  So 112x112
runs as 392 tiles of 4x8, 512x512 as 256 of 32x32 and 1080x1920 as 648
of 40x80.  An explicit `tile` must be multiples of 4 that divide the
frame and fit `SMEM_MAX` (a 112x112 tile needs about 103 KB and is taken;
a 168x168 one needs about 228 KB and is refused).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import _build
from repro_torch.kernels._launch import count_launch, on_cuda, require_words, stream_of
from repro_torch.kernels.fixed_conv.ops import fixed_conv2d_plain

HALO = 3                       # input rows/cols of bottom/right apron per tile
N_SM = 132                     # H100 SXM streaming multiprocessors
SMEM_MAX = 227 * 1024          # dynamic shared memory a block may opt in to

# tap masks over the row-major (4,) kernel, as in frame_trunk/ref.py
_M_ALL = (1, 1, 1, 1)
_M_TOP = (1, 1, 0, 0)          # keep kernel row 0
_M_BOT = (0, 0, 1, 1)
_M_LEFT = (1, 0, 1, 0)         # keep kernel col 0
_M_RIGHT = (0, 1, 0, 1)
_M_00 = (1, 0, 0, 0)
_M_01 = (0, 1, 0, 0)
_M_10 = (0, 0, 1, 0)
_M_11 = (0, 0, 0, 1)


def pool_mix(e: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """2x2/2 pool over (B,H,W) maps whose even input rows come from `e` and
    odd rows from `o`.  Pure comparisons: exact in every word format."""
    return torch.maximum(torch.maximum(e[:, ::2, ::2], e[:, ::2, 1::2]),
                         torch.maximum(o[:, 1::2, ::2], o[:, 1::2, 1::2]))


def pool_quadrants(tl, tr, bl, br) -> torch.Tensor:
    """2x2/2 pool with a distinct source map per window quadrant:
    (2r,2c) from tl, (2r,2c+1) from tr, (2r+1,2c) from bl, (2r+1,2c+1)
    from br."""
    return torch.maximum(torch.maximum(tl[:, ::2, ::2], tr[:, ::2, 1::2]),
                         torch.maximum(bl[:, 1::2, ::2], br[:, 1::2, 1::2]))


def check_frame_geometry(H: int, W: int) -> None:
    """The pooled-lattice contract every trunk entry point shares."""
    if H < 4 or W < 4:
        raise ValueError(
            f"frame {H}x{W} is too small to tile: the trunk pools 4x in "
            f"each dim, so frames must be at least 4x4")
    if H % 4 or W % 4:
        raise ValueError(
            f"frame {H}x{W} breaks the pooled-lattice contract: two 2x2/2 "
            f"pools need H % 4 == W % 4 == 0 (pad or crop the frame)")


def _check_wraparound(cfg: fxp.FixedPointConfig) -> None:
    if cfg.saturate:
        raise NotImplementedError(
            "frame_trunk requires a wraparound fixed-point config: "
            "saturating addition is not associative, so the megakernel's "
            "decomposed masked-conv accumulation could drift from the "
            "composed words (same contract as FcnSweep)")


def frame_trunk_smem_bytes(th: int, tw: int) -> int:
    """Shared memory of one (th, tw) tile's block (see the module note)."""
    return 4 * ((th + HALO) * (tw + 4) + 4 * (th // 2 + 1) * (tw // 2 + 1))


def _tile_cost(H: int, W: int, th: int, tw: int) -> float:
    """The chooser's estimate of the busiest SM's work (module note)."""
    blocks = (H // th) * (W // tw)
    n1 = (th // 2 + 1) * (tw // 2 + 1)
    n2 = (th // 4) * (tw // 4)
    return -(-blocks // N_SM) * (n1 + 2 * n2 + (th + HALO) * (tw + 4) / 16)


def _tile_candidates(n: int) -> list[int]:
    """Divisors of n that are multiples of 4, largest first."""
    return [d for d in range(n, 3, -1) if n % d == 0 and d % 4 == 0]


@functools.lru_cache(maxsize=64)
def choose_tile(H: int, W: int) -> tuple[int, int]:
    """The (th, tw) tile of an (H, W) frame, by the rule in the module
    note.  Deterministic, and cached: the scan costs milliseconds of host
    time at camera sizes, more than the launch.  A 4x4 tile (368 bytes)
    always fits."""
    check_frame_geometry(H, W)
    want = min(N_SM, (H // 4) * (W // 4))
    fits = [(th, tw) for th in _tile_candidates(H) for tw in _tile_candidates(W)
            if frame_trunk_smem_bytes(th, tw) <= SMEM_MAX
            and (H // th) * (W // tw) >= want]
    return min(fits, key=lambda t: (_tile_cost(H, W, *t), -t[0] * t[1],
                                    abs(t[0] - t[1]), -t[0]))


def _check_tile(tile: tuple[int, int], H: int, W: int) -> tuple[int, int]:
    th, tw = tile
    if th % 4 or tw % 4 or th < 4 or tw < 4 or H % th or W % tw:
        raise ValueError(
            f"tile {th}x{tw} must be multiples of 4 dividing the "
            f"{H}x{W} frame")
    if frame_trunk_smem_bytes(th, tw) > SMEM_MAX:
        raise ValueError(
            f"tile {th}x{tw} needs {frame_trunk_smem_bytes(th, tw)} B of "
            f"shared memory; the kernel's block may opt in to at most {SMEM_MAX} B")
    return th, tw


# -- the plain PyTorch version -------------------------------------------------

def frame_trunk_quad_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor, *,
                           cfg: fxp.FixedPointConfig = fxp.Q16_16) -> torch.Tensor:
    """x (H, W) int32 words; w1/w2 (4,) or (2,2,1,1) row-major taps; b1/b2
    (1,) bias words.  Returns the (4, H/4, W/4) int32 level-2 quad
    [interior, last_row, last_col, corner], computed untiled over the whole
    frame with `_sweep_stage`'s association order.  That order is written
    out twice in the port, here and in `streaming/fcn_sweep._sweep_stage`
    (the kernel layer does not import the streaming layer): a change to
    one must be made to the other, and the tests hold the two against
    each other and against the reference."""
    _check_wraparound(cfg)
    dev = x.device
    x = x[None]                                          # (1, H, W)
    w1, w2 = w1.reshape(4), w2.reshape(4)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)

    def conv(src, w, mask, bias):
        m = torch.tensor(mask, dtype=torch.int32, device=dev)
        return fixed_conv2d_plain(src, w * m, bias, cfg=cfg)

    def plan(y):
        return fxp.fixed_sigmoid_plan(y, cfg)

    def add(a, b):
        return fxp.fixed_add(a, b, cfg)

    # level 0: role-independent pixels, collapsed quad
    s_ii = plan(conv(x, w1, _M_ALL, b1))
    s_li = plan(conv(x, w1, _M_TOP, b1))
    s_il = plan(conv(x, w1, _M_LEFT, b1))
    s_ll = plan(conv(x, w1, _M_00, b1))
    I1 = pool_mix(s_ii, s_ii)
    B1 = pool_mix(s_ii, s_li)
    R1 = pool_quadrants(s_ii, s_il, s_ii, s_il)
    C1 = pool_quadrants(s_ii, s_il, s_li, s_ll)

    # level 1: full mixed-source stage, _sweep_stage's association order
    s_ii2 = plan(conv(I1, w2, _M_ALL, b2))
    s_li2 = plan(conv(B1, w2, _M_TOP, b2))
    s_il2 = plan(conv(R1, w2, _M_LEFT, b2))
    s_ll2 = plan(conv(C1, w2, _M_00, b2))
    s_pi2 = plan(add(conv(I1, w2, _M_TOP, b2), conv(B1, w2, _M_BOT, zero)))
    s_ip2 = plan(add(conv(I1, w2, _M_LEFT, b2), conv(R1, w2, _M_RIGHT, zero)))
    s_pp2 = plan(add(add(add(conv(I1, w2, _M_00, b2),
                             conv(R1, w2, _M_01, zero)),
                         conv(B1, w2, _M_10, zero)),
                     conv(C1, w2, _M_11, zero)))
    s_pl2 = plan(add(conv(R1, w2, _M_00, b2), conv(C1, w2, _M_10, zero)))
    s_lp2 = plan(add(conv(B1, w2, _M_00, b2), conv(C1, w2, _M_01, zero)))

    return torch.cat([
        pool_mix(s_ii2, s_ii2),
        pool_mix(s_pi2, s_li2),
        pool_quadrants(s_ip2, s_il2, s_ip2, s_il2),
        pool_quadrants(s_pp2, s_pl2, s_lp2, s_ll2),
    ])


# -- the wrapper -----------------------------------------------------------------

def frame_trunk_quad(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, *,
                     cfg: fxp.FixedPointConfig = fxp.Q16_16,
                     tile: tuple[int, int] | None = None) -> torch.Tensor:
    """Both trunk stages over one (H, W) int32 word frame in ONE launch:
    the (4, H/4, W/4) int32 quad [interior, last_row, last_col, corner].
    w1/w2 are the (2,2,1,1) or (4,) int32 conv taps, b1/b2 the (1,) bias
    words.  `tile=None` picks the tile with `choose_tile`; an explicit
    (th, tw) must be multiples of 4 dividing the frame (tests force small
    tiles to cross seams).  The plain version is untiled, so on a CPU
    tensor the tile is checked and has no other effect."""
    require_words("frame_trunk x", x, ndim=2)
    require_words("frame_trunk w1", w1, numel=4)
    require_words("frame_trunk b1", b1, numel=1)
    require_words("frame_trunk w2", w2, numel=4)
    require_words("frame_trunk b2", b2, numel=1)
    w1, w2 = w1.reshape(4), w2.reshape(4)
    H, W = x.shape
    check_frame_geometry(H, W)
    _check_wraparound(cfg)
    th, tw = choose_tile(H, W) if tile is None else _check_tile(tile, H, W)
    if not on_cuda(x, w1, b1, w2, b2):
        return frame_trunk_quad_plain(x, w1, b1, w2, b2, cfg=cfg)
    out = torch.empty((4, H // 4, W // 4), dtype=torch.int32, device=x.device)
    lib = _build.library("frame_trunk")
    dev, stream = stream_of(x)
    rc = lib.frame_trunk_launch(dev, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                H, W, th, tw, _build.fixed_cfg(cfg), stream)
    _build.check(lib, rc, "frame_trunk_quad")
    count_launch("frame_trunk")
    return out
