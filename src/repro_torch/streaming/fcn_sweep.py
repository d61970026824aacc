"""Fully-convolutional frame sweep: the conv trunk ONCE per frame.

Port of `repro.streaming.fcn_sweep`.  `Tiler` re-convolves overlapping
pixels up to 4x and extracts every 28x28 window on the host; this module
instead runs smallNet's conv->sigmoid->pool->conv->sigmoid->pool trunk over
the WHOLE HxW frame on the device, then scores every 28x28 window by
reading its 7x7 block of the pooled feature maps and applying the 49->10
dense head: one head launch on `fixed_cuda` instead of N host-extracted
patches.

Exactness contract: patch-wise scoring SAME-pads each 28x28 window (0
before, 1 after), so a window's last-row/-col features are computed
against ZEROS even when real pixels lie below or right of it.  The sweep
therefore tracks FOUR role maps per stage (the "quad cascade"):

    I  value at a patch position when it is interior (not last row/col)
    B  value when the position is in the patch's last ROW
    R  value when it is in the patch's last COLUMN
    C  value when it is the bottom-right corner

The edge maps are computed frame-wide with MASKED WEIGHTS (a zeroed tap
contributes exactly 0, which is what the patch's padding contributes), and
maps that mix sources are decomposed into per-source masked convs
recombined with `Backend.accumulate` (wraparound fixed-point addition is
associative mod 2**bits).  Window scores are therefore WORD-EXACT against
`Tiler.extract` + `score` on the fixed backends, border windows included;
on the float and int8 backends, whose maps are NHWC (1,h,w,1) floats, the
decomposition reorders float sums, so they agree within rounding.

Edge/geometry contract (validated loudly):

  * window positions sit on the pooled lattice: `stride` and `patch` are
    multiples of 4 and (H - patch) % 4 == 0 on both axes, so the
    edge-clamped last window of `tile_positions` is gatherable;
  * saturating fixed-point configs are rejected (saturation is not
    associative).

Routes (`megakernel`): None uses the backend's one-launch `frame_trunk`
(the `csrc/frame_trunk.cu` kernel on `fixed_cuda`, its plain version on
`fixed`) where the frame's geometry allows it and the composed cascade
elsewhere, and the backend's one-launch `window_head` for the head; True
requires the trunk and raises where there is none; False forces the
composed stages throughout: the cascade (20 conv, 2 pool and 11 sigmoid
launches per frame on `fixed_cuda`) and the composed head (a stack of the
four maps, one index gather, one dense and one sigmoid launch).  All three
give the same words.  On `fixed_cuda` the default route is 2 launches a
frame, `frame_trunk` and `fixed_window_head`.  The float and int8 backends
have no `frame_trunk` or `window_head` and always run the composed stages:
per frame 20 `conv2d`, 2 `maxpool2d` and 12 `sigmoid_pla` launches on
`cuda_plan` (no `sigmoid_pla` on `cuda`), 1 `quant_matmul` on `int8`.

The reference jits one program per geometry; here the sweep is a plain
function on tensors, and only the window offsets and gather indices are
cached, per (geometry, device).  `make_trunk_fn`/`make_head_fn` split the
same sweep into its two halves for `serving/disagg.py`: the trunk
(`_trunk_quad`) and the head (`_head_scores`, on the route `_sweep` takes
for the same `megakernel`), so a score from a cached quad is the
monolithic call's word on every route.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, ClassVar, Sequence

import numpy as np
import torch

from repro_torch.core import backends as B
from repro_torch.core import smallnet
from repro_torch.core.device import as_device_tensor
from repro_torch.kernels.frame_trunk.ops import pool_mix as _pool_mix
from repro_torch.kernels.frame_trunk.ops import pool_quadrants as _pool_quadrants
from repro_torch.kernels.quant_matmul.ops import window_gather_index
from repro_torch.streaming.sources import Frame
from repro_torch.streaming.tiler import Tiler, tile_positions

_POOL = 4          # two 2x2/2 pools: pooled-map granularity in frame pixels
MAPS = ("interior", "last_row", "last_col", "corner")


def _mask(rows, cols) -> np.ndarray:
    """(2,2) 0/1 tap mask from per-axis keep flags."""
    return np.asarray(rows, np.int32)[:, None] * np.asarray(cols, np.int32)[None, :]


# tap masks: keep (row0|row1) x (col0|col1) of the 2x2 kernel
_TOP, _BOT = (1, 0), (0, 1)
_ALL = (1, 1)


def _sweep_stage(be: B.Backend, quad, w, b):
    """One conv->activation->pool stage over the role-map quad.

    Role bookkeeping: for a patch of side N at this stage, conv output row
    N-2 ("prelast") reads input rows N-2 (interior) and N-1 (last row ->
    the B map); conv output row N-1 ("last") reads input row N-1 (B map)
    and the patch's SAME-padding zeros, realized by masking the bottom
    taps.  The pooled last row then combines the prelast (even) and last
    (odd) conv rows.  Columns are symmetric with the R map; the corner
    walks the same lattice through C.

    `kernels/frame_trunk/ops.frame_trunk_quad_plain` writes out the same
    two stages and association order on plain word ops: a change to one
    must be made to the other.
    """
    I, Bm, R, C = quad
    zb = torch.zeros_like(b)
    w_top = be.mask_conv_weight(w, _mask(_TOP, _ALL))
    w_bot = be.mask_conv_weight(w, _mask(_BOT, _ALL))
    w_left = be.mask_conv_weight(w, _mask(_ALL, _TOP))
    w_right = be.mask_conv_weight(w, _mask(_ALL, _BOT))
    w_00 = be.mask_conv_weight(w, _mask(_TOP, _TOP))
    w_01 = be.mask_conv_weight(w, _mask(_TOP, _BOT))
    w_10 = be.mask_conv_weight(w, _mask(_BOT, _TOP))
    w_11 = be.mask_conv_weight(w, _mask(_BOT, _BOT))

    # single-source role maps: one fused conv+activation launch each
    s_ii = be.fused_conv_act(I, w, b)                    # all taps interior
    s_li = be.sigmoid(be.conv2x2_same(Bm, w_top, b))     # last row
    s_il = be.sigmoid(be.conv2x2_same(R, w_left, b))     # last col
    s_ll = be.sigmoid(be.conv2x2_same(C, w_00, b))       # corner
    if Bm is I and R is I and C is I:
        # level 0: pixels are role-independent, so every mixed-source map
        # collapses onto a single-source one (the masks partition the full
        # kernel over one source) — 4 conv launches instead of 13
        s_pi = s_ip = s_pp = s_ii
        s_pl, s_lp = s_il, s_li
    else:
        # mixed-source maps: masked partial convs recombined pre-activation
        s_pi = be.sigmoid(be.accumulate(                 # prelast row
            be.conv2x2_same(I, w_top, b), be.conv2x2_same(Bm, w_bot, zb)))
        s_ip = be.sigmoid(be.accumulate(                 # prelast col
            be.conv2x2_same(I, w_left, b), be.conv2x2_same(R, w_right, zb)))
        s_pp = be.sigmoid(be.accumulate(be.accumulate(be.accumulate(
            be.conv2x2_same(I, w_00, b),                 # prelast/prelast
            be.conv2x2_same(R, w_01, zb)),
            be.conv2x2_same(Bm, w_10, zb)),
            be.conv2x2_same(C, w_11, zb)))
        s_pl = be.sigmoid(be.accumulate(                 # prelast row, last col
            be.conv2x2_same(R, w_00, b), be.conv2x2_same(C, w_10, zb)))
        s_lp = be.sigmoid(be.accumulate(                 # last row, prelast col
            be.conv2x2_same(Bm, w_00, b), be.conv2x2_same(C, w_01, zb)))

    return (be.maxpool2x2(s_ii),                         # interior
            _pool_mix(s_pi, s_li),                       # last pooled row
            _pool_quadrants(s_ip, s_il, s_ip, s_il),     # last pooled col
            _pool_quadrants(s_pp, s_pl, s_lp, s_ll))     # pooled corner


def _trunk_quad(be: B.Backend, p: dict, frames: torch.Tensor,
                megakernel: bool | None = None):
    """Both conv stages of the sweep over one (1,H,W,1) float frame batch:
    the level-2 role-map quad (I, B, R, C), each (1, H/4, W/4) words or
    (1, H/4, W/4, 1) floats.

    `megakernel`: None tries the backend's `frame_trunk` and runs the
    composed cascade where it returns None; True requires it (raising where
    there is none); False forces the composed cascade."""
    if megakernel is None or megakernel:
        quad = be.frame_trunk(frames, p)
        if quad is not None:
            return quad
        if megakernel:
            raise NotImplementedError(
                f"backend {be.name!r} has no frame_trunk megakernel for "
                f"frames of shape {tuple(frames.shape)} (the one-launch "
                f"trunk exists on the fixed backends, for single "
                f"multiple-of-4 frames)")
    x = be.ingest(frames)
    quad = (x, x, x, x)      # pixels are role-independent at level 0
    quad = _sweep_stage(be, quad, p["conv1"]["w"], p["conv1"]["b"])
    return _sweep_stage(be, quad, p["conv2"]["w"], p["conv2"]["b"])


def _check_saturation(be: B.Backend) -> None:
    cfg = getattr(be, "cfg", None)
    if cfg is not None and getattr(cfg, "saturate", False):
        raise NotImplementedError(
            "FcnSweep requires a wraparound fixed-point config: saturating "
            "addition is not associative, so the sweep's decomposed edge-map "
            "accumulation could drift from the patch-wise words.  The "
            "registered 'fixed'/'fixed_cuda' backends use wraparound mode.")


def _origins(positions: tuple[tuple[int, int], ...]) -> tuple[list[int], list[int]]:
    """The windows' offsets on the pooled lattice: (gy, gx) lists."""
    return [y // _POOL for y, _ in positions], [x // _POOL for _, x in positions]


@functools.lru_cache(maxsize=64)
def _window_origins(patch: int, positions: tuple[tuple[int, int], ...],
                    map_shape: tuple[int, int],
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The windows' pooled-lattice offsets, (gy, gx) int32 (Nw,) each on
    `device`, for the one-launch head; every window lies inside the maps."""
    k = patch // _POOL
    gy, gx = _origins(positions)
    h, w = map_shape
    if positions and (min(gy + gx) < 0 or max(gy) + k > h or max(gx) + k > w):
        raise ValueError(f"a window of {positions} lies outside the {h}x{w} pooled maps")
    return (torch.tensor(gy, dtype=torch.int32, device=device),
            torch.tensor(gx, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=64)
def _window_gather(patch: int, positions: tuple[tuple[int, int], ...],
                   map_shape: tuple[int, int], device: torch.device) -> torch.Tensor:
    """Gather indices for scoring `positions` from the stacked (4, h, w)
    role-map quad, flattened: (Nw, k*k) int64 on `device`
    (`window_gather_index`: feature (i, j) of a window, k = patch/4, comes
    from map `is_last_row(i) + 2 * is_last_col(j)`, at the window's
    pooled-lattice offset)."""
    gy, gx = (torch.tensor(v, dtype=torch.int64) for v in _origins(positions))
    return window_gather_index(gy, gx, patch // _POOL, map_shape).to(device)


def _squeeze_map(x: torch.Tensor) -> torch.Tensor:
    """(1,H,W) fixed words or (1,H,W,1) float NHWC -> (H,W)."""
    return x[0, ..., 0] if x.ndim == 4 else x[0]


def _head_scores(be: B.Backend, p: dict, quad, patch: int,
                 positions: tuple[tuple[int, int], ...], fused: bool = True) -> torch.Tensor:
    """The sweep's dense-head half: role-map quad + window positions ->
    (Nw, 10) backend-native scores.  Each map is squeezed to (H/4, W/4)
    first, words or NHWC floats alike.  With `fused`, a backend's
    `window_head` hook takes the whole head (`fixed_cuda`: one launch that
    reads each window's features straight from the maps); otherwise, and
    on every other backend, the head composes one gather from the stacked
    maps and the dense head (on `fixed_cuda` one dense and one sigmoid
    launch).  Kept apart from the trunk so that a server that splits the
    sweep into trunk and head runs the same words."""
    maps = [_squeeze_map(m) for m in quad]
    shape, device = tuple(maps[0].shape), maps[0].device
    if fused:
        gy, gx = _window_origins(patch, positions, shape, device)
        scores = be.window_head(maps, gy, gx, p)
        if scores is not None:
            return scores
    gather = _window_gather(patch, positions, shape, device)
    feats = torch.stack(maps).reshape(-1)[gather]            # (Nw, k*k)
    return smallnet.dense_head(p, feats, backend=be)


def _sweep(be: B.Backend, params: Any, frame: torch.Tensor, patch: int,
           positions: tuple[tuple[int, int], ...],
           megakernel: bool | None) -> torch.Tensor:
    """params + (1,H,W,1) float frame -> (n_windows, 10) scores on the
    frame's device."""
    p = be.prepare_params(params, frame.device)
    quad = _trunk_quad(be, p, frame, megakernel)
    return _head_scores(be, p, quad, patch, positions, fused=megakernel is not False)


@functools.lru_cache(maxsize=32)
def make_trunk_fn(backend: str | B.Backend, megakernel: bool | None = None):
    """The TRUNK half of the sweep for a backend: (params, (1,H,W,1) float
    frame tensor) -> the level-2 role-map quad (I, B, R, C) in the
    backend's native domain, on the frame's device.  This is the heavy
    per-frame stage the disaggregated server (`serving/disagg.py`) runs on
    its trunk pool and caches per frame digest; `make_head_fn` scores
    windows from the result.  `megakernel` routes as in `_trunk_quad`.
    Inference mode is thread-local, so the function sets it itself: the
    server's replicas call it on threads of their own."""
    be = B.get_backend(backend)
    _check_saturation(be)

    def run(params, frames: torch.Tensor):
        with torch.inference_mode():
            return _trunk_quad(be, be.prepare_params(params, frames.device), frames,
                               megakernel)

    return run


@functools.lru_cache(maxsize=64)
def make_head_fn(backend: str | B.Backend, patch: int,
                 positions: tuple[tuple[int, int], ...],
                 megakernel: bool | None = None):
    """The HEAD half of the sweep: (params, role-map quad) -> (Nw, 10)
    backend-native window scores for a fixed window lattice, on the
    quad's device.  It runs `_head_scores` on the route `_sweep` takes for
    the same `megakernel` (the one-launch window head unless it is False),
    so head-pool scores from a cached quad are the monolithic sweep's
    words on every route.  The reference's head takes no route: there
    both heads are one XLA program."""
    be = B.get_backend(backend)
    _check_saturation(be)
    fused = megakernel is not False

    def run(params, quad):
        with torch.inference_mode():
            return _head_scores(be, be.prepare_params(params, quad[0].device), quad,
                                patch, positions, fused=fused)

    return run


def sweep_feature_maps(params: Any, frame, *,
                       backend: str | B.Backend = "fixed_cuda",
                       megakernel: bool | None = None,
                       device: torch.device | str | None = None) -> dict:
    """The level-2 role-map quad for one (H,W[,1]) frame: a dict of
    (H/4, W/4) numpy maps {"interior", "last_row", "last_col", "corner"}
    in the backend's native domain (int32 words on the fixed backends,
    float32 on the others).  This is the sweep trunk without the dense
    head — what the golden vectors freeze.  The frame goes to `device` (default "cuda")
    unless it is a tensor already; `megakernel` as in `_trunk_quad`."""
    be = B.get_backend(backend)
    _check_saturation(be)
    f = as_device_tensor(frame, device, dtype=torch.float32)
    if f.ndim == 2:
        f = f[..., None]
    with torch.inference_mode():
        quad = _trunk_quad(be, be.prepare_params(params, f.device), f[None],
                           megakernel)
    return {n: _squeeze_map(m).cpu().numpy() for n, m in zip(MAPS, quad)}


@dataclasses.dataclass(frozen=True)
class FcnSweep(Tiler):
    """Drop-in `Tiler` that scores windows from one full-frame trunk pass.

    Same knobs and aggregation semantics as `Tiler`; `stride` must be a
    multiple of 4 (pooled-map granularity) and defaults to 8.  `extract`
    returns the frame itself as a (1,H,W,1) "tile" batch (the mass gate
    computes per-window means from it), and `score` runs the sweep on the
    caller's device: one `frame_trunk` launch and one head launch per frame
    on `fixed_cuda`.  `megakernel` selects the route (see the module note);
    it changes launches per frame, not scores.
    """
    stride: int = 8
    megakernel: bool | None = None
    sweep: ClassVar[bool] = True

    def __post_init__(self):
        if self.patch % _POOL:
            raise ValueError(
                f"FcnSweep patch must be a multiple of {_POOL} "
                f"(two 2x2/2 pools), got {self.patch}")
        if self.stride % _POOL:
            raise ValueError(
                f"FcnSweep stride must be a multiple of {_POOL}: window "
                f"positions live on the pooled-map lattice (got "
                f"{self.stride})")

    def positions(self, frame_shape: tuple[int, int]) -> list[tuple[int, int]]:
        H, W = frame_shape
        if (H - self.patch) % _POOL or (W - self.patch) % _POOL:
            raise ValueError(
                f"frame {frame_shape} breaks the sweep edge contract: the "
                f"edge-clamped last window at (H-{self.patch}, W-"
                f"{self.patch}) must sit on the stride-{_POOL} pooled "
                f"lattice, i.e. (H - patch) % {_POOL} == 0 on both axes "
                f"(pad or crop the frame to a multiple of {_POOL})")
        return tile_positions(frame_shape, self.patch, self.stride)

    def extract(self, frame: Frame | np.ndarray) -> tuple[np.ndarray,
                                                          list[tuple[int, int]]]:
        """Frame -> ((1, H, W, 1) float32 frame batch, window positions).
        No host-side patch materialization — that is the whole point."""
        px = frame.pixels if isinstance(frame, Frame) else np.asarray(frame)
        if px.ndim == 2:
            px = px[..., None]
        pos = self.positions(px.shape[:2])
        return np.ascontiguousarray(px[None], np.float32), pos

    def score(self, params: Any, frames, *,
              backend: str | B.Backend = "fixed_cuda",
              device: torch.device | str | None = None) -> np.ndarray:
        """One full-frame trunk pass + windowed dense head on `device`
        (default "cuda"): (1, H, W, 1) frame -> (n_windows, 10)
        backend-native scores, in `positions` order."""
        be = B.get_backend(backend)
        _check_saturation(be)
        frames = as_device_tensor(frames, device, dtype=torch.float32)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] != 1:
            raise ValueError(
                f"FcnSweep.score takes one frame per call (the sweep is a "
                f"per-frame device program), got batch {frames.shape[0]}")
        pos = tuple(self.positions((frames.shape[1], frames.shape[2])))
        with torch.inference_mode():
            scores = _sweep(be, params, frames, self.patch, pos, self.megakernel)
        return scores.cpu().numpy()

    def _masses(self, tiles: np.ndarray,
                positions: Sequence[tuple[int, int]]) -> np.ndarray:
        """Per-window mean pixel intensity from the frame itself: one
        strided-view gather (same elements in the same row-major reduction
        order as `Tiler`'s per-tile means)."""
        frame = np.asarray(tiles, np.float32)[0, ..., 0]
        p = self.patch
        wins = np.lib.stride_tricks.sliding_window_view(frame, (p, p))
        ys = np.fromiter((y for y, _ in positions), np.intp)
        xs = np.fromiter((x for _, x in positions), np.intp)
        return wins[ys, xs].mean(axis=(-2, -1), dtype=np.float32)
