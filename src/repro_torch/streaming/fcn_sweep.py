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
`fixed`) where the frame's geometry allows it, else each stage through the
backend's one-launch `sweep_stage` where it has one and the composed
stage elsewhere, and the backend's one-launch `window_head` for the head;
True requires the trunk and raises where there is none (on every float
backend, as in the reference); False forces the composed stages
throughout: the cascade (20 conv, 2 pool and 11 sigmoid launches per
frame on `fixed_cuda`) and the composed head (a stack of the four maps,
one index gather, one dense and one sigmoid launch).  All three give the
same words on the fixed backends; on the float ones `sweep_stage` rounds
as the composed stage does on the card.  On `fixed_cuda` the default
route is 2 launches a frame, `frame_trunk` and `fixed_window_head`.  On
`cuda_plan` and `cuda` it is 3: a `float_sweep_stage` launch a stage and
one `float_window_head` (`csrc/float_sweep.cu`); the composed route on
`cuda_plan` is 20 `conv2d`, 2 `maxpool2d` and 12 `sigmoid_pla` launches a
frame.  `int8` has none of the three hooks and composes: 1 `quant_matmul`
a frame.

The reference jits one program per geometry.  Here `FcnSweep.score`
captures a frame's whole device program once per geometry as a CUDA graph
(`_FrameGraph`: the copy of the frame from a pinned host buffer, the
trunk, the head and the copy of the scores back to a pinned buffer) and
replays it for each later frame, where the call is eligible: the sweep
runs on a CUDA device, `megakernel` is not False, the call sweeps one
(1,H,W,1) frame, the route is all one-launch hooks (`frame_trunk`, or
`sweep_stage` at both levels, then `window_head`), and `prepare_params`
returns the caller's own tensors (native params already on the device).
The rule reads the hooks' results, the frame and the params, nothing
else: `int8`, `ref`, `plan`, CPU tensors, `megakernel=False` and
`fixed_cuda` with float params (quantized on every call) run eagerly, as
every call did before.  The graphs are cached, 8 at most, least recently
used out, by backend, frame (H, W), patch, positions, `megakernel`,
device and the params' storage.  A graph reads the caller's param
storage, so a value written in place shows in the next replay; other
param tensors are another key.  Graph and eager give the same scores bit
for bit.  The registry counter `fcn_sweep_graph` (label `event`:
`capture`, `replay`, `eager`) counts the calls.  `FcnSweep.replay` is the
replay alone, with the same key: None where the call has no cached graph,
for a caller that runs `score` elsewhere then.  Otherwise the sweep is a
plain function on tensors, and only the window offsets and gather
indices are cached, per (geometry, device).  `make_trunk_fn`/`make_head_fn` split the same sweep
into its two halves for `serving/disagg.py`, eagerly: the trunk
(`_trunk_quad`) and the head (`_head_scores`, on the route `_sweep` takes
for the same `megakernel`), so a score from a cached quad is the
monolithic call's word on every route.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Any, ClassVar, Sequence

import numpy as np
import torch

from repro_torch.core import backends as B
from repro_torch.core import smallnet
from repro_torch.core.device import as_device_tensor, resolve_device
from repro_torch.kernels import launches
from repro_torch.kernels._launch import count_launch, recorded_launches
from repro_torch.kernels.frame_trunk.ops import pool_mix as _pool_mix
from repro_torch.kernels.frame_trunk.ops import pool_quadrants as _pool_quadrants
from repro_torch.kernels.quant_matmul.ops import window_gather_index
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
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


def _sweep_stage(be: B.Backend, quad, w, b, phases: T.Phases | None = None):
    """One conv->activation->pool stage over the role-map quad.

    Role bookkeeping: for a patch of side N at this stage, conv output row
    N-2 ("prelast") reads input rows N-2 (interior) and N-1 (last row ->
    the B map); conv output row N-1 ("last") reads input row N-1 (B map)
    and the patch's SAME-padding zeros, realized by masking the bottom
    taps.  The pooled last row then combines the prelast (even) and last
    (odd) conv rows.  Columns are symmetric with the R map; the corner
    walks the same lattice through C.

    `kernels/frame_trunk/ops.frame_trunk_quad_plain` writes out the same
    two stages and association order on plain word ops, and
    `kernels/conv2d/ops.float_sweep_stage_plain` one stage on plain float
    ops (the `float_sweep_stage` kernel's): a change to one must be made
    to the others.

    A traced sweep's `phases` runs "masks" over the eight masked weights
    and "trunk" over the stage's launches.
    """
    I, Bm, R, C = quad
    if phases is not None:
        phases.to("masks")
    zb = torch.zeros_like(b)
    w_top = be.mask_conv_weight(w, _mask(_TOP, _ALL))
    w_bot = be.mask_conv_weight(w, _mask(_BOT, _ALL))
    w_left = be.mask_conv_weight(w, _mask(_ALL, _TOP))
    w_right = be.mask_conv_weight(w, _mask(_ALL, _BOT))
    w_00 = be.mask_conv_weight(w, _mask(_TOP, _TOP))
    w_01 = be.mask_conv_weight(w, _mask(_TOP, _BOT))
    w_10 = be.mask_conv_weight(w, _mask(_BOT, _TOP))
    w_11 = be.mask_conv_weight(w, _mask(_BOT, _BOT))
    if phases is not None:
        phases.to("trunk")

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
                megakernel: bool | None = None, phases: T.Phases | None = None,
                route: list | None = None):
    """Both conv stages of the sweep over one (1,H,W,1) float frame batch:
    the level-2 role-map quad (I, B, R, C), each (1, H/4, W/4) words or
    (1, H/4, W/4, 1) floats.

    `megakernel`: None tries the backend's `frame_trunk`, and where it
    returns None runs each stage through the backend's `sweep_stage` or,
    where that returns None, composed; True requires the trunk (raising
    where there is none); False forces the composed cascade.  `route`,
    where given, gets the steps taken appended: "frame_trunk", or
    "sweep_stage" or "composed" a stage."""
    if megakernel is None or megakernel:
        quad = be.frame_trunk(frames, p)
        if quad is not None:
            if route is not None:
                route.append("frame_trunk")
            return quad
        if megakernel:
            raise NotImplementedError(
                f"backend {be.name!r} has no frame_trunk megakernel for "
                f"frames of shape {tuple(frames.shape)} (the one-launch "
                f"trunk exists on the fixed backends, for single "
                f"multiple-of-4 frames)")
    x = be.ingest(frames)
    quad = (x, x, x, x)      # pixels are role-independent at level 0
    for layer in ("conv1", "conv2"):
        w, b = p[layer]["w"], p[layer]["b"]
        fused = be.sweep_stage(quad, w, b) if megakernel is None else None
        if route is not None:
            route.append("composed" if fused is None else "sweep_stage")
        quad = fused if fused is not None else _sweep_stage(be, quad, w, b, phases)
    return quad


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
                 positions: tuple[tuple[int, int], ...], fused: bool = True,
                 route: list | None = None) -> torch.Tensor:
    """The sweep's dense-head half: role-map quad + window positions ->
    (Nw, 10) backend-native scores.  Each map is squeezed to (H/4, W/4)
    first, words or NHWC floats alike.  With `fused`, a backend's
    `window_head` hook takes the whole head (`fixed_cuda`: one launch that
    reads each window's features straight from the maps); otherwise, and
    on every other backend, the head composes one gather from the stacked
    maps and the dense head (on `fixed_cuda` one dense and one sigmoid
    launch).  Kept apart from the trunk so that a server that splits the
    sweep into trunk and head runs the same words.  `route`, where given,
    gets "window_head" or "composed" appended."""
    maps = [_squeeze_map(m) for m in quad]
    shape, device = tuple(maps[0].shape), maps[0].device
    if fused:
        gy, gx = _window_origins(patch, positions, shape, device)
        scores = be.window_head(maps, gy, gx, p)
        if scores is not None:
            if route is not None:
                route.append("window_head")
            return scores
    if route is not None:
        route.append("composed")
    gather = _window_gather(patch, positions, shape, device)
    feats = torch.stack(maps).reshape(-1)[gather]            # (Nw, k*k)
    return smallnet.dense_head(p, feats, backend=be)


def _sweep(be: B.Backend, params: Any, frame: torch.Tensor, patch: int,
           positions: tuple[tuple[int, int], ...],
           megakernel: bool | None, phases: T.Phases | None = None,
           route: list | None = None) -> torch.Tensor:
    """params + (1,H,W,1) float frame -> (n_windows, 10) scores on the
    frame's device.  A traced sweep's `phases` runs "masks" over the
    params' preparation, "trunk" and "masks" through `_trunk_quad`, and
    "head" over the head.  `route` collects the steps taken, as
    `_trunk_quad` and `_head_scores` name them, after "new_params" where
    `prepare_params` did not return the caller's own tensors."""
    if phases is not None:
        phases.to("masks")
    p = be.prepare_params(params, frame.device)
    if route is not None:
        mine, theirs = B.tree_leaves(p), B.tree_leaves(params)
        if len(mine) != len(theirs) or any(a is not b for a, b in zip(mine, theirs)):
            route.append("new_params")
    if phases is not None:
        phases.to("trunk")
    quad = _trunk_quad(be, p, frame, megakernel, phases, route)
    if phases is not None:
        phases.to("head")
    return _head_scores(be, p, quad, patch, positions, fused=megakernel is not False,
                        route=route)


# -- the frame graph: one geometry's device program, captured once -------------------

_GRAPH_ROUTES = (["frame_trunk", "window_head"], ["sweep_stage", "sweep_stage", "window_head"])
_GRAPHS_MAX = 8                  # geometries kept, least recently used out
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPHS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()


@dataclasses.dataclass
class _FrameGraph:
    """A swept frame's device program as one CUDA graph: the copy of the
    pinned `frame_in` to the card, the trunk, the head and the copy of the
    scores to the pinned `scores_out`.  `launches` are the port's kernels
    in it; `holds` keeps alive what it reads (the params, the windows'
    offsets, its device buffers).  `lock` covers a replay from the copy in
    to the copy out, so two threads never share the staging buffers."""
    graph: Any
    device: torch.device
    frame_in: torch.Tensor
    scores_out: torch.Tensor
    launches: tuple[str, ...]
    holds: tuple
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def replay(self, frame, phases: T.Phases | None = None) -> np.ndarray:
        """One (1,H,W,1) frame (an array, or a tensor on any device) ->
        (n_windows, N) scores, a fresh host array.  The graph runs on the
        caller's current stream.  A traced call's `phases` runs "trunk"
        over the staging copy and the replay, "device_wait" over the
        synchronisation and the copy out."""
        with self.lock:
            if isinstance(frame, torch.Tensor):
                self.frame_in.copy_(frame)
            else:
                np.copyto(self.frame_in.numpy(), frame, casting="unsafe")
            self.graph.replay()
            if phases is not None:
                phases.to("device_wait")
            torch.cuda.current_stream(self.device).synchronize()
            out = self.scores_out.numpy().copy()
        for name in self.launches:
            count_launch(name)
        return out


def _sweep_device(frames, device) -> torch.device:
    """Where the sweep runs: a tensor's own device unless `device` names
    another; a CUDA device with its index."""
    if isinstance(frames, torch.Tensor) and device is None:
        dev = frames.device
    else:
        dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _graph_key(be: B.Backend, params: Any, shape: tuple[int, int], patch: int,
               positions: tuple[tuple[int, int], ...], megakernel: bool | None,
               device: torch.device):
    """The frame graph's cache key; None where a leaf of `params` is not a
    tensor on `device` (then `prepare_params` makes new tensors, and the
    call is not eligible).  `megakernel` is part of it: True raises where
    None takes the stage hooks."""
    leaves = []
    for leaf in B.tree_leaves(params):
        if not isinstance(leaf, torch.Tensor) or leaf.device != device:
            return None
        leaves.append((leaf.data_ptr(), leaf.dtype, tuple(leaf.shape)))
    return be, shape, patch, positions, megakernel, device, tuple(leaves)


def _cached_graph(key) -> _FrameGraph | None:
    with _GRAPHS_LOCK:
        graph = _GRAPHS.get(key)
        if graph is not None:
            _GRAPHS.move_to_end(key)
        return graph


def _capture(key, be: B.Backend, params: Any, patch: int,
             positions: tuple[tuple[int, int], ...], megakernel: bool | None,
             scores: torch.Tensor) -> bool:
    """Capture the frame program of `key`'s geometry and params after an
    eager call that took an all-hook route with the caller's own params
    and gave `scores`, and cache it; False where another thread did so
    first.  A failed capture raises."""
    _, (H, W), _, _, _, device, _ = key
    with _CAPTURE_LOCK:
        if _cached_graph(key) is not None:
            return False
        p = be.prepare_params(params, device)
        frame_in = torch.empty((1, H, W, 1), dtype=torch.float32, pin_memory=True)
        scores_out = torch.empty(tuple(scores.shape), dtype=scores.dtype, pin_memory=True)
        frame = torch.empty((1, H, W, 1), dtype=torch.float32, device=device)
        offsets = _window_origins(patch, positions, (H // _POOL, W // _POOL), device)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with recorded_launches() as names, torch.inference_mode(), \
                torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            frame.copy_(frame_in, non_blocking=True)
            quad = _trunk_quad(be, p, frame, megakernel)
            head = _head_scores(be, p, quad, patch, positions)
            scores_out.copy_(head, non_blocking=True)
        torch.cuda.current_stream(device).wait_stream(stream)
        entry = _FrameGraph(graph, device, frame_in, scores_out, tuple(names),
                            (frame, head, offsets, p, stream))
        with _GRAPHS_LOCK:
            _GRAPHS[key] = entry
            while len(_GRAPHS) > _GRAPHS_MAX:
                _GRAPHS.popitem(last=False)
    return True


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
    on `fixed_cuda`, two `float_sweep_stage` launches and the head on
    `cuda_plan`.  `megakernel` selects the route (see the module note);
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
              device: torch.device | str | None = None,
              parent_span: T.Span | None = None) -> np.ndarray:
        """One full-frame trunk pass + windowed dense head on `device`
        (default "cuda"): (1, H, W, 1) frame -> (n_windows, 10)
        backend-native scores, in `positions` order, a fresh host array.
        An eligible call (the module note) replays the frame graph of its
        geometry and params, capturing it first where there is none yet;
        any other call runs the sweep eagerly.

        With tracing on, the call is one "score" span (under `parent_span`,
        the pipeline's frame, when given), tagged with the csrc `launches`
        it made (exact while one thread launches at a time; a replay counts
        the kernels captured in it) and with `graph` ("capture", "replay"
        or "eager", as the `fcn_sweep_graph` counter), and split into
        children.  Eagerly: "trunk" (the frame's upload and the trunk's
        launches), "masks" (the params' preparation and each composed
        stage's masked weights; only the preparation where a backend's
        `frame_trunk` or `sweep_stage` takes the stages), "head" and
        "device_wait" (the copy back, which waits for the card; the capture
        too, on the call that captures); masks and trunk come in several
        spans a frame.  A replay has no "masks" or "head": "trunk" (the
        staging copy and the replay) and "device_wait" (the
        synchronisation and the copy out)."""
        return self._score(params, frames, backend, device, parent_span, eager=True)

    def replay(self, params: Any, frames, *,
               backend: str | B.Backend = "fixed_cuda",
               device: torch.device | str | None = None,
               parent_span: T.Span | None = None) -> np.ndarray | None:
        """`score` where the call replays a cached frame graph: the same
        scores, "score" span (tagged `graph="replay"`, children "trunk" and
        "device_wait") and `fcn_sweep_graph` event.  None, having run
        nothing, counted nothing and opened no span, where the call is not
        eligible or its geometry and params have no graph yet; `score` then
        runs it.  A replay holds its caller for the copy in, the card's
        ~20 us of work and the copy out, so `StreamingPipeline` calls it on
        its event loop's thread."""
        return self._score(params, frames, backend, device, parent_span, eager=False)

    def _score(self, params: Any, frames, backend, device, parent_span,
               eager: bool) -> np.ndarray | None:
        """`score`, and with `eager` False, `replay`: one key computation
        decides between the cached graph and the eager sweep (None)."""
        tr = T.get()
        t0 = time.perf_counter() if tr is not None else None
        be = B.get_backend(backend)
        _check_saturation(be)
        dev = _sweep_device(frames, device)
        shape = tuple(frames.shape) if hasattr(frames, "shape") else np.shape(frames)
        shape = (1, *shape) if len(shape) == 3 else shape
        key = None
        if (dev.type == "cuda" and self.megakernel is not False and len(shape) == 4
                and shape[0] == 1 and shape[3] == 1):
            key = _graph_key(be, params, shape[1:3], self.patch,
                             tuple(self.positions(shape[1:3])), self.megakernel, dev)
        graph = _cached_graph(key) if key is not None else None
        if graph is None and not eager:
            return None
        ph = None
        if tr is not None:
            n0 = sum(launches().values())
            sp = tr.start("score", parent_span.trace_id if parent_span is not None
                          else "score", parent=parent_span)
            sp.t_start = t0
            ph = T.Phases(tr, sp, "trunk", t0)
        if graph is not None:
            event, out = "replay", graph.replay(frames, ph)
        else:
            event, out = self._eager(be, params, frames, device, key, ph)
        M.REGISTRY.counter("fcn_sweep_graph", event=event).inc()
        if ph is None:
            return out
        t_end = ph.end()
        sp.tags["launches"] = sum(launches().values()) - n0
        sp.tags["graph"] = event
        tr.end_at(sp, t_end)
        return out

    def _eager(self, be: B.Backend, params: Any, frames, device, key,
               ph: T.Phases | None) -> tuple[str, np.ndarray]:
        """The sweep op by op; then, where `key` is given and the call took
        an all-hook route with the caller's own params, the capture of its
        graph.  -> ("capture" or "eager", the scores)."""
        frames = as_device_tensor(frames, device, dtype=torch.float32)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[0] != 1:
            raise ValueError(
                f"FcnSweep.score takes one frame per call (the sweep is a "
                f"per-frame device program), got batch {frames.shape[0]}")
        pos = tuple(self.positions((frames.shape[1], frames.shape[2])))
        route = [] if key is not None else None
        with torch.inference_mode():
            scores = _sweep(be, params, frames, self.patch, pos, self.megakernel, ph, route)
        if ph is not None:
            ph.to("device_wait")
        out = scores.cpu().numpy()
        if key is not None and route in _GRAPH_ROUTES and _capture(
                key, be, params, self.patch, pos, self.megakernel, scores):
            return "capture", out
        return "eager", out

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
