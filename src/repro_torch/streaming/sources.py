"""Frame sources: the streaming analogue of `data/synth_mnist`.

Port of `repro.streaming.sources` (numpy only, as there; the port keeps its
own copy because it imports nothing from `repro`).  `SyntheticVideoSource`
renders the synth_mnist digit glyphs drifting, scaling and bouncing across
an HxW canvas (112x112 by default), with the ground-truth track of every
object recorded per frame; for the same seed and `frame_shape` a clip is
the reference's clip, pixel for pixel, truth for truth.  `PacedPlayer`
replays any source at a target FPS on the asyncio clock, which is what
makes deadline misses and queue drops in the pipeline real rather than
simulated.

Determinism contract: a source is seeded and every iteration replays the
identical clip (fresh rng per `__iter__`), so a "frozen clip" is just a
(source, seed) pair.  `RepeatedClipSource` comes with the disaggregated
serving path.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Iterator, Protocol, runtime_checkable

import numpy as np

from repro_torch.data.synth_mnist import _glyph_array, _smooth

# glyph cell grid is 7 rows x 5 cols; cell scales cycle through this ladder
# (kron upscale factors), giving digit heights 14..28 px — every scale fits
# inside one 28x28 classifier patch
_SCALE_LADDER = (2, 3, 4, 3)


@dataclasses.dataclass
class TrackBox:
    """Ground truth for one object in one frame: label + pixel bbox."""
    label: int
    y: int                         # top-left corner, frame coords
    x: int
    h: int
    w: int

    @property
    def center(self) -> tuple[float, float]:
        return (self.y + self.h / 2, self.x + self.w / 2)


@dataclasses.dataclass
class Frame:
    index: int
    pixels: np.ndarray             # (H, W, 1) float32 in [0, 1]
    truth: list[TrackBox]
    t_source: float = 0.0          # perf_counter at player emit (0 = unpaced)


@runtime_checkable
class FrameSource(Protocol):
    """Anything that replays a finite clip of `Frame`s deterministically."""

    frame_shape: tuple[int, int]

    def __iter__(self) -> Iterator[Frame]: ...

    def __len__(self) -> int: ...


@dataclasses.dataclass
class _Object:
    label: int
    y: float
    x: float
    vy: float
    vx: float
    intensity: float
    scale_phase: int
    scale_period: int


class SyntheticVideoSource:
    """Seeded procedural video: digits drifting/scaling over a noisy canvas.

    Each object is a synth_mnist glyph with a constant-velocity track that
    reflects off the frame edges and a kron-upscale factor cycling through
    `_SCALE_LADDER` (the "approaching/receding" motion).  Per-frame ground
    truth (`Frame.truth`) carries every object's label and bbox, so
    detection quality is measurable, not just eyeballed.
    """

    def __init__(self, *, n_frames: int = 50, frame_shape=(112, 112),
                 n_objects: int = 2, seed: int = 0, noise: float = 0.03,
                 max_speed: float = 3.0):
        if min(frame_shape) < 7 * max(_SCALE_LADDER):
            raise ValueError(f"frame_shape {frame_shape} cannot hold a digit "
                             f"at max scale {max(_SCALE_LADDER)}")
        self.n_frames = int(n_frames)
        self.frame_shape = (int(frame_shape[0]), int(frame_shape[1]))
        self.n_objects = int(n_objects)
        self.seed = int(seed)
        self.noise = float(noise)
        self.max_speed = float(max_speed)

    def __len__(self) -> int:
        return self.n_frames

    def _spawn(self, rng: np.random.Generator) -> list[_Object]:
        H, W = self.frame_shape
        objs = []
        for _ in range(self.n_objects):
            hmax, wmax = 7 * max(_SCALE_LADDER), 5 * max(_SCALE_LADDER)
            objs.append(_Object(
                label=int(rng.integers(0, 10)),
                y=float(rng.uniform(0, H - hmax)),
                x=float(rng.uniform(0, W - wmax)),
                vy=float(rng.uniform(-self.max_speed, self.max_speed)),
                vx=float(rng.uniform(-self.max_speed, self.max_speed)),
                intensity=float(rng.uniform(0.8, 1.0)),
                scale_phase=int(rng.integers(0, len(_SCALE_LADDER))),
                scale_period=int(rng.integers(6, 12)),
            ))
        return objs

    def __iter__(self) -> Iterator[Frame]:
        rng = np.random.default_rng(self.seed)     # fresh rng: replayable clip
        objs = self._spawn(rng)
        H, W = self.frame_shape
        for t in range(self.n_frames):
            canvas = np.zeros((H, W), np.float32)
            truth: list[TrackBox] = []
            for o in objs:
                s = _SCALE_LADDER[(o.scale_phase + t // o.scale_period)
                                  % len(_SCALE_LADDER)]
                glyph = np.kron(_glyph_array(o.label),
                                np.ones((s, s), np.float32)) * o.intensity
                gh, gw = glyph.shape
                # reflect the track off the edges for THIS scale
                y = int(round(min(max(o.y, 0.0), H - gh)))
                x = int(round(min(max(o.x, 0.0), W - gw)))
                canvas[y:y + gh, x:x + gw] = np.maximum(
                    canvas[y:y + gh, x:x + gw], glyph)
                truth.append(TrackBox(label=o.label, y=y, x=x, h=gh, w=gw))
                o.y += o.vy
                o.x += o.vx
                if o.y < 0 or o.y > H - gh:
                    o.vy = -o.vy
                    o.y = min(max(o.y, 0.0), float(H - gh))
                if o.x < 0 or o.x > W - gw:
                    o.vx = -o.vx
                    o.x = min(max(o.x, 0.0), float(W - gw))
            canvas = _smooth(canvas)
            canvas += rng.normal(0, self.noise, (H, W)).astype(np.float32)
            yield Frame(index=t,
                        pixels=np.clip(canvas, 0.0, 1.0)[..., None],
                        truth=truth)

    def frames(self) -> list[Frame]:
        """Materialize the whole clip (the frozen-clip view for tests)."""
        return list(self)


class PacedPlayer:
    """Replay a `FrameSource` at a target FPS on the asyncio clock.

    `fps=None` (or 0) emits as fast as the consumer pulls — the
    "too-fast camera" mode the backpressure tests use.  Emission times are
    scheduled against the clip start (frame i at t0 + i/fps), so a slow
    consumer does NOT slow the camera down; frames just arrive late and the
    pipeline's deadline/drop machinery deals with them, exactly like a
    real sensor DMA.
    """

    def __init__(self, source: FrameSource, fps: float | None = None):
        self.source = source
        self.fps = float(fps) if fps else None
        self.frame_shape = source.frame_shape

    def __len__(self) -> int:
        return len(self.source)

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        t0 = time.perf_counter()
        for i, frame in enumerate(self.source):
            if self.fps is not None:
                delay = (t0 + i / self.fps) - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
            frame.t_source = time.perf_counter()
            yield frame
