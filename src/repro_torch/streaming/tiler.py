"""Sliding-window tiler: full frames -> 28x28 patches -> detections.

Port of `repro.streaming.tiler`.  The classifier only ever sees 28x28; a
frame is swept by a window at a configurable stride, every patch is scored
in ONE batched `smallnet.apply` call on the caller's device, and per-patch
scores aggregate into a confidence grid from which thresholded,
deduplicated detections with frame coordinates are extracted.

Patch extraction is host-side numpy, which re-convolves overlapping pixels
up to 4x — the baseline path.  `streaming/fcn_sweep.FcnSweep` is the
drop-in alternative that runs the conv trunk ONCE over the whole frame and
scores every window from the pooled feature map, word-exact with this
tiler on the fixed backends.

Determinism contract: integer score words become float32 confidences as
the reference's `from_fixed` makes them (`words.float() / scale`, a float32
division), so identical words give identical floats give identical
detections, on any device and in either package.  Float scores (the float
and int8 backends) are confidences already and pass through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Sequence

import numpy as np
import torch

from repro_torch.core import backends as B
from repro_torch.core import fixed_point as fxp
from repro_torch.core import smallnet
from repro_torch.streaming.sources import Frame


@dataclasses.dataclass(frozen=True)
class Detection:
    """One deduplicated hit: class label + the winning patch's frame coords."""
    label: int
    score: float
    y: int                           # top-left of the 28x28 patch
    x: int
    size: int = 28

    @property
    def center(self) -> tuple[float, float]:
        return (self.y + self.size / 2, self.x + self.size / 2)


def tile_positions(frame_shape: tuple[int, int], patch: int,
                   stride: int) -> list[tuple[int, int]]:
    """Top-left (y, x) of every window; the last row/col is clamped to the
    frame edge so coverage is complete even when stride doesn't divide."""
    H, W = frame_shape
    if H < patch or W < patch:
        raise ValueError(f"frame {frame_shape} smaller than patch {patch}")
    ys = list(range(0, H - patch, stride)) + [H - patch]
    xs = list(range(0, W - patch, stride)) + [W - patch]
    return [(y, x) for y in ys for x in xs]


@dataclasses.dataclass(frozen=True)
class Tiler:
    """Window extraction + score aggregation for one (patch, stride) sweep.

    `threshold` is on the backend's sigmoid confidence in (0, 1);
    `min_dist` is the Chebyshev distance (px) at or under which two hits are
    the same object (defaults to one stride — adjacent windows over one
    digit collapse to the strongest).  `min_mass` > 0 additionally gates
    windows on mean pixel intensity (off by default).  `cfg` is the word
    format of integer scores.
    """
    patch: int = 28
    stride: int = 14
    threshold: float = 0.9
    min_dist: int = 14
    min_mass: float = 0.0
    cfg: fxp.FixedPointConfig = fxp.Q16_16

    # subclasses that score from a full-frame sweep instead of host-extracted
    # patches (streaming/fcn_sweep.FcnSweep) flip this; the pipeline routes
    # the per-frame device call accordingly
    sweep: ClassVar[bool] = False

    def positions(self, frame_shape: tuple[int, int]) -> list[tuple[int, int]]:
        return tile_positions(frame_shape, self.patch, self.stride)

    def extract(self, frame: Frame | np.ndarray) -> tuple[np.ndarray,
                                                          list[tuple[int, int]]]:
        """Frame -> (N, patch, patch, 1) float32 tile batch + positions."""
        px = frame.pixels if isinstance(frame, Frame) else np.asarray(frame)
        if px.ndim == 2:
            px = px[..., None]
        pos = self.positions(px.shape[:2])
        p = self.patch
        tiles = np.stack([px[y:y + p, x:x + p] for y, x in pos])
        return np.ascontiguousarray(tiles, np.float32), pos

    def score(self, params: Any, tiles: np.ndarray, *,
              backend: str | B.Backend = "fixed_cuda",
              device: torch.device | str | None = None) -> np.ndarray:
        """One batched forward over every tile on `device` (default "cuda"):
        (N, patch, patch, 1) -> (N, 10) backend-native class scores."""
        with torch.inference_mode():
            scores = smallnet.apply(params, tiles, backend=backend, device=device)
        return scores.cpu().numpy()

    def _confidences(self, scores: np.ndarray) -> np.ndarray:
        """Backend-native (N, 10) scores -> float32 sigmoid confidences."""
        scores = np.asarray(scores)
        if np.issubdtype(scores.dtype, np.integer):
            scores = fxp.from_fixed(torch.as_tensor(scores), self.cfg).numpy()
        return scores

    def confidence_grid(self, scores: np.ndarray,
                        positions: Sequence[tuple[int, int]]) -> np.ndarray:
        """(N, 10) scores -> (n_rows, n_cols) map of per-window max
        confidence, in sweep order.  Only a full rectangular sweep has a
        grid: a position list that is not one raises."""
        conf = self._confidences(scores).max(axis=-1)
        n_rows = len({y for y, _ in positions})
        n_cols = len({x for _, x in positions})
        if n_rows * n_cols != len(positions):
            raise ValueError(
                f"confidence_grid needs a full rectangular position grid: "
                f"{len(positions)} positions cannot tile "
                f"{n_rows} rows x {n_cols} cols")
        return conf.reshape(n_rows, n_cols)

    def _masses(self, tiles: np.ndarray,
                positions: Sequence[tuple[int, int]]) -> np.ndarray:
        """Per-window mean pixel intensity for the `min_mass` gate.  Here
        `tiles` is the (N, patch, patch, 1) batch; the FCN sweep overrides
        this to compute the same means from the frame itself."""
        return np.asarray(tiles, np.float32).reshape(len(tiles), -1).mean(1)

    def aggregate(self, scores: np.ndarray,
                  positions: Sequence[tuple[int, int]],
                  tiles: np.ndarray | None = None) -> list[Detection]:
        """Threshold + greedy dedup: strongest window wins, any window whose
        top-left is within `min_dist` (Chebyshev, INCLUSIVE) of an accepted
        detection is suppressed regardless of label.  Ties break on (y, x)
        so the result is a pure function of the score words.  Pass `tiles`
        to apply the `min_mass` foreground gate."""
        conf = self._confidences(scores)
        labels = conf.argmax(axis=-1)
        best = conf.max(axis=-1)
        if self.min_mass > 0.0 and tiles is not None:
            mass = self._masses(tiles, positions)
            best = np.where(mass >= self.min_mass, best, -1.0)
        hits = [(float(best[i]), positions[i][0], positions[i][1],
                 int(labels[i]))
                for i in range(len(positions)) if best[i] >= self.threshold]
        hits.sort(key=lambda h: (-h[0], h[1], h[2]))
        out: list[Detection] = []
        for s, y, x, lab in hits:
            if any(max(abs(y - d.y), abs(x - d.x)) <= self.min_dist
                   for d in out):
                continue
            out.append(Detection(label=lab, score=s, y=y, x=x,
                                 size=self.patch))
        return out

    def detect(self, params: Any, frame: Frame | np.ndarray, *,
               backend: str | B.Backend = "fixed_cuda",
               device: torch.device | str | None = None) -> list[Detection]:
        """The offline (non-pipelined) path: extract -> score -> aggregate.
        The pipeline must produce exactly this for every frame it serves."""
        tiles, pos = self.extract(frame)
        return self.aggregate(
            self.score(params, tiles, backend=backend, device=device), pos, tiles)
