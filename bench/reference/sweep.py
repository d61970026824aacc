"""Plain NumPy reference of the frame sweep: every 28x28 window of a frame
scored by the whole net on its own crop, then thresholded and deduplicated.

A window's crop is SAME-padded by the net as any 28x28 image is, so its
last row and column see zeros even where real pixels lie beyond it.  The
detections are the greedy deduplication of the windows whose top
confidence reaches the threshold: the strongest first (ties by y, then x),
each suppressing every later hit whose top-left corner lies within
`min_dist` pixels (Chebyshev, inclusive), whatever its label.

Imports nothing but NumPy and the reference net beside it.
"""
from __future__ import annotations

import numpy as np

from bench.reference import smallnet as ref

BLOCK = 2048            # windows scored at once, so a camera frame fits in memory


def positions(frame_shape: tuple[int, int], patch: int, stride: int) -> list[tuple[int, int]]:
    """Top-left (y, x) of every window: stride steps, then one window
    clamped to the frame's last row and column."""
    H, W = frame_shape
    ys = list(range(0, H - patch, stride)) + [H - patch]
    xs = list(range(0, W - patch, stride)) + [W - patch]
    return [(y, x) for y in ys for x in xs]


def window_scores(frame: np.ndarray, pos: list[tuple[int, int]], score_fn,
                  patch: int = ref.PATCH) -> np.ndarray:
    """(H,W[,1]) frame -> (Nw, 10) scores, `score_fn(crops)` over blocks of
    (n, patch, patch) crops."""
    f = np.asarray(frame, np.float32).reshape(frame.shape[0], frame.shape[1])
    views = np.lib.stride_tricks.sliding_window_view(f, (patch, patch))
    ys = np.asarray([y for y, _ in pos])
    xs = np.asarray([x for _, x in pos])
    out = []
    for s in range(0, len(pos), BLOCK):
        out.append(score_fn(np.ascontiguousarray(views[ys[s:s + BLOCK], xs[s:s + BLOCK]])))
    return np.concatenate(out)


def confidences(scores: np.ndarray, fmt: ref.Format | None) -> np.ndarray:
    """Score words -> float32 confidences (word / 2^frac_bits, a float32
    division); float scores are confidences already."""
    scores = np.asarray(scores)
    if fmt is None:
        return scores.astype(np.float32)
    return scores.astype(np.float32) / np.float32(fmt.scale)


def detections(conf: np.ndarray, pos: list[tuple[int, int]], threshold: float,
               min_dist: int) -> list[tuple[int, float, int, int]]:
    """(Nw, 10) confidences -> [(label, score, y, x)] in acceptance order."""
    labels = np.argmax(conf, axis=-1)
    best = conf.max(axis=-1)
    hits = sorted(((float(best[i]), pos[i][0], pos[i][1], int(labels[i]))
                   for i in np.flatnonzero(best >= np.float32(threshold))),
                  key=lambda h: (-h[0], h[1], h[2]))
    out: list[tuple[int, float, int, int]] = []
    for score, y, x, label in hits:
        if all(max(abs(y - oy), abs(x - ox)) > min_dist for _, _, oy, ox in out):
            out.append((label, score, y, x))
    return out


def percentile_threshold(conf: np.ndarray, q: float) -> float:
    """The q-th percentile of the windows' top confidences, taken as one of
    them (the lower neighbour), so it is a float32 value exactly."""
    top = np.sort(conf.max(axis=-1))
    return float(top[int(np.floor(q / 100.0 * (len(top) - 1)))])
