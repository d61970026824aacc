"""Procedural 28x28 grayscale digit dataset (offline MNIST proxy).

A copy of `repro.data.synth_mnist` for the PyTorch port (which imports nothing
from `repro`); keep the two in step.

The container has no network access and no MNIST copy, so we render digits
procedurally: a 5x7 seven-segment-style glyph per class, upscaled to 20x20,
placed on a 28x28 canvas with random translation, per-stroke intensity
jitter, gaussian blur-ish smoothing and background noise.  The task is the
same 10-class grayscale 28x28 classification problem; EXPERIMENTS.md labels
every accuracy number as "MNIST-proxy".
"""
from __future__ import annotations

import numpy as np

_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph_array(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]], np.float32)


def _smooth(img: np.ndarray) -> np.ndarray:
    """3x3 box blur (cheap anti-aliasing, makes strokes MNIST-soft)."""
    p = np.pad(img, 1)
    return (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] +
            p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:] +
            p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0


def make_dataset(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (n,28,28,1) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.zeros((n, 28, 28), np.float32)
    for i, d in enumerate(labels):
        g = _glyph_array(int(d))
        # upscale 5x7 -> 15x21/20x24 via per-axis kron (never crop the glyph)
        sy = rng.integers(3, 4)             # 3 rows/cell -> 21 px tall
        sx = rng.integers(3, 5)             # 3-4 cols/cell -> 15-20 px wide
        big = np.kron(g, np.ones((sy, sx), np.float32))
        h, w = big.shape
        big = big * rng.uniform(0.8, 1.0)   # intensity jitter
        dy = rng.integers(0, 28 - h + 1)
        dx = rng.integers(0, 28 - w + 1)
        canvas = np.zeros((28, 28), np.float32)
        canvas[dy:dy + h, dx:dx + w] = big
        canvas = _smooth(canvas)
        canvas += rng.normal(0, 0.03, (28, 28)).astype(np.float32)
        imgs[i] = np.clip(canvas, 0.0, 1.0)
    return imgs[..., None], labels


def batches(images: np.ndarray, labels: np.ndarray, batch_size: int,
            seed: int = 0, epochs: int = 1):
    """Deterministic shuffled minibatch iterator."""
    n = images.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        idx = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            sel = idx[s:s + batch_size]
            yield images[sel], labels[sel]
