"""Seeded inputs: 28x28 digit images and synthetic video frames.

Frozen copies of the program's generators (`streaming/loadgen.py`
`LoadGen.image`, `streaming/sources.py` `SyntheticVideoSource`,
`data/synth_mnist.py` `_glyph_array` and `_smooth`): equal arguments give
the same images and frames byte for byte, and a later change of the
program cannot change the benchmark's inputs.  NumPy only.
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

# a digit's cell grid is 7 x 5; its kron scale cycles through this ladder
SCALE_LADDER = (2, 3, 4, 3)


def glyph(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]], np.float32)


def smooth(img: np.ndarray) -> np.ndarray:
    """3x3 box blur."""
    p = np.pad(img, 1)
    return (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] +
            p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:] +
            p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0


def digit_image(seed: int, uid: int, label: int) -> np.ndarray:
    """The (28, 28, 1) float32 image of request `uid` showing `label`:
    an upscaled glyph, jittered in place and intensity, smoothed, with
    noise (`LoadGen.image`)."""
    rng = np.random.default_rng([seed, 0x1A6E, uid])
    g = glyph(label)
    sy = rng.integers(3, 4)
    sx = rng.integers(3, 5)
    big = np.kron(g, np.ones((sy, sx), np.float32))
    h, w = big.shape
    big = big * rng.uniform(0.8, 1.0)
    dy = rng.integers(0, 28 - h + 1)
    dx = rng.integers(0, 28 - w + 1)
    canvas = np.zeros((28, 28), np.float32)
    canvas[dy:dy + h, dx:dx + w] = big
    canvas = smooth(canvas)
    canvas += rng.normal(0, 0.03, (28, 28)).astype(np.float32)
    return np.clip(canvas, 0.0, 1.0)[..., None]


def video_frames(n_frames: int, frame_shape: tuple[int, int], *, seed: int,
                 n_objects: int = 2, noise: float = 0.03,
                 max_speed: float = 3.0) -> list[np.ndarray]:
    """The first `n_frames` (H, W, 1) float32 frames of a clip of digits
    drifting, scaling and bouncing off the edges (`SyntheticVideoSource`)."""
    H, W = frame_shape
    rng = np.random.default_rng(seed)
    objs = []
    for _ in range(n_objects):
        hmax, wmax = 7 * max(SCALE_LADDER), 5 * max(SCALE_LADDER)
        objs.append(dict(
            label=int(rng.integers(0, 10)),
            y=float(rng.uniform(0, H - hmax)), x=float(rng.uniform(0, W - wmax)),
            vy=float(rng.uniform(-max_speed, max_speed)),
            vx=float(rng.uniform(-max_speed, max_speed)),
            intensity=float(rng.uniform(0.8, 1.0)),
            scale_phase=int(rng.integers(0, len(SCALE_LADDER))),
            scale_period=int(rng.integers(6, 12))))
    frames = []
    for t in range(n_frames):
        canvas = np.zeros((H, W), np.float32)
        for o in objs:
            s = SCALE_LADDER[(o["scale_phase"] + t // o["scale_period"]) % len(SCALE_LADDER)]
            g = np.kron(glyph(o["label"]), np.ones((s, s), np.float32)) * o["intensity"]
            gh, gw = g.shape
            y = int(round(min(max(o["y"], 0.0), H - gh)))
            x = int(round(min(max(o["x"], 0.0), W - gw)))
            canvas[y:y + gh, x:x + gw] = np.maximum(canvas[y:y + gh, x:x + gw], g)
            o["y"] += o["vy"]
            o["x"] += o["vx"]
            if o["y"] < 0 or o["y"] > H - gh:
                o["vy"] = -o["vy"]
                o["y"] = min(max(o["y"], 0.0), float(H - gh))
            if o["x"] < 0 or o["x"] > W - gw:
                o["vx"] = -o["vx"]
                o["x"] = min(max(o["x"], 0.0), float(W - gw))
        canvas = smooth(canvas)
        canvas += rng.normal(0, noise, (H, W)).astype(np.float32)
        frames.append(np.clip(canvas, 0.0, 1.0)[..., None])
    return frames
