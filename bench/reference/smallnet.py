"""Plain NumPy reference of smallNet, the paper's net (cs.AR 2025, §III-A).

conv 2x2 SAME (0 before, 1 after, as Keras pads an even kernel) -> bias ->
PLAN sigmoid -> maxpool 2x2, twice; flatten the 7x7 map row-major; dense
49 -> 10 -> bias -> PLAN sigmoid; the Max Finder takes the first of the
largest scores.

Two datapaths, each written out from the paper's definitions:

* Qm.n words (`net_words`): two's-complement words of `total_bits` with
  `frac_bits` fraction bits.  Every product is the exact 64-bit product
  shifted right by `frac_bits` (round-to-nearest adds bit frac_bits-1 of
  it), wrapped to 32 bits and then to `total_bits`; a MAC sums the
  products, wraps the sum to 32 bits and to `total_bits`, then adds the
  bias with a 32-bit wrap; the PLAN sigmoid is shifts and adds.
* float (`net_float`): the same graph in float32 with the float PLAN
  sigmoid (each affine piece a multiply, then an add, each rounded on its
  own).  `rounding` rounds after every operation; the default keeps
  float32, `to_bf16` emulates bfloat16 arithmetic (the lower-precision
  control of a float32 configuration).

This module imports nothing but NumPy: no `jax`, no JAX package, nothing
of the program under test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PATCH = 28
CLASSES = 10


@dataclasses.dataclass(frozen=True)
class Format:
    """A wraparound Qm.n format: 1 sign bit, `frac_bits` fraction bits."""
    total_bits: int = 32
    frac_bits: int = 16
    round_nearest: bool = True

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_int(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.total_bits - 1))


Q16_16 = Format(32, 16)
Q8_8 = Format(16, 8)


def format_of(spec: dict) -> Format:
    """A configuration's `format` entry -> Format; saturating formats are
    not part of any configuration here and are refused."""
    if spec.get("saturate", False):
        raise ValueError("the reference implements the wraparound formats only")
    return Format(int(spec["total_bits"]), int(spec["frac_bits"]),
                  bool(spec.get("round_nearest", True)))


# -- Qm.n words ---------------------------------------------------------------

def wrap(x: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement wrap of int64 values to `bits`, sign-extended."""
    half = np.int64(1) << np.int64(bits - 1)
    mask = (np.int64(1) << np.int64(bits)) - np.int64(1)
    return ((np.asarray(x, np.int64) + half) & mask) - half


def to_words(x, fmt: Format) -> np.ndarray:
    """Reals -> words: x * 2^frac_bits rounded half to even in float32,
    clipped to the format's range (NaN -> 0)."""
    scaled = np.round(np.asarray(x, np.float32) * np.float32(fmt.scale))
    scaled = np.nan_to_num(scaled, nan=0.0)
    scaled = np.clip(scaled.astype(np.float64), fmt.min_int, fmt.max_int)
    return wrap(scaled.astype(np.int64), fmt.total_bits)


def _shift(x: np.ndarray, k: int, round_nearest: bool) -> np.ndarray:
    if k == 0 or not round_nearest:
        return x >> k
    return (x >> k) + ((x >> (k - 1)) & 1)


def mul(a, b, fmt: Format) -> np.ndarray:
    full = np.asarray(a, np.int64) * np.asarray(b, np.int64)     # |full| < 2^62
    return wrap(wrap(_shift(full, fmt.frac_bits, fmt.round_nearest), 32), fmt.total_bits)


def add(a, b, fmt: Format) -> np.ndarray:
    return wrap(wrap(np.asarray(a, np.int64) + np.asarray(b, np.int64), 32),
                fmt.total_bits)


def plan_words(x, fmt: Format) -> np.ndarray:
    """PLAN: 1 for |x| >= 5; |x|/32 + 0.84375 from 2.375; |x|/8 + 0.625 from
    1; |x|/4 + 0.5 below; 1 - y for x < 0.  |x| wraps at -2^31, as a
    32-bit absolute value does; the result is a 32-bit word."""
    x = np.asarray(x, np.int64)
    c = {v: int(to_words(v, fmt)) for v in (5.0, 2.375, 1.0, 0.84375, 0.625, 0.5)}
    one = c[1.0] if fmt.total_bits - 1 - fmt.frac_bits >= 1 else fmt.max_int
    ax = wrap(np.abs(x), 32)
    rn = fmt.round_nearest
    y = np.where(ax >= c[5.0], one,
                 np.where(ax >= c[2.375], _shift(ax, 5, rn) + c[0.84375],
                          np.where(ax >= c[1.0], _shift(ax, 3, rn) + c[0.625],
                                   _shift(ax, 2, rn) + c[0.5])))
    y = wrap(y, 32)
    return wrap(np.where(x < 0, one - y, y), 32)


def conv_words(x: np.ndarray, w4, b, fmt: Format) -> np.ndarray:
    """(N,H,W) words -> (N,H,W): the 2x2 SAME MAC, taps in row-major
    (dh, dw) order, then the bias."""
    H, W = x.shape[1:]
    xp = np.pad(np.asarray(x, np.int64), ((0, 0), (0, 1), (0, 1)))
    acc = np.zeros(x.shape, np.int64)
    for t, (dh, dw) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        acc += mul(xp[:, dh:dh + H, dw:dw + W], int(w4[t]), fmt)
    return add(wrap(acc, 32), int(b), fmt)


def pool(x: np.ndarray) -> np.ndarray:
    """2x2/2 max pool; an odd last row or column is cropped."""
    H, W = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :H, :W]
    return np.maximum(np.maximum(x[:, 0::2, 0::2], x[:, 0::2, 1::2]),
                      np.maximum(x[:, 1::2, 0::2], x[:, 1::2, 1::2]))


def dense_words(x: np.ndarray, w: np.ndarray, b: np.ndarray, fmt: Format) -> np.ndarray:
    """(N,K) @ (K,M) words as the MAC array: products summed, the sum
    wrapped to 32 bits and to the format, then the bias."""
    acc = mul(np.asarray(x, np.int64)[:, :, None], np.asarray(w, np.int64)[None], fmt).sum(axis=1)
    acc = wrap(wrap(acc, 32), fmt.total_bits)
    return add(acc, np.asarray(b, np.int64).reshape(1, -1), fmt)


def param_words(params: dict, fmt: Format) -> dict:
    return {layer: {k: to_words(v, fmt) for k, v in leaves.items()}
            for layer, leaves in params.items()}


def net_words(params: dict, images: np.ndarray, fmt: Format) -> np.ndarray:
    """Float params (the reference quantizes them itself) and (N,H,W[,1])
    float images in [0, 1] -> (N, 10) PLAN'd score words, int64."""
    p = param_words(params, fmt)
    x = to_words(np.asarray(images, np.float32).reshape(len(images), *images.shape[1:3]), fmt)
    for layer in ("conv1", "conv2"):
        x = pool(plan_words(conv_words(x, p[layer]["w"].reshape(4), p[layer]["b"].reshape(()),
                                       fmt), fmt))
    x = x.reshape(len(x), -1)
    return plan_words(dense_words(x, p["dense"]["w"], p["dense"]["b"], fmt), fmt)


# -- float --------------------------------------------------------------------

def keep_f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), held in float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def plan_float(x: np.ndarray, r=keep_f32) -> np.ndarray:
    ax = np.abs(x)
    y = np.where(ax >= 5.0, np.float32(1.0),
                 np.where(ax >= 2.375, r(r(np.float32(0.03125) * ax) + np.float32(0.84375)),
                          np.where(ax >= 1.0, r(r(np.float32(0.125) * ax) + np.float32(0.625)),
                                   r(r(np.float32(0.25) * ax) + np.float32(0.5)))))
    return np.where(x < 0, r(np.float32(1.0) - y), y).astype(np.float32)


def conv_float(x: np.ndarray, w: np.ndarray, b, r=keep_f32) -> np.ndarray:
    H, W = x.shape[1:]
    xp = np.pad(np.asarray(x, np.float32), ((0, 0), (0, 1), (0, 1)))
    w = r(np.asarray(w, np.float32).reshape(2, 2))
    acc = None
    for dh in (0, 1):
        for dw in (0, 1):
            term = r(xp[:, dh:dh + H, dw:dw + W] * w[dh, dw])
            acc = term if acc is None else r(acc + term)
    return r(acc + r(np.float32(np.asarray(b).reshape(()))))


def net_float(params: dict, images: np.ndarray, r=keep_f32) -> np.ndarray:
    """(N,H,W[,1]) float images -> (N, 10) float32 PLAN'd scores."""
    x = r(np.asarray(images, np.float32).reshape(len(images), *images.shape[1:3]))
    for layer in ("conv1", "conv2"):
        x = pool(plan_float(conv_float(x, params[layer]["w"], params[layer]["b"], r), r))
    x = x.reshape(len(x), -1)
    w = r(np.asarray(params["dense"]["w"], np.float32))
    acc = np.zeros((len(x), w.shape[1]), np.float32)
    for k in range(w.shape[0]):                       # one rounding a product and a sum
        acc = r(acc + r(x[:, k, None] * w[k]))
    return plan_float(r(acc + r(np.asarray(params["dense"]["b"], np.float32))), r)


def predict(scores: np.ndarray) -> np.ndarray:
    """The Max Finder: the index of the first largest score."""
    return np.argmax(np.asarray(scores), axis=-1)
