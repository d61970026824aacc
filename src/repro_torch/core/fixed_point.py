"""Qm.n two's-complement fixed-point arithmetic on int32 torch tensors.

The port of `repro.core.fixed_point`, word for word.  The paper stores
weights and activations as 32-bit two's-complement fixed point; here:

  * storage: int32, value = stored / 2**frac_bits
  * multiply: the full 32x32 -> 64-bit product in int64 (the reference
    splits it into 16-bit limbs only because JAX runs without x64), an
    arithmetic shift by frac_bits plus the round bit (bit frac_bits-1 of
    the full product), then a wrap to 32 bits and to `total_bits`;
    the optional saturation decision is the reference's float32
    heuristic, f32(a)*f32(b)/scale against f32(max_int) and f32(min_int)
  * add: wraps in int32; the saturating add checks signs in 32 bits
    before the final wrap to `total_bits`

Every wrap is written out in int64 (`_wrap`), so nothing leans on what a
narrowing cast does with an out-of-range value.  `sigmoid_plan_f32` is the
float PLAN sigmoid of the float backends (the plain version of the
`sigmoid_pla` kernel).  The functions are plain
tensor code: they run on whatever device their inputs live on, and they
are the "plain version" the CUDA kernels in `repro_torch.kernels` are held
against.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class FixedPointConfig:
    """Qm.n format: total_bits = 1 + m + n (sign + integer + fraction)."""
    total_bits: int = 32
    frac_bits: int = 16
    saturate: bool = False          # False = wraparound (paper's 2's complement)
    round_nearest: bool = True      # False = truncate (pure >> shift)

    @property
    def int_bits(self) -> int:
        return self.total_bits - 1 - self.frac_bits

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_int(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.total_bits - 1))


Q16_16 = FixedPointConfig(32, 16)
Q8_8 = FixedPointConfig(16, 8)

# the format x mode matrix of the bit-exactness contract (the same five
# entries as the reference's STANDARD_CONFIGS)
STANDARD_CONFIGS = {
    "q16_16": Q16_16,
    "q16_16_sat": FixedPointConfig(32, 16, saturate=True),
    "q16_16_trunc": FixedPointConfig(32, 16, round_nearest=False),
    "q8_8": Q8_8,
    "q8_8_sat": FixedPointConfig(16, 8, saturate=True),
}


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of an integer tensor to `bits`, as int32."""
    x = x.to(torch.int64)
    if bits < 64:
        half = 1 << (bits - 1)
        x = ((x + half) & ((1 << bits) - 1)) - half
    return x.to(torch.int32)


def _wrap_to_bits(x: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Truncate an int32 word to `total_bits` with sign extension."""
    if total_bits == 32:
        return x.to(torch.int32)
    return _wrap(x, total_bits)


def to_fixed(x, cfg: FixedPointConfig = Q16_16, *,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Float -> fixed.  Out-of-range reals saturate (ADC-style), NaN -> 0.

    The reference's f32 -> int32 cast clamps (XLA semantics); torch's
    `.to(torch.int32)` wraps on CPU and clamps on CUDA.  So the value is
    clipped in float32, taken to int64, clamped to int32 and only then
    narrowed: the same word on every device.
    """
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    scaled = torch.round(x * cfg.scale)
    scaled = torch.clamp(scaled, float(cfg.min_int), float(cfg.max_int))
    scaled = torch.where(torch.isnan(scaled), torch.zeros_like(scaled), scaled)
    words = torch.clamp(scaled.to(torch.int64), -2 ** 31, 2 ** 31 - 1)
    return _wrap_to_bits(words, cfg.total_bits)


def from_fixed(x: torch.Tensor, cfg: FixedPointConfig = Q16_16) -> torch.Tensor:
    return x.to(torch.float32) / cfg.scale


def fixed_add(a: torch.Tensor, b: torch.Tensor,
              cfg: FixedPointConfig = Q16_16) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=torch.int32)
    b = torch.as_tensor(b, dtype=torch.int32, device=a.device)
    s = _wrap(a.to(torch.int64) + b.to(torch.int64), 32)   # int32 wraparound
    if cfg.saturate:
        # overflow iff operands share sign and result sign differs
        ovf = ((torch.sign(a) == torch.sign(b)) & (torch.sign(s) != torch.sign(a))
               & (a != 0))
        sat = torch.where(a > 0, cfg.max_int, cfg.min_int).to(torch.int32)
        s = torch.where(ovf, sat, s)
    return _wrap_to_bits(s, cfg.total_bits)


def shift_right_round(x: torch.Tensor, k: int, round_nearest: bool) -> torch.Tensor:
    """Arithmetic right shift with the config's rounding rule: truncate mode
    is the pure shifter (`x >> k`); round-nearest adds bit (k-1) of x."""
    if k == 0 or not round_nearest:
        return x >> k
    return (x >> k) + ((x >> (k - 1)) & 1)


def fixed_mul(a: torch.Tensor, b: torch.Tensor,
              cfg: FixedPointConfig = Q16_16) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=torch.int32)
    b = torch.as_tensor(b, dtype=torch.int32, device=a.device)
    full = a.to(torch.int64) * b.to(torch.int64)          # exact: |full| < 2^62
    p = _wrap(shift_right_round(full, cfg.frac_bits, cfg.round_nearest), 32)
    if cfg.saturate:
        # the reference's f32 magnitude heuristic, with f32 thresholds
        # (f32(2147483647) is 2147483648.0); a threshold that is exact in
        # f32 compares the same in any wider type
        approx = a.to(torch.float32) * b.to(torch.float32) / cfg.scale
        hi, lo = _f32(cfg.max_int), _f32(cfg.min_int)
        p = torch.where(approx > hi, cfg.max_int,
                        torch.where(approx < lo, cfg.min_int, p)).to(torch.int32)
    return _wrap_to_bits(p, cfg.total_bits)


def _f32(v: int) -> float:
    """`v` rounded to the nearest float32, as a Python float."""
    return float(torch.tensor(float(v), dtype=torch.float32))


def fixed_matmul(x: torch.Tensor, w: torch.Tensor,
                 cfg: FixedPointConfig = Q16_16) -> torch.Tensor:
    """Fixed-point (B, K) @ (K, N): per-element fixed mul, int32 accumulate,
    then one more wrap of the sum to `total_bits` (the MAC array)."""
    prods = fixed_mul(x[:, :, None], w[None, :, :], cfg)      # (B, K, N)
    acc = _wrap(prods.to(torch.int64).sum(dim=1), 32)
    return _wrap_to_bits(acc, cfg.total_bits)


@dataclasses.dataclass(frozen=True)
class PlanConstants:
    """The PLAN sigmoid's breakpoints and offsets as words of one format."""
    c5: int
    c2375: int
    c1: int
    c084375: int
    c0625: int
    c05: int
    one: int


@functools.lru_cache(maxsize=32)
def plan_constants(cfg: FixedPointConfig) -> PlanConstants:
    w = lambda v: int(to_fixed(v, cfg))
    one = w(1.0) if cfg.int_bits >= 1 else cfg.max_int
    return PlanConstants(c5=w(5.0), c2375=w(2.375), c1=w(1.0),
                         c084375=w(0.84375), c0625=w(0.625), c05=w(0.5),
                         one=one)


def fixed_sigmoid_plan(x: torch.Tensor,
                       cfg: FixedPointConfig = Q16_16) -> torch.Tensor:
    """PLAN (piecewise-linear approximation) sigmoid in fixed point:

        |x| >= 5          -> 1
        2.375 <= |x| < 5  -> 0.03125*|x| + 0.84375
        1 <= |x| < 2.375  -> 0.125 *|x| + 0.625
        0 <= |x| < 1      -> 0.25  *|x| + 0.5
    and sigmoid(-x) = 1 - sigmoid(x).

    |x| wraps at INT32_MIN (it stays INT32_MIN, as `jnp.abs` does), the
    slope shifts follow `cfg.round_nearest`, and the int32 result is NOT
    re-wrapped to `total_bits`, exactly as in the reference.
    """
    c = plan_constants(cfg)
    x = torch.as_tensor(x, dtype=torch.int32)
    ax = _wrap(x.to(torch.int64).abs(), 32).to(torch.int64)
    rn = cfg.round_nearest
    y = torch.where(
        ax >= c.c5, c.one,
        torch.where(
            ax >= c.c2375, shift_right_round(ax, 5, rn) + c.c084375,
            torch.where(ax >= c.c1, shift_right_round(ax, 3, rn) + c.c0625,
                        shift_right_round(ax, 2, rn) + c.c05)))
    y = _wrap(y, 32).to(torch.int64)
    return _wrap(torch.where(x < 0, c.one - y, y), 32)


def sigmoid_plan_f32(x: torch.Tensor) -> torch.Tensor:
    """Float PLAN sigmoid (the same breakpoints 1, 2.375 and 5), the port of
    the reference's `sigmoid_plan_f32`: each affine piece is a multiply then
    an add, each rounded on its own, and `x < 0` picks the odd half."""
    ax = torch.abs(x)
    y = torch.where(ax >= 5.0, 1.0,
                    torch.where(ax >= 2.375, 0.03125 * ax + 0.84375,
                                torch.where(ax >= 1.0, 0.125 * ax + 0.625,
                                            0.25 * ax + 0.5)))
    return torch.where(x < 0, 1.0 - y, y)
