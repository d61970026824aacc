// Qm.n word arithmetic shared by the fixed-point CUDA kernels.
//
// The device-side copy of repro_torch/core/fixed_point.py (itself a port of
// src/repro/core/fixed_point.py).  Every function here must give the same
// int32 word as its PyTorch counterpart for every int32 input:
//
//   * product: the full 64-bit product (one IMAD.WIDE, no limb split), an
//     arithmetic shift by frac_bits, plus bit (frac_bits-1) of the full
//     product when rounding; truncated to 32 bits, then wrapped to
//     total_bits.
//   * saturation decision: the reference's float32 heuristic
//     f32(a)*f32(b)/scale against f32(max_int) and f32(min_int), computed
//     with __fmul_rn/__fdiv_rn so no contraction or approximate division
//     can move a decision at a boundary.
//   * sums wrap mod 2^32: they are taken in uint32_t, because signed
//     overflow is undefined in C++ and the compiler may exploit it.
//   * right shifts of negative int32/int64 are arithmetic (nvcc's shr.s32 /
//     shr.s64), as the reference's `>>` is.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_error.cuh"

// One Qm.n format and the PLAN sigmoid's words in it.  Built on the host by
// repro_torch/kernels/_build.py (`fixed_cfg`); the field order is part of
// the C interface.
struct FixedCfg {
  int total_bits;
  int frac_bits;
  int saturate;
  int round_nearest;
  int max_int;
  int min_int;
  float scale;
  int c5;        // PLAN breakpoints and offsets, as words of this format
  int c2375;
  int c1;
  int c084375;
  int c0625;
  int c05;
  int one;
};

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_bits(int32_t x, int total_bits) {
  if (total_bits >= 32) return x;
  const int s = 32 - total_bits;
  return ((int32_t)((uint32_t)x << s)) >> s;
}

__device__ __forceinline__ int32_t fixed_mul(int32_t a, int32_t b,
                                             const FixedCfg& c) {
  const long long full = (long long)a * (long long)b;   // exact, |full| < 2^62
  long long p = full >> c.frac_bits;
  if (c.round_nearest && c.frac_bits > 0) p += (full >> (c.frac_bits - 1)) & 1;
  int32_t w = (int32_t)(uint32_t)(unsigned long long)p;  // mod 2^32
  if (c.saturate) {
    const float approx = __fdiv_rn(__fmul_rn((float)a, (float)b), c.scale);
    if (approx > (float)c.max_int) {
      w = c.max_int;
    } else if (approx < (float)c.min_int) {
      w = c.min_int;
    }
  }
  return wrap_bits(w, c.total_bits);
}

__device__ __forceinline__ int sign32(int32_t v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int32_t fixed_add(int32_t a, int32_t b,
                                             const FixedCfg& c) {
  int32_t s = add32(a, b);
  // overflow iff operands share sign and the result's sign differs,
  // decided in 32 bits before the final wrap
  if (c.saturate && sign32(a) == sign32(b) && sign32(s) != sign32(a) && a != 0)
    s = a > 0 ? c.max_int : c.min_int;
  return wrap_bits(s, c.total_bits);
}

__device__ __forceinline__ int32_t shift_right_round(int32_t x, int k, int rn) {
  if (k == 0 || !rn) return x >> k;
  return add32(x >> k, (x >> (k - 1)) & 1);
}

// PLAN sigmoid: |x| through unsigned negation (|INT32_MIN| stays INT32_MIN,
// as jnp.abs does), shift-add segments, odd symmetry; the int32 result is
// not re-wrapped to total_bits.
__device__ __forceinline__ int32_t plan_sigmoid(int32_t x, const FixedCfg& c) {
  const int32_t ax = x < 0 ? (int32_t)(0u - (uint32_t)x) : x;
  const int rn = c.round_nearest;
  int32_t y;
  if (ax >= c.c5) {
    y = c.one;
  } else if (ax >= c.c2375) {
    y = add32(shift_right_round(ax, 5, rn), c.c084375);
  } else if (ax >= c.c1) {
    y = add32(shift_right_round(ax, 3, rn), c.c0625);
  } else {
    y = add32(shift_right_round(ax, 2, rn), c.c05);
  }
  return x < 0 ? (int32_t)((uint32_t)c.one - (uint32_t)y) : y;
}
