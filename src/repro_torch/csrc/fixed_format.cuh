// The word arithmetic of one Qm.n format, specialised at compile time, and
// the dense-layer helpers built on it.  Shared by frame_trunk.cu,
// fixed_dense.cu and fixed_net.cu (with staging.cuh, the shared-memory
// staging they use).
//
// Word<kFrac, kTotal, kRound> is the arithmetic of one format.  The three
// wraparound STANDARD_CONFIGS (Q16.16, Q16.16 truncating, Q8.8) have it at
// compile time (`dispatch_format`); there
//   * a product is one 64-bit multiply-add (mad.wide.s32), a*b + 2^(f-1)
//     when rounding (floor((p + 2^(f-1)) / 2^f) is p >> f plus bit f-1 of
//     p), and one funnel shift for the low 32 bits of the shifted product;
//   * the per-product wrap to total_bits is dropped and there is no
//     saturation branch: product words, fixed_add and the wrap to
//     total_bits are all congruent mod 2^total_bits to the plain int32
//     values, and every conv or dense word ends in a wrap, so such a word
//     equals wrap(sum of its products + bias), with the products summed
//     mod 2^32 in any order and grouping;
//   * PLAN's rounding shifts are (x + 2^(k-1)) >> k, exact wherever that
//     segment is taken, and its segments are selects (`selp`), not
//     branches that a warp's words would split.
// Every other config, the saturating ones first, takes kFrac < 0: the
// runtime FixedCfg and the word functions of fixed_word.cuh, each product
// saturated and wrapped on its own.  There the two layers sum differently,
// as the reference does:
//   conv word   fixed_add(wrap32(sum of products), bias)          `conv`
//   dense word  fixed_add(wrap_total(wrap32(sum of products)), b) `dense`
// (in a wraparound format both are the same word).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_word.cuh"
#include "staging.cuh"

__device__ __forceinline__ int32_t max4(int32_t a, int32_t b, int32_t c, int32_t d) {
  return max(max(a, b), max(c, d));
}

// x >= bound ? a : b as a select: a branch would split a warp whose words
// fall on different sides of the bound
__device__ __forceinline__ int32_t select_ge(int32_t x, int32_t bound, int32_t a,
                                             int32_t b) {
  int32_t r;
  asm("{\n.reg .pred p;\nsetp.ge.s32 p, %1, %2;\nselp.b32 %0, %3, %4, p;\n}"
      : "=r"(r)
      : "r"(x), "r"(bound), "r"(a), "r"(b));
  return r;
}

// The word arithmetic of one format: compile-time for kFrac >= 0, the
// runtime FixedCfg (fixed_word.cuh) for kFrac < 0.
template <int kFrac, int kTotal, int kRound>
struct Word {
  FixedCfg c;
  long long half;   // 2^(frac_bits-1) when rounding, else 0 (see `make`)

  // `half` is hidden from the optimiser, so that it stays in a register
  // pair and every product is one IMAD.WIDE with it as the addend: as a
  // constant it becomes a separate 64-bit add (IADD3 + IMAD.X)
  __device__ __forceinline__ static Word make(const FixedCfg& cfg) {
    long long h = 0;
    if constexpr (kFrac > 0 && kRound) h = 1ll << (kFrac - 1);
    asm volatile("" : "+l"(h));
    return Word{cfg, h};
  }

  // a product word, correct mod 2^total_bits (all a conv or dense word
  // needs) in a specialised format; the exact product word otherwise
  __device__ __forceinline__ uint32_t mul(int32_t a, int32_t b) const {
    if constexpr (kFrac < 0) {
      return (uint32_t)fixed_mul(a, b, c);
    } else {
      // signed: a plain `(long long)a * b + h` compiles to an unsigned wide
      // multiply with sign corrections
      long long p;
      asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(p) : "r"(a), "r"(b), "l"(half));
      return __funnelshift_r((uint32_t)p, (uint32_t)((unsigned long long)p >> 32),
                             kFrac);
    }
  }

  // a conv word: the tap products' sum mod 2^32 plus the bias, wrapped
  __device__ __forceinline__ int32_t conv(uint32_t sum, int32_t bias) const {
    if constexpr (kFrac < 0) {
      return fixed_add((int32_t)sum, bias, c);
    } else {
      const int32_t s = (int32_t)(sum + (uint32_t)bias);
      if constexpr (kTotal >= 32) return s;
      else return ((int32_t)((uint32_t)s << (32 - kTotal))) >> (32 - kTotal);
    }
  }

  // a dense word: the products' sum mod 2^32, wrapped to total_bits, then
  // fixed_add of the bias (in a wraparound format the same word as `conv`)
  __device__ __forceinline__ int32_t dense(uint32_t sum, int32_t bias) const {
    if constexpr (kFrac < 0) return fixed_add(wrap_bits((int32_t)sum, c.total_bits), bias, c);
    else return conv(sum, bias);
  }

  template <int k>
  __device__ __forceinline__ static int32_t shr(int32_t x) {
    if constexpr (kRound) return (int32_t)((uint32_t)x + (1u << (k - 1))) >> k;
    else return x >> k;
  }

  __device__ __forceinline__ int32_t plan(int32_t x) const {
    if constexpr (kFrac < 0) {
      return plan_sigmoid(x, c);
    } else {
      // every segment, then selects
      const int32_t ax = x < 0 ? (int32_t)(0u - (uint32_t)x) : x;
      int32_t y = select_ge(ax, c.c1, add32(shr<3>(ax), c.c0625), add32(shr<2>(ax), c.c05));
      y = select_ge(ax, c.c2375, add32(shr<5>(ax), c.c084375), y);
      y = select_ge(ax, c.c5, c.one, y);
      return select_ge(x, 0, y, (int32_t)((uint32_t)c.one - (uint32_t)y));
    }
  }

  // PLAN of a conv word
  __device__ __forceinline__ int32_t act(uint32_t sum, int32_t bias) const {
    return plan(conv(sum, bias));
  }
};

// Words per row of a dense weight matrix staged for dense_sums: kN rounded
// up to whole 16-byte vectors.
template <int kN>
__host__ __device__ constexpr int dense_ld() { return (kN + 3) / 4 * 4; }

// Part of one row of a dense layer, in one thread: acc[n] += mul(x[k],
// w[k][n]) for n < kN and k = k0, k0 + kstep, ... < K, the kN sums held in
// registers (mod 2^32: the threads that share a row add their parts in
// any order; Word::dense then makes the words).  `w` is (K,
// dense_ld<kN>()) in shared memory, 16-byte aligned, zero past the layer's
// N columns, so each k takes whole-vector loads; x is the row.
template <int kN, class F>
__device__ __forceinline__ void dense_sums(const F& f, const int32_t* x, int K, int k0,
                                           int kstep, const int32_t* w,
                                           uint32_t (&acc)[kN]) {
  constexpr int kLd = dense_ld<kN>();
#pragma unroll 2
  for (int k = k0; k < K; k += kstep) {
    const int32_t a = x[k];
    int32_t wk[kLd];
#pragma unroll
    for (int v = 0; v < kLd / 4; ++v) {
      const int4 q = reinterpret_cast<const int4*>(w + k * kLd)[v];
      wk[4 * v] = q.x;
      wk[4 * v + 1] = q.y;
      wk[4 * v + 2] = q.z;
      wk[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) acc[n] += f.mul(a, wk[n]);
  }
}

template <int F, int T, int R>
struct Format {
  static constexpr int kFrac = F, kTotal = T, kRound = R;
};

// Calls fn(Format<...>{}) with the format `c` takes: the three wraparound
// STANDARD_CONFIGS their specialised arithmetic, every other config
// (saturating, or another width) the runtime one, Format<-1, -1, -1>.
template <class Fn>
auto dispatch_format(const FixedCfg& c, Fn&& fn) {
  if (!c.saturate && c.frac_bits == 16 && c.total_bits == 32)
    return c.round_nearest ? fn(Format<16, 32, 1>{}) : fn(Format<16, 32, 0>{});
  if (!c.saturate && c.frac_bits == 8 && c.total_bits == 16 && c.round_nearest)
    return fn(Format<8, 16, 1>{});
  return fn(Format<-1, -1, -1>{});
}
