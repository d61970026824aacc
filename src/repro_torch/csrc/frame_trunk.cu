// Whole-frame smallNet trunk with the sweep's quad role maps, for sm_90a.
//
// Replaces the Pallas TPU kernel frame_trunk_pallas (_frame_trunk_kernel) of
// src/repro/kernels/frame_trunk/kernel.py: one (H, W) int32 word frame in,
// the (4, H/4, W/4) int32 quad [interior, last_row, last_col, corner] out,
// in one launch.
//
// Design: one thread block per (th, tw) output tile (the tile comes from
// repro_torch/kernels/frame_trunk/ops.py:choose_tile); the shared memory is
// dynamic and may exceed 48 KB.  The block has the fewest threads, in
// whole warps, that cover the level-1 positions in as few passes of at
// most 384 as they need (384 rather than 512: smaller blocks let more of
// them share an SM, each in a different phase).
//   1. The block stages its (th+3) x (tw+4) input words in shared memory:
//      the tile plus a 3-pixel bottom/right halo, a row padded to whole
//      16-byte vectors (W % 4 == 0, so a vector is wholly inside the frame
//      or wholly past it).  Words past the frame's edge read as zero, so no
//      padded copy of the frame is made.
//   2. Level 0 + pool: one thread per level-1 position (th/2+1 x tw/2+1,
//      one pooled halo row and column kept), in a strided loop.  It forms
//      the 16 (word, tap) products of its 3x3 input window once and, from
//      them, the nine masked conv words its 2x2 pool window needs (s_ii at
//      all four positions, s_li on the odd row, s_il on the odd column,
//      s_ll at the odd corner): the TOP, LEFT and 00 tap sums are partial
//      sums of the ALL sums, so 16 products serve all nine.  PLAN, then the
//      I/B/R/C words go to shared memory.  A position at global row >= H/2
//      or column >= W/2 lies over the frame's padding: it is level 1's SAME
//      zero padding, so it is stored as 0.  A halo position inside the
//      frame holds the neighbouring tile's real value.
//   3. Level 1 + pool: one thread per level-2 position computes all four
//      role words.  Its 3x3 windows of the quad hold 36 distinct
//      (map, position, tap) products (16 over I, 8 over B, 8 over R, 4 over
//      C); each is formed once and every partial conv that needs it adds it
//      (the role-by-role form computed 49).
// Pool windows do not overlap, so no conv word is computed twice within a
// tile; only the halo row/column is recomputed by the neighbouring block.
//
// Why sharing products and partial sums keeps every word: the trunk takes
// only wraparound configs (the wrapper rejects saturating ones).  There a
// product word, fixed_add and the wrap to total_bits are all congruent mod
// 2^total_bits to the plain int32 values, and every conv word ends in a
// wrap.  So a masked conv, or the fixed_add recombination of several (in
// _sweep_stage's order), equals wrap(sum of its products + bias), with the
// products summed mod 2^32 in any order and grouping.
//
// Arithmetic: Word<> of fixed_format.cuh.  The three wraparound
// STANDARD_CONFIGS (Q16.16, Q16.16 truncating, Q8.8) have kernels
// specialised at compile time (one IMAD.WIDE a product, no per-product
// wrap, PLAN by selects); any other wraparound config runs the generic
// kernel, with the runtime FixedCfg.
//
// Bound on an H100 SXM (3.35 TB/s; int32 on the CUDA cores 16.7 Tops/s):
// the function reads each input word once and writes each output word
// once, H*W*4 + 4*(H/4)(W/4)*4 bytes (5 per frame pixel; the halo's zeros
// are made, not read).  The least integer work it needs is about 18.5
// operations per frame pixel (counted in chip_smoke.py frame_trunk_work),
// so a 1080x1920 frame is bound by bytes: 10.4 MB, 3.1 us.  The kernel
// still does several instructions per counted operation (a product is two,
// a PLAN word a dozen with its three candidate segments), so the integer
// pipes, not the bytes, are expected to hold it back.  No tensor core
// applies: every product is renormalized before it is summed.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_format.cuh"

namespace {

constexpr int kHalo = 3;
constexpr int kMaxThreads = 384;

template <int kFrac, int kTotal, int kRound>
__global__ void __launch_bounds__(kMaxThreads)
frame_trunk_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w1p,
                   const int32_t* __restrict__ b1p, const int32_t* __restrict__ w2p,
                   const int32_t* __restrict__ b2p, int32_t* __restrict__ out,
                   int H, int W, int th, int tw, int vec, FixedCfg cfg) {
  extern __shared__ int4 smem4[];
  const auto F = Word<kFrac, kTotal, kRound>::make(cfg);
  const int xh = th + kHalo, ld = tw + 4;         // staged input, row stride
  const int h1 = th / 2 + 1, w1 = tw / 2 + 1;     // level-1 extent with halo
  const int n1 = h1 * w1;
  int32_t* xs = reinterpret_cast<int32_t*>(smem4);
  int32_t* qI = xs + xh * ld;                     // 4 x (h1, w1) level-1 quad
  int32_t* qB = qI + n1;
  int32_t* qR = qB + n1;
  int32_t* qC = qR + n1;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int32_t wa[4] = {w1p[0], w1p[1], w1p[2], w1p[3]};
  const int32_t wb[4] = {w2p[0], w2p[1], w2p[2], w2p[3]};
  const int32_t b1 = b1p[0], b2 = b2p[0];

  // 1. the tile plus its bottom/right halo; the frame's padding reads as 0
  const long long i0 = (long long)ti * th, j0 = (long long)tj * tw;
  if (vec) {                                      // x 16-byte aligned
    const int nv = ld / 4;
    for (int k = threadIdx.x; k < xh * nv; k += blockDim.x) {
      const int r = k / nv, v = k - r * nv;
      const long long gi = i0 + r, gj = j0 + 4 * v;
      smem4[k] = (gi < H && gj < W)
                     ? __ldg(reinterpret_cast<const int4*>(x + gi * W + gj))
                     : make_int4(0, 0, 0, 0);
    }
  } else {
    for (int k = threadIdx.x; k < xh * ld; k += blockDim.x) {
      const int r = k / ld;
      const long long gi = i0 + r, gj = j0 + (k - r * ld);
      xs[k] = (gi < H && gj < W) ? x[gi * W + gj] : 0;
    }
  }
  __syncthreads();

  // 2. level 0 (4 masked-tap conv+PLAN maps) pooled into the level-1 quad
  for (int k = threadIdx.x; k < n1; k += blockDim.x) {
    const int r = k / w1, c = k - r * w1;
    const int32_t* p = xs + (2 * r) * ld + 2 * c;   // the 3x3 input window
    // P[i][j][t]: the product for level-0 position (2r+i, 2c+j), tap t
    uint32_t P[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          P[i][j][t] = F.mul(p[(i + t / 2) * ld + j + t % 2], wa[t]);
    const uint32_t top10 = P[1][0][0] + P[1][0][1];     // TOP at (1,0)
    const uint32_t top11 = P[1][1][0] + P[1][1][1];     // TOP at (1,1)
    const uint32_t left01 = P[0][1][0] + P[0][1][2];    // LEFT at (0,1)
    const uint32_t left11 = P[1][1][0] + P[1][1][2];    // LEFT at (1,1)
    const int32_t ii00 = F.act(P[0][0][0] + P[0][0][1] + P[0][0][2] + P[0][0][3], b1);
    const int32_t ii01 = F.act(left01 + P[0][1][1] + P[0][1][3], b1);
    const int32_t ii10 = F.act(top10 + P[1][0][2] + P[1][0][3], b1);
    const int32_t ii11 = F.act(top11 + P[1][1][2] + P[1][1][3], b1);
    const int32_t li10 = F.act(top10, b1);
    const int32_t li11 = F.act(top11, b1);
    const int32_t il01 = F.act(left01, b1);
    const int32_t il11 = F.act(left11, b1);
    const int32_t ll11 = F.act(P[1][1][0], b1);
    // level 1's SAME padding: global level-1 row H/2 or column W/2 is zero
    const bool keep = ti * (th / 2) + r < H / 2 && tj * (tw / 2) + c < W / 2;
    qI[k] = keep ? max4(ii00, ii01, ii10, ii11) : 0;   // interior
    qB[k] = keep ? max4(ii00, ii01, li10, li11) : 0;   // last row
    qR[k] = keep ? max4(ii00, il01, ii10, il11) : 0;   // last col
    qC[k] = keep ? max4(ii00, il01, li10, ll11) : 0;   // corner
  }
  __syncthreads();

  // 3. level 1: the four role words of one level-2 position, PLAN, pooled
  const int h2 = th / 4, w2 = tw / 4, n2 = h2 * w2;
  const long long plane = (long long)(H / 4) * (W / 4);
  for (int k = threadIdx.x; k < n2; k += blockDim.x) {
    const int r = k / w2, c = k - r * w2;
    const int o = (2 * r) * w1 + 2 * c;           // window origin in the quad
    // role 0 (interior): Q[i][j][t] over I, the 16 products of s_ii2
    uint32_t Q[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          Q[i][j][t] = F.mul(qI[o + (i + t / 2) * w1 + j + t % 2], wb[t]);
    const uint32_t topI0 = Q[0][0][0] + Q[0][0][1], topI1 = Q[0][1][0] + Q[0][1][1];
    const uint32_t leftI0 = Q[0][0][0] + Q[0][0][2], leftI1 = Q[1][0][0] + Q[1][0][2];
    const int32_t y0 = max4(F.act(topI0 + Q[0][0][2] + Q[0][0][3], b2),
                            F.act(topI1 + Q[0][1][2] + Q[0][1][3], b2),
                            F.act(leftI1 + Q[1][0][1] + Q[1][0][3], b2),
                            F.act(Q[1][1][0] + Q[1][1][1] + Q[1][1][2] + Q[1][1][3], b2));
    // role 1 (last row): B's row 1 of the window, 8 products; s_pi2 is
    // I's TOP plus B's BOT, s_li2 B's TOP one row down
    const int32_t B0 = qB[o + w1], B1 = qB[o + w1 + 1], B2 = qB[o + w1 + 2];
    const uint32_t B0w0 = F.mul(B0, wb[0]), B0w2 = F.mul(B0, wb[2]);
    const uint32_t B1w0 = F.mul(B1, wb[0]), B1w1 = F.mul(B1, wb[1]);
    const uint32_t B1w2 = F.mul(B1, wb[2]), B1w3 = F.mul(B1, wb[3]);
    const uint32_t B2w1 = F.mul(B2, wb[1]), B2w3 = F.mul(B2, wb[3]);
    const int32_t y1 = max4(F.act(topI0 + B0w2 + B1w3, b2), F.act(topI1 + B1w2 + B2w3, b2),
                            F.act(B0w0 + B1w1, b2), F.act(B1w0 + B2w1, b2));
    // role 2 (last col): R's column 1 of the window, 8 products; s_ip2 is
    // I's LEFT plus R's RIGHT, s_il2 R's LEFT one column right
    const int32_t R0 = qR[o + 1], R1 = qR[o + w1 + 1], R2 = qR[o + 2 * w1 + 1];
    const uint32_t R0w0 = F.mul(R0, wb[0]), R0w1 = F.mul(R0, wb[1]);
    const uint32_t R1w0 = F.mul(R1, wb[0]), R1w1 = F.mul(R1, wb[1]);
    const uint32_t R1w2 = F.mul(R1, wb[2]), R1w3 = F.mul(R1, wb[3]);
    const uint32_t R2w2 = F.mul(R2, wb[2]), R2w3 = F.mul(R2, wb[3]);
    const int32_t y2 = max4(F.act(leftI0 + R0w1 + R1w3, b2), F.act(R0w0 + R1w2, b2),
                            F.act(leftI1 + R1w1 + R2w3, b2), F.act(R1w0 + R2w2, b2));
    // role 3 (corner): C at (1,1) of the window, 4 products; s_pp2, s_pl2
    // and s_lp2 take their other taps from I, R and B above
    const int32_t C = qC[o + w1 + 1];
    const int32_t y3 = max4(F.act(Q[0][0][0] + R0w1 + B0w2 + F.mul(C, wb[3]), b2),
                            F.act(R0w0 + F.mul(C, wb[2]), b2),
                            F.act(B0w0 + F.mul(C, wb[1]), b2), F.act(F.mul(C, wb[0]), b2));
    const long long e = ((long long)ti * h2 + r) * (W / 4) + (long long)tj * w2 + c;
    out[e] = y0;
    out[plane + e] = y1;
    out[2 * plane + e] = y2;
    out[3 * plane + e] = y3;
  }
}

template <int kFrac, int kTotal, int kRound>
cudaError_t launch(const int32_t* x, const int32_t* w1, const int32_t* b1,
                   const int32_t* w2, const int32_t* b2, int32_t* out, int H,
                   int W, int th, int tw, const FixedCfg& cfg, cudaStream_t stream) {
  const auto kernel = frame_trunk_kernel<kFrac, kTotal, kRound>;
  const int n1 = (th / 2 + 1) * (tw / 2 + 1);
  const int passes = (n1 + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((n1 + passes - 1) / passes + 31) / 32 * 32;
  const int smem = 4 * ((th + kHalo) * (tw + 4) + 4 * n1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<dim3(W / tw, H / th), threads, smem, stream>>>(x, w1, b1, w2, b2, out, H,
                                                          W, th, tw, vec, cfg);
  return cudaGetLastError();
}

}  // namespace

// The C interface (loaded with ctypes).  Makes `device` current for this
// thread, enqueues one launch on `stream` (grid: W/tw x H/th tiles), does
// not synchronise, and returns a CUDA error code.
// The three wraparound STANDARD_CONFIGS take their specialised kernels.
extern "C" int frame_trunk_launch(int device, const int32_t* x,
                                  const int32_t* w1, const int32_t* b1,
                                  const int32_t* w2, const int32_t* b2,
                                  int32_t* out, int H, int W, int th, int tw,
                                  FixedCfg cfg, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  if (cfg.saturate) return (int)cudaErrorInvalidValue;   // the wrapper rejects these first
  return (int)dispatch_format(cfg, [&](auto f) {
    using Fm = decltype(f);
    return launch<Fm::kFrac, Fm::kTotal, Fm::kRound>(x, w1, b1, w2, b2, out, H, W, th, tw,
                                                     cfg, s);
  });
}

