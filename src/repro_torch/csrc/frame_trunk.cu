// Whole-frame smallNet trunk with the sweep's quad role maps, for sm_90a.
//
// Replaces the Pallas TPU kernel frame_trunk_pallas (_frame_trunk_kernel) of
// src/repro/kernels/frame_trunk/kernel.py: one (H, W) int32 word frame in,
// the (4, H/4, W/4) int32 quad [interior, last_row, last_col, corner] out,
// in one launch.
//
// Design: one thread block per (th, tw) output tile (the tile comes from
// repro_torch/kernels/frame_trunk/ops.py:choose_tile).
//   1. The block stages its (th+3) x (tw+3) input words in shared memory:
//      the tile plus a 3-pixel bottom/right halo.  Words past the frame's
//      edge read as zero, so no padded copy of the frame is made.
//   2. Level 0 + pool: one thread per level-1 position (th/2+1 x tw/2+1,
//      one pooled halo row and column kept).  It computes the nine masked
//      conv+PLAN words its 2x2 pool window needs (s_ii at all four
//      positions, s_li on the odd row, s_il on the odd column, s_ll at the
//      odd corner) in registers and writes the I/B/R/C words to shared
//      memory.  A position at global row >= H/2 or column >= W/2 lies over
//      the frame's padding: it is level 1's SAME zero padding, so it is
//      stored as 0.  A halo position inside the frame holds the
//      neighbouring tile's real value.
//   3. Level 1 + pool: one thread per (role, level-2 position).  Each role
//      word pools four level-1 role words, each a masked partial conv (or
//      a wraparound fixed_add of several, in _sweep_stage's association
//      order) followed by PLAN.
// Pool windows do not overlap, so no conv word is computed twice within a
// tile; only the halo row/column is recomputed by the neighbouring block.
//
// Arithmetic: every partial conv is a per-tap MAC summed in uint32_t (wraps
// mod 2^32), then ONE fixed_add of the bias or of a zero word: exactly the
// accumulator of kernels/fixed_conv and of the composed sweep, so every
// partial conv wraps to total_bits where they do.  The word functions come
// from fixed_word.cuh, shared with the other fixed-point kernels.
// Saturating configs are rejected by the Python wrapper.
//
// Bound on an H100 SXM (3.35 TB/s; int32 on the CUDA cores 16.7 Tops/s):
// the function reads each input word once and writes each output word
// once, H*W*4 + 4*(H/4)(W/4)*4 bytes (5 per frame pixel; the halo's zeros
// are made, not read).  The least integer work it needs is about 18.5
// operations per frame pixel (only the words the pools read, each product
// of a word and a tap once; counted in chip_smoke.py frame_trunk_work), so
// a 1080x1920 frame is bound by bytes: 10.4 MB, 3.1 us.  This kernel
// computes each masked conv's products on their own, and each product is
// several instructions (a 64-bit product, shifts, the round bit), so it
// sits well above the bound.  No tensor core applies: every product is
// renormalized and wrapped before it is summed.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_word.cuh"

namespace {

constexpr int kHalo = 3;
constexpr int kMaxThreads = 256;

// tap subsets of the 2x2 kernel, one bit per row-major tap (dh, dw):
// 1 = (0,0), 2 = (0,1), 4 = (1,0), 8 = (1,1)
constexpr int T_ALL = 15, T_TOP = 3, T_BOT = 12, T_LEFT = 5, T_RIGHT = 10;
constexpr int T_00 = 1, T_01 = 2, T_10 = 4, T_11 = 8;

// Masked-tap conv word at (r, c) of a row-major map with row stride `ld`:
// the kept taps' products summed mod 2^32, then fixed_add(bias).
template <int kTaps>
__device__ __forceinline__ int32_t conv_at(const int32_t* m, int ld, int r,
                                           int c, const int32_t (&w)[4],
                                           int32_t bias, const FixedCfg& cfg) {
  const int32_t* p = m + r * ld + c;
  uint32_t acc = 0;
  if (kTaps & 1) acc += (uint32_t)fixed_mul(p[0], w[0], cfg);
  if (kTaps & 2) acc += (uint32_t)fixed_mul(p[1], w[1], cfg);
  if (kTaps & 4) acc += (uint32_t)fixed_mul(p[ld], w[2], cfg);
  if (kTaps & 8) acc += (uint32_t)fixed_mul(p[ld + 1], w[3], cfg);
  return fixed_add((int32_t)acc, bias, cfg);
}

__device__ __forceinline__ int32_t max4(int32_t a, int32_t b, int32_t c,
                                        int32_t d) {
  return max(max(a, b), max(c, d));
}

__global__ void frame_trunk_kernel(const int32_t* __restrict__ x,
                                   const int32_t* __restrict__ w1p,
                                   const int32_t* __restrict__ b1p,
                                   const int32_t* __restrict__ w2p,
                                   const int32_t* __restrict__ b2p,
                                   int32_t* __restrict__ out, int H, int W,
                                   int th, int tw, FixedCfg cfg) {
  extern __shared__ int32_t smem[];
  const int xh = th + kHalo, xw = tw + kHalo;     // staged input extent
  const int h1 = th / 2 + 1, w1 = tw / 2 + 1;     // level-1 extent with halo
  const int n1 = h1 * w1;
  int32_t* xs = smem;                             // (xh, xw) input words
  int32_t* qI = xs + xh * xw;                     // 4 x (h1, w1) level-1 quad
  int32_t* qB = qI + n1;
  int32_t* qR = qB + n1;
  int32_t* qC = qR + n1;
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int32_t wa[4] = {w1p[0], w1p[1], w1p[2], w1p[3]};
  const int32_t wb[4] = {w2p[0], w2p[1], w2p[2], w2p[3]};
  const int32_t b1 = b1p[0], b2 = b2p[0], z = 0;

  // 1. the tile plus its bottom/right halo; the frame's padding reads as 0
  const long long i0 = (long long)ti * th, j0 = (long long)tj * tw;
  for (int k = threadIdx.x; k < xh * xw; k += blockDim.x) {
    const long long gi = i0 + k / xw, gj = j0 + k % xw;
    xs[k] = (gi < H && gj < W) ? x[gi * W + gj] : 0;
  }
  __syncthreads();

  // 2. level 0 (4 masked-tap conv+PLAN maps) pooled into the level-1 quad
  for (int k = threadIdx.x; k < n1; k += blockDim.x) {
    const int r = k / w1, c = k % w1;
    const int a = 2 * r, b = 2 * c;               // level-0 window origin
    const int32_t ii00 = plan_sigmoid(conv_at<T_ALL>(xs, xw, a, b, wa, b1, cfg), cfg);
    const int32_t ii01 = plan_sigmoid(conv_at<T_ALL>(xs, xw, a, b + 1, wa, b1, cfg), cfg);
    const int32_t ii10 = plan_sigmoid(conv_at<T_ALL>(xs, xw, a + 1, b, wa, b1, cfg), cfg);
    const int32_t ii11 = plan_sigmoid(conv_at<T_ALL>(xs, xw, a + 1, b + 1, wa, b1, cfg), cfg);
    const int32_t li10 = plan_sigmoid(conv_at<T_TOP>(xs, xw, a + 1, b, wa, b1, cfg), cfg);
    const int32_t li11 = plan_sigmoid(conv_at<T_TOP>(xs, xw, a + 1, b + 1, wa, b1, cfg), cfg);
    const int32_t il01 = plan_sigmoid(conv_at<T_LEFT>(xs, xw, a, b + 1, wa, b1, cfg), cfg);
    const int32_t il11 = plan_sigmoid(conv_at<T_LEFT>(xs, xw, a + 1, b + 1, wa, b1, cfg), cfg);
    const int32_t ll11 = plan_sigmoid(conv_at<T_00>(xs, xw, a + 1, b + 1, wa, b1, cfg), cfg);
    // level 1's SAME padding: global level-1 row H/2 or column W/2 is zero
    const bool keep = ti * (th / 2) + r < H / 2 && tj * (tw / 2) + c < W / 2;
    qI[k] = keep ? max4(ii00, ii01, ii10, ii11) : 0;   // interior
    qB[k] = keep ? max4(ii00, ii01, li10, li11) : 0;   // last row
    qR[k] = keep ? max4(ii00, il01, ii10, il11) : 0;   // last col
    qC[k] = keep ? max4(ii00, il01, li10, ll11) : 0;   // corner
  }
  __syncthreads();

  // 3. level 1 (9 role maps, partial convs recombined with wraparound adds
  // in _sweep_stage's order), PLAN, pooled into the output quad tile
  const int h2 = th / 4, w2 = tw / 4, n2 = h2 * w2;
  for (int k = threadIdx.x; k < 4 * n2; k += blockDim.x) {
    const int role = k / n2, e = k % n2;
    const int r = e / w2, c = e % w2;
    const int a = 2 * r, b = 2 * c;               // level-1 window origin
    int32_t y;
    if (role == 0) {            // interior: s_ii2 over the whole window
      y = max4(plan_sigmoid(conv_at<T_ALL>(qI, w1, a, b, wb, b2, cfg), cfg),
               plan_sigmoid(conv_at<T_ALL>(qI, w1, a, b + 1, wb, b2, cfg), cfg),
               plan_sigmoid(conv_at<T_ALL>(qI, w1, a + 1, b, wb, b2, cfg), cfg),
               plan_sigmoid(conv_at<T_ALL>(qI, w1, a + 1, b + 1, wb, b2, cfg), cfg));
    } else if (role == 1) {     // last row: s_pi2 on the even row, s_li2 odd
      int32_t pi[2], li[2];
      for (int d = 0; d < 2; ++d) {
        pi[d] = plan_sigmoid(fixed_add(conv_at<T_TOP>(qI, w1, a, b + d, wb, b2, cfg),
                                       conv_at<T_BOT>(qB, w1, a, b + d, wb, z, cfg), cfg),
                             cfg);
        li[d] = plan_sigmoid(conv_at<T_TOP>(qB, w1, a + 1, b + d, wb, b2, cfg), cfg);
      }
      y = max4(pi[0], pi[1], li[0], li[1]);
    } else if (role == 2) {     // last col: s_ip2 on the even col, s_il2 odd
      int32_t ip[2], il[2];
      for (int d = 0; d < 2; ++d) {
        ip[d] = plan_sigmoid(fixed_add(conv_at<T_LEFT>(qI, w1, a + d, b, wb, b2, cfg),
                                       conv_at<T_RIGHT>(qR, w1, a + d, b, wb, z, cfg), cfg),
                             cfg);
        il[d] = plan_sigmoid(conv_at<T_LEFT>(qR, w1, a + d, b + 1, wb, b2, cfg), cfg);
      }
      y = max4(ip[0], il[0], ip[1], il[1]);
    } else {                    // corner: s_pp2, s_pl2, s_lp2, s_ll2
      const int32_t pp = plan_sigmoid(
          fixed_add(fixed_add(fixed_add(conv_at<T_00>(qI, w1, a, b, wb, b2, cfg),
                                        conv_at<T_01>(qR, w1, a, b, wb, z, cfg), cfg),
                              conv_at<T_10>(qB, w1, a, b, wb, z, cfg), cfg),
                    conv_at<T_11>(qC, w1, a, b, wb, z, cfg), cfg),
          cfg);
      const int32_t pl = plan_sigmoid(
          fixed_add(conv_at<T_00>(qR, w1, a, b + 1, wb, b2, cfg),
                    conv_at<T_10>(qC, w1, a, b + 1, wb, z, cfg), cfg),
          cfg);
      const int32_t lp = plan_sigmoid(
          fixed_add(conv_at<T_00>(qB, w1, a + 1, b, wb, b2, cfg),
                    conv_at<T_01>(qC, w1, a + 1, b, wb, z, cfg), cfg),
          cfg);
      const int32_t ll = plan_sigmoid(conv_at<T_00>(qC, w1, a + 1, b + 1, wb, b2, cfg), cfg);
      y = max4(pp, pl, lp, ll);
    }
    const long long oi = (long long)ti * h2 + r, oj = (long long)tj * w2 + c;
    out[((long long)role * (H / 4) + oi) * (W / 4) + oj] = y;
  }
}

}  // namespace

// The C interface (loaded with ctypes).  Makes `device` current for this
// thread, enqueues one launch on `stream` (grid: W/tw x H/th tiles), does
// not synchronise, and returns cudaGetLastError().  The wrapper keeps the
// tile's shared memory within the 48 KB a block gets without opting in.
extern "C" int frame_trunk_launch(int device, const int32_t* x,
                                  const int32_t* w1, const int32_t* b1,
                                  const int32_t* w2, const int32_t* b2,
                                  int32_t* out, int H, int W, int th, int tw,
                                  FixedCfg cfg, void* stream) {
  cudaSetDevice(device);
  const int n1 = (th / 2 + 1) * (tw / 2 + 1);
  const int smem = 4 * ((th + kHalo) * (tw + kHalo) + 4 * n1);
  int threads = ((n1 + 31) / 32) * 32;            // level-1 positions, whole warps
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(W / tw, H / th);
  frame_trunk_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, out, H, W, th, tw, cfg);
  return (int)cudaGetLastError();
}
