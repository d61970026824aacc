// The whole Qm.n smallNet forward in one launch, for sm_90a: ingested
// image words in, PLAN'd class-score words out.
//
// Replaces, on the served step, the per-stage Pallas TPU kernels of
// src/repro/kernels/fixed_conv/kernel.py (fixed_conv2d_pallas twice, with
// its fused PLAN and pool, then fixed_sigmoid_plan_pallas) and
// src/repro/kernels/quant_matmul/kernel.py (fixed_matmul_pallas): per
// image x (H, W),
//   level 1  conv 2x2 SAME (taps w1, bias b1) -> PLAN -> 2x2/2 max pool
//   level 2  the same with w2, b2
//   dense    flatten (K = (H/4)(W/4) words) @ wd (K, N) + bd -> PLAN
// (odd extents are cropped by the pools, as in the reference).  The
// per-stage kernels (csrc/fixed_conv.cu, csrc/fixed_dense.cu) stay for the
// composed stages and the frame sweep.
//
// Design (the layout and launch shape shared with float_net.cu are in
// smallnet_plan.cuh): a group of G warps takes one image at a time, G in
// {1, 2, 4, 8} chosen per launch: 8 where the batch fits on the card at
// once (B=64: a level-1 phase of one pass, the served step's latency), 1
// at large batches (B=16384: no thread of an image waits at a barrier for
// another phase, each warp walks over images).  A block is 8 warps, 8/G groups;
// the groups share the dense words (shared memory, loaded once per block),
// the taps and biases sit in registers.  Group g of the grid takes images
// g, g + groups, ...  Per image, in the group's own shared memory:
//   1. the image's H*W words, copied asynchronously (cp.async, 16-byte
//      vectors where W % 4 == 0) while the group computed level 2 and the
//      dense layer of the previous image; the buffer keeps a zero row and
//      zero columns past the image, SAME padding, so no tap is
//      bounds-checked;
//   2. level 1: a thread per pooled word, its 3x3 input window from shared
//      memory; 16 products, 4 conv words, 4 PLANs, a max of four; written
//      to a map with the same zero padding;
//   3. level 2 the same over the level-1 map;
//   4. the dense layer: S threads an output word (S a power of two, N*S
//      threads at most the group's, in passes where N is larger), each
//      summing every S-th product, the parts added by shuffles; bias,
//      PLAN; the N words of an image are stored together.
// Only the scores go back to device memory: the level-1 and level-2 maps
// never leave the SM.
//
// Arithmetic: Word<> of fixed_format.cuh.  The three wraparound
// STANDARD_CONFIGS have kernels specialised on their format; the
// saturating formats take the runtime FixedCfg, and there each stage keeps
// its own sum rule (a conv word fixed_add(wrap32(sum), b), a dense word
// fixed_add(wrap_total(wrap32(sum)), b): Word::conv and Word::dense).  The
// dense parts are added mod 2^32, as the sum is in every format.
//
// Bound on an H100 SXM (3.35 TB/s; int32 on the CUDA cores 16.7 Tops/s,
// 8 ops a conv word's four taps, 2 a dense MAC, as chip_smoke.py counts):
// a 28x28 image is 3,136 bytes in and 40 out against 8,820 ops, so the
// kernel is bound by bytes: B=16384 51.4 MB, 15.4 us (ops 8.6 us); at
// B=64 the bound is 60 ns and the launch and one image's latency through
// the four phases are the whole cost.  At large batches the instructions
// hold it back: a level-1 pooled word is about 160 SASS instructions
// (ptxas makes a rounded product four: IMAD.WIDE, the 64-bit add of the
// rounding bit, the funnel shift and sum in one LEA.HI; a PLAN word about
// a dozen), and an image asks for 245 pooled words and 490 dense MACs.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_format.cuh"
#include "smallnet_plan.cuh"

namespace {

using smallnet::kWarps;
using smallnet::Layout;

// The pooled conv word at pooled position (r, c) of a map `s` with row
// stride `ld`: conv 2x2 SAME + PLAN at the four positions of its 2x2
// window, then the max.  The 3x3 input window may reach into the zero
// padding.
template <class F>
__device__ __forceinline__ int32_t pooled_word(const F& f, const int32_t* s, int ld, int r,
                                               int c, const int32_t (&w)[4], int32_t bias) {
  const int32_t* q = s + 2 * r * ld + 2 * c;
  int32_t p[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) p[a][b] = q[a * ld + b];
  int32_t y[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      y[i][j] = f.act(f.mul(p[i][j], w[0]) + f.mul(p[i][j + 1], w[1]) +
                      f.mul(p[i + 1][j], w[2]) + f.mul(p[i + 1][j + 1], w[3]),
                      bias);
  return max4(y[0][0], y[0][1], y[1][0], y[1][1]);
}

template <int kFrac, int kTotal, int kRound>
__global__ void __launch_bounds__(32 * kWarps, 4)
fixed_smallnet_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w1p,
                      const int32_t* __restrict__ b1p, const int32_t* __restrict__ w2p,
                      const int32_t* __restrict__ b2p, const int32_t* __restrict__ wd,
                      const int32_t* __restrict__ bd, int32_t* __restrict__ out, int B,
                      int H, int W, int N, int G, int S, int vec, FixedCfg cfg) {
  extern __shared__ int4 smem4[];
  const auto F = Word<kFrac, kTotal, kRound>::make(cfg);
  const int H1 = H / 2, W1 = W / 2, H2 = H1 / 2, W2 = W1 / 2;
  const int n1 = H1 * W1, K = H2 * W2;
  const Layout L(H, W);
  const int GT = 32 * G, groups = kWarps / G;
  const int group = threadIdx.x / GT, t = threadIdx.x - group * GT;
  int32_t* ws = reinterpret_cast<int32_t*>(smem4);    // (K, N) dense words
  int32_t* bs = ws + round4(K * N);                    // (N,)
  int32_t* xs = bs + round4(N) + group * L.words;      // (H, W), padded
  int32_t* l1 = xs + L.buf;                            // (H1, W1), padded
  int32_t* l2 = l1 + L.l1;                             // (H2, W2), the dense input
  const int32_t wa[4] = {w1p[0], w1p[1], w1p[2], w1p[3]};
  const int32_t wb[4] = {w2p[0], w2p[1], w2p[2], w2p[3]};
  const int32_t b1 = b1p[0], b2 = b2p[0];
  // the padding is zero: clear the groups' maps once, they write only
  // inside the maps
  int32_t* all = bs + round4(N);
  for (int i = threadIdx.x; i < groups * L.words; i += blockDim.x) all[i] = 0;
  for (int i = threadIdx.x; i < K * N; i += blockDim.x) ws[i] = wd[i];
  for (int i = threadIdx.x; i < N; i += blockDim.x) bs[i] = bd[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * groups;
  long long img = (long long)blockIdx.x * groups + group;
  if (img < B) smallnet::fetch_image(xs, x + img * H * W, H, W, L.ld0, vec, t, GT);
  for (; img < B; img += stride) {
    // the image has arrived, and the previous image's dense layer is done
    // with l2 (level 2 writes it after the next barrier)
    wait_copies();
    group_sync(group, GT);
    {
      Walk p(t, GT, W1);
      for (int i = t; i < n1; i += GT, p.next())
        l1[p.r * L.ld1 + p.c] = pooled_word(F, xs, L.ld0, p.r, p.c, wa, b1);
    }
    group_sync(group, GT);
    // level 1 was the image's only reader: the next image's copies run
    // while this one's level 2 and dense layer are computed
    if (img + stride < B)
      smallnet::fetch_image(xs, x + (img + stride) * H * W, H, W, L.ld0, vec, t, GT);
    {
      Walk p(t, GT, W2);
      for (int i = t; i < K; i += GT, p.next())
        l2[i] = pooled_word(F, l1, L.ld1, p.r, p.c, wb, b2);
    }
    group_sync(group, GT);
    for (int n0 = 0; n0 < N; n0 += GT / S) {
      if (n0 + (t & ~31) / S >= N) break;               // no output in this warp
      const int n = n0 + t / S;
      uint32_t acc = 0;
      if (n < N)
        for (int k = t % S; k < K; k += S) acc += F.mul(l2[k], ws[k * N + n]);
      for (int d = 1; d < S; d *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, d);
      if (n < N && t % S == 0) out[img * N + n] = F.plan(F.dense(acc, bs[n]));
    }
  }
}

template <int kFrac, int kTotal, int kRound>
int launch(const int32_t* x, const int32_t* w1, const int32_t* b1, const int32_t* w2,
           const int32_t* b2, const int32_t* wd, const int32_t* bd, int32_t* out, int B,
           int H, int W, int N, const FixedCfg& cfg, int device, cudaStream_t stream) {
  const auto kernel = fixed_smallnet_kernel<kFrac, kTotal, kRound>;
  smallnet::Shape s;
  const int rc = smallnet::shape_of((const void*)kernel, device, x, B, H, W, N, s);
  if (rc != 0) return rc;
  kernel<<<s.grid, 32 * kWarps, s.smem, stream>>>(x, w1, b1, w2, b2, wd, bd, out, B, H, W, N,
                                                   s.G, s.S, s.vec, cfg);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (loaded with ctypes).
//
// fixed_smallnet_fits: 1 where the kernel takes (H, W) images and N
// classes, 0 where it does not.
extern "C" int fixed_smallnet_fits(int H, int W, int N) { return smallnet::fits(H, W, N); }

// fixed_smallnet_launch: makes `device` current for this thread, enqueues
// one launch on `stream`, does not synchronise, and returns a CUDA error
// code, or kShapeUnsupported where !fits(H, W, N).  x (B, H, W), w1/w2 (4,)
// taps, b1/b2 (1,), wd (K, N), bd (N,) -> out (B, N), all int32 words.
extern "C" int fixed_smallnet_launch(int device, const int32_t* x, const int32_t* w1,
                                     const int32_t* b1, const int32_t* w2,
                                     const int32_t* b2, const int32_t* wd,
                                     const int32_t* bd, int32_t* out, int B, int H, int W,
                                     int N, FixedCfg cfg, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  return dispatch_format(cfg, [&](auto f) {
    using Fm = decltype(f);
    return launch<Fm::kFrac, Fm::kTotal, Fm::kRound>(x, w1, b1, w2, b2, wd, bd, out, B, H,
                                                     W, N, cfg, device, s);
  });
}
