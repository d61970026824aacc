// One stage of the float frame sweep in one launch: the 2x2 SAME conv, the
// activation and the 2x2/2 max pool of all four role maps, for sm_90a; and,
// at the end of the file, the sweep's window head in one launch.
//
// Replaces no single pallas_call.  The reference jits the whole cascade of
// src/repro/streaming/fcn_sweep.py `_sweep_stage` into one XLA program a
// geometry: conv2d_pallas (kernels/conv2d/kernel.py), sigmoid_pla_pallas
// (kernels/sigmoid_pla/kernel.py) and maxpool2d_pallas
// (kernels/maxpool2d/kernel.py) over eight masked copies of the conv's
// weights, with the pre-activation adds and pool mixes between them.  The
// port ran that cascade eagerly: a stage took up to 16 conv2d, 8
// sigmoid_pla and 1 maxpool2d launches, 8 masked weights (each an upload
// of its mask) and a dozen torch ops, and the host's issuing of them set
// the frame rate.  This kernel computes the same stage in one launch:
//
//   inputs   the quad (I, B, R, C), four (h, w) float32 maps; at level 0
//            one map, the frame, stands for all four (`level0`)
//   output   (4, h/2, w/2) float32: the pooled [interior, last_row,
//            last_col, corner] of `_sweep_stage`, in its order
//
// Design.  A thread computes one pooled position of all four outputs; a
// block of kTH x kTW of them first stages each source's (2 kTH + 1) x
// (2 kTW + 1) input tile in shared memory, what lies past the bottom or
// right edge stored as zero (SAME's padding: 0 before, 1 after).  A thread
// then reads its 3x3 window of each source and computes the 16 conv outputs
// its pool windows use, and only those: s_ii x4; s_pi, s_li x2 each; s_ip,
// s_il x2 each; s_pp, s_pl, s_lp, s_ll x1 each (9 at level 0, where the
// mixed maps collapse onto single-source ones as in `_sweep_stage`).  A
// masked tap is left out: in the composed route a zeroed tap adds exactly
// 0.
//
// Exactness.  The composed route's words on the card are the target, so
// every rounding is written as it happens there: a masked conv is the
// tiled conv2d's chain (its first kept tap a product, each later one an
// FMA, as nvcc contracts conv2d_tile_kernel's `acc += x * w`, in (dh, dw)
// order), then + bias; the partials are added in `_sweep_stage`'s nesting
// (torch's add), then the activation and the max with torch.maximum's NaN
// rule, both float_format.cuh's.  __fmul_rn/__fmaf_rn/__fadd_rn keep nvcc
// from contracting otherwise.  With the exact sigmoid the composed route
// takes torch.sigmoid for the mixed maps and this kernel sigmoid_f32, so
// there the two may differ in an ulp.
//
// Bounds on an H100 SXM (3.35 TB/s), bytes: the quad read once, the pooled
// quad written once.  112x112 frame: level 0 reads 50,176 B and writes
// 50,176 B (0.030 us), level 1 reads 50,176 B and writes 12,544 B (0.019
// us); the launch's latency, microseconds, binds both, so the design's aim
// there is one launch for what took 8 and 25.  720x1280 frame: level 0
// 7.37 MB (2.20 us), level 1 4.61 MB (1.38 us); a thread's 16 outputs
// (about 200 float operations) keep it well below the 67 TFLOP/s CUDA-core
// peak, so bytes bind, and the staged tiles read each input float about
// once from device memory (the halo row and column are read by two
// blocks).
#include <cuda_runtime.h>

#include "float_format.cuh"
#include "launch_error.cuh"

namespace {

constexpr int kTH = 8, kTW = 32;                       // pooled positions of a block
constexpr int kThreads = kTH * kTW;
constexpr int kIH = 2 * kTH + 1, kIW = 2 * kTW + 1;    // a source's staged tile

// tap masks, bit k for tap k = dh * 2 + dw of the 2x2 kernel
constexpr int kAll = 0b1111;
constexpr int kTop = 0b0011, kBot = 0b1100;            // kernel row 0 | row 1
constexpr int kLeft = 0b0101, kRight = 0b1010;         // kernel col 0 | col 1
constexpr int k00 = 0b0001, k01 = 0b0010, k10 = 0b0100, k11 = 0b1000;

// A thread's 3x3 window of one source: v[i][j] = src[2r + i][2c + j]
using Window = float[3][3];

// The conv with the taps of kMask at conv position (2r + dy, 2c + dx),
// then + bias: the tiled conv2d's rounding (see the note above)
template <int kMask>
__device__ __forceinline__ float conv(const Window& v, int dy, int dx, const float (&w)[4],
                                      float bias) {
  const float x[4] = {v[dy][dx], v[dy][dx + 1], v[dy + 1][dx], v[dy + 1][dx + 1]};
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (kMask >> k & 1) {
      acc = first ? __fmul_rn(x[k], w[k]) : __fmaf_rn(x[k], w[k], acc);
      first = false;
    }
  }
  return __fadd_rn(acc, bias);
}

__device__ __forceinline__ float pool(float a, float b, float c, float d) {
  return max_nan(max_nan(a, b), max_nan(c, d));
}

template <int kAct, bool kLevel0>
__global__ void __launch_bounds__(kThreads)
float_sweep_stage_kernel(const float* __restrict__ I, const float* __restrict__ Bm,
                         const float* __restrict__ R, const float* __restrict__ C,
                         const float* __restrict__ wt, const float* __restrict__ bt,
                         float* __restrict__ out, int h, int w) {
  constexpr int kSources = kLevel0 ? 1 : 4;
  __shared__ float tile[kSources][kIH][kIW];
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const float* src[4] = {I, Bm, R, C};
#pragma unroll
  for (int s = 0; s < kSources; ++s) {
    for (int i = threadIdx.x; i < kIH * kIW; i += kThreads) {
      const int y = i / kIW, x = i - y * kIW;
      const int gy = 2 * r0 + y, gx = 2 * c0 + x;
      tile[s][y][x] = gy < h && gx < w ? src[s][(long long)gy * w + gx] : 0.0f;
    }
  }
  const float wk[4] = {wt[0], wt[1], wt[2], wt[3]};
  const float b = bt[0];
  __syncthreads();
  const int ty = threadIdx.x / kTW, tx = threadIdx.x - ty * kTW;
  const int h2 = h / 2, w2 = w / 2, r = r0 + ty, c = c0 + tx;
  if (r >= h2 || c >= w2) return;
  Window v[kSources];
#pragma unroll
  for (int s = 0; s < kSources; ++s)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) v[s][i][j] = tile[s][2 * ty + i][2 * tx + j];
  const auto act = [](float x) { return activate<kAct>(x); };

  // conv outputs by (row, col) of the pool window; _sweep_stage's names
  float ii[2][2], pi[2], li[2], ip[2], il[2], pp, pl, lp, ll;
  const Window& vI = v[0];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) ii[dy][dx] = act(conv<kAll>(vI, dy, dx, wk, b));
  if constexpr (kLevel0) {
    // role-independent pixels: the masks partition the kernel over one
    // source, so every mixed map is a single-source one
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      pi[d] = ii[0][d];                                // s_pi = s_ii
      li[d] = act(conv<kTop>(vI, 1, d, wk, b));        // last row
      ip[d] = ii[d][0];                                // s_ip = s_ii
      il[d] = act(conv<kLeft>(vI, d, 1, wk, b));       // last col
    }
    pp = ii[0][0];                                     // s_pp = s_ii
    pl = il[0];                                        // s_pl = s_il
    lp = li[0];                                        // s_lp = s_li
    ll = act(conv<k00>(vI, 1, 1, wk, b));              // corner
  } else {
    const Window &vB = v[1], &vR = v[2], &vC = v[3];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      pi[d] = act(__fadd_rn(conv<kTop>(vI, 0, d, wk, b),         // prelast row
                            conv<kBot>(vB, 0, d, wk, 0.0f)));
      li[d] = act(conv<kTop>(vB, 1, d, wk, b));                   // last row
      ip[d] = act(__fadd_rn(conv<kLeft>(vI, d, 0, wk, b),        // prelast col
                            conv<kRight>(vR, d, 0, wk, 0.0f)));
      il[d] = act(conv<kLeft>(vR, d, 1, wk, b));                  // last col
    }
    pp = act(__fadd_rn(__fadd_rn(__fadd_rn(conv<k00>(vI, 0, 0, wk, b),
                                           conv<k01>(vR, 0, 0, wk, 0.0f)),
                                 conv<k10>(vB, 0, 0, wk, 0.0f)),
                       conv<k11>(vC, 0, 0, wk, 0.0f)));
    pl = act(__fadd_rn(conv<k00>(vR, 0, 1, wk, b), conv<k10>(vC, 0, 1, wk, 0.0f)));
    lp = act(__fadd_rn(conv<k00>(vB, 1, 0, wk, b), conv<k01>(vC, 1, 0, wk, 0.0f)));
    ll = act(conv<k00>(vC, 1, 1, wk, b));
  }
  const long long plane = (long long)h2 * w2, at = (long long)r * w2 + c;
  out[at] = pool(ii[0][0], ii[0][1], ii[1][0], ii[1][1]);      // maxpool2x2(s_ii)
  out[plane + at] = pool(pi[0], pi[1], li[0], li[1]);          // pool_mix(s_pi, s_li)
  out[2 * plane + at] = pool(ip[0], il[0], ip[1], il[1]);      // pool_quadrants(s_ip, s_il, ...)
  out[3 * plane + at] = pool(pp, pl, lp, ll);                  // pool_quadrants(s_pp, s_pl, s_lp, s_ll)
}

template <int kAct, bool kLevel0>
int launch(const float* I, const float* Bm, const float* R, const float* C, const float* w,
           const float* b, float* out, int h, int wd, cudaStream_t stream) {
  const dim3 grid((unsigned)((wd / 2 + kTW - 1) / kTW), (unsigned)((h / 2 + kTH - 1) / kTH));
  float_sweep_stage_kernel<kAct, kLevel0><<<grid, kThreads, 0, stream>>>(I, Bm, R, C, w, b,
                                                                         out, h, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue on
// `stream`, no synchronisation, return cudaGetLastError() or
// kShapeUnsupported.
//
// I, B, R, C: (h, w) float32 maps, contiguous (the same pointer four times
// at level 0, where only I is read); w the 4 taps in (dh, dw) order, b the
// bias; out (4, h/2, w/2) float32.  h and w even and at least 2; `act` 1
// the exact sigmoid, 2 PLAN.
extern "C" int float_sweep_stage_launch(int device, const float* I, const float* B,
                                        const float* R, const float* C, const float* w,
                                        const float* b, float* out, int h, int wd, int level0,
                                        int act, void* stream) {
  if (h < 2 || wd < 2 || h % 2 || wd % 2 || (h / 2 + kTH - 1) / kTH > 65535 ||
      (act != kSigmoid && act != kPlan))
    return kShapeUnsupported;
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  if (act == kPlan)
    return level0 ? launch<kPlan, true>(I, B, R, C, w, b, out, h, wd, s)
                  : launch<kPlan, false>(I, B, R, C, w, b, out, h, wd, s);
  return level0 ? launch<kSigmoid, true>(I, B, R, C, w, b, out, h, wd, s)
                : launch<kSigmoid, false>(I, B, R, C, w, b, out, h, wd, s);
}

// The float frame sweep's window head in one launch: each window's k x k
// features read straight from the four level-2 role maps, the dense layer
// and the output activation.
//
// Replaces no single pallas_call either: the reference's float head is
// XLA's gather and matmul, then sigmoid_pla_pallas (kernels/sigmoid_pla/
// kernel.py) with PLAN; the port composed a stack of the maps, an index
// gather, torch.matmul (cuBLAS: a sgemm and its split-K reduction), the
// bias add and the sigmoid_pla launch, six device ops a frame.
//
//   inputs   the four (mh, mw) float32 maps [interior, last_row, last_col,
//            corner]; the windows' pooled offsets gy, gx (Nw,) int32; the
//            dense w (k*k, N) and b (N,)
//   output   (Nw, N) float32 scores, the activation applied
//
// Design.  A block scores kHeadThreads / N whole windows.  Its threads first
// stage w, b and each of its windows' k x k features in shared memory, every
// load independent of the others: feature (i, j) of a window comes from map
// is_last_row(i) + 2 * is_last_col(j) at the window's offset (the rule of
// quant_matmul/ops.window_gather_index).  A thread then computes one (window,
// class) score from shared memory, summed in k order with __fmaf_rn, then + b,
// then the activation of float_format.cuh.  (A first design read each feature
// from device memory inside that sum: 49 loads, each waited for in turn, took
// 6.9 us a 112x112 frame on the H100.)  The N threads of a window read the
// same features (a broadcast) and consecutive words of w.  The sum's order
// differs from cuBLAS's, so the scores agree with the composed head within
// rounding, not bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s), bytes: the maps read once and the
// scores written once.  112x112 frame (28x28 maps, 144 windows, N 10):
// 12,544 B of maps, 5,760 B of scores and 3,152 B of params and offsets,
// 0.0064 us; the launch's latency binds, which a CUDA graph of the whole
// frame hides.  720x1280 frame (180x320 maps, 13,904 windows): 1,590,992
// B, 0.47 us, against 49 FMAs a score, 13.6 MFLOP, 0.20 us at 67 TFLOP/s.
namespace {

constexpr int kHeadThreads = 128;
constexpr int kHeadSmemFloats = 48 * 1024 / 4;          // static limit, no opt-in

template <int kAct>
__global__ void __launch_bounds__(kHeadThreads)
float_window_head_kernel(const float* __restrict__ I, const float* __restrict__ Bm,
                         const float* __restrict__ R, const float* __restrict__ C,
                         const int* __restrict__ gy, const int* __restrict__ gx,
                         const float* __restrict__ w, const float* __restrict__ b,
                         float* __restrict__ out, int Nw, int mh, int mw, int k, int N) {
  extern __shared__ float head_smem[];
  const int K = k * k, per_block = kHeadThreads / N;
  float* ws = head_smem;
  float* bs = ws + K * N;
  float* xs = bs + N;                                  // per_block windows' features
  const long long w0 = (long long)blockIdx.x * per_block;
  const int windows = (int)min((long long)per_block, Nw - w0);
  for (int i = threadIdx.x; i < K * N; i += kHeadThreads) ws[i] = w[i];
  for (int i = threadIdx.x; i < N; i += kHeadThreads) bs[i] = b[i];
  for (int i = threadIdx.x; i < windows * K; i += kHeadThreads) {
    const int r = i / K, e = i - r * K, fi = e / k, fj = e - fi * k;
    const int y = gy[w0 + r], x = gx[w0 + r];
    // a window past the maps is the caller's fault: stop the kernel with an
    // error, as a device-side assert does, rather than read past them
    if (y < 0 || x < 0 || y > mh - k || x > mw - k) __trap();
    const bool lr = fi == k - 1, lc = fj == k - 1;
    const float* m = lr ? (lc ? C : Bm) : (lc ? R : I);
    xs[i] = m[(long long)(y + fi) * mw + x + fj];
  }
  __syncthreads();
  const int r = threadIdx.x / N, n = threadIdx.x - r * N;
  if (r >= windows) return;
  const float* xr = xs + r * K;
  float acc = 0.0f;
#pragma unroll 7
  for (int e = 0; e < K; ++e) acc = __fmaf_rn(xr[e], ws[e * N + n], acc);
  out[(w0 + r) * N + n] = activate<kAct>(__fadd_rn(acc, bs[n]));
}

template <int kAct>
int launch_head(const float* I, const float* Bm, const float* R, const float* C, const int* gy,
                const int* gx, const float* w, const float* b, float* out, int Nw, int mh,
                int mw, int k, int N, cudaStream_t stream) {
  const int per_block = kHeadThreads / N;
  const unsigned blocks = (unsigned)((Nw + per_block - 1) / per_block);
  const size_t smem = sizeof(float) * ((size_t)k * k * (N + per_block) + N);
  float_window_head_kernel<kAct><<<blocks, kHeadThreads, smem, stream>>>(I, Bm, R, C, gy, gx,
                                                                         w, b, out, Nw, mh,
                                                                         mw, k, N);
  return (int)cudaGetLastError();
}

}  // namespace

// float_window_head_launch: the four (mh, mw) float32 role maps, the
// windows' pooled offsets gy, gx (Nw,) int32, w (k*k, N) and b (N,) ->
// out (Nw, N) float32, the activation `act` applied (1 the exact sigmoid, 2
// PLAN).  kShapeUnsupported for N > 128 (a block scores whole windows) and
// where w, b and the block's features exceed 48 KB of shared memory; a
// window past the maps traps the kernel.  Nw >= 1.
extern "C" int float_window_head_launch(int device, const float* I, const float* B,
                                        const float* R, const float* C, const int* gy,
                                        const int* gx, const float* w, const float* b,
                                        float* out, int Nw, int mh, int mw, int k, int N,
                                        int act, void* stream) {
  if (Nw < 1 || k < 1 || N < 1 || N > kHeadThreads || k > mh || k > mw ||
      (long long)k * k * (N + kHeadThreads / N) + N > kHeadSmemFloats ||
      (act != kSigmoid && act != kPlan))
    return kShapeUnsupported;
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  return act == kPlan ? launch_head<kPlan>(I, B, R, C, gy, gx, w, b, out, Nw, mh, mw, k, N, s)
                      : launch_head<kSigmoid>(I, B, R, C, gy, gx, w, b, out, Nw, mh, mw, k, N,
                                              s);
}
