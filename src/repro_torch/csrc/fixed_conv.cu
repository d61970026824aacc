// Fixed-point conv stage, 2x2/2 max pool and PLAN sigmoid for sm_90a.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/fixed_conv/kernel.py:
//   fixed_conv2d_launch     <- fixed_conv2d_pallas (_fixed_conv_kernel)
//   fixed_maxpool2x2_launch <- fixed_maxpool2x2_pallas (_fixed_pool_kernel)
//   fixed_sigmoid_launch    <- fixed_sigmoid_plan_pallas (_fixed_plan_kernel)
//
// Design: one thread per output word, int32 words straight from device
// memory.  The TPU kernels hold a whole pre-padded image in VMEM per grid
// step; here an out-of-range tap reads as zero, so the SAME pad (0 before,
// 1 after) needs no padded copy, and a fused-pool thread computes its four
// conv words and their max in registers.  Every product is renormalized and
// wrapped before it is summed, so neither tensor cores nor cuBLAS compute
// this function: it runs on the CUDA cores.
//
// Bounds on an H100 SXM (3.35 TB/s; int32 on CUDA cores 16.7 Tops/s, i.e.
// 132 SMs x 64 INT32 lanes x 1.98 GHz; 2 ops per tap multiply-accumulate):
//   engine shapes, B=64:  conv 28x28->14x14 moves 251 KB (75 ns) against
//     0.40 Mops (24 ns); conv 14x14->7x7 63 KB (19 ns); sigmoid (64,10)
//     5 KB (2 ns).  Each launch is therefore bound by launch latency (a few
//     microseconds), far above either bound.
//   large shapes: B=16384 conv 28x28->14x14 moves 64 MB (19 us) against
//     103 Mops (6 us): bytes bound, as is a 512x512 frame (1.3 MB, 0.4 us).
// These kernels now serve the composed stages (and the frame sweep's
// composed cascade): at the served shapes each launch costs its launch
// latency, so a served step on fixed_cuda no longer takes them.  It is one
// launch of csrc/fixed_net.cu, the whole net per image in shared memory
// (bound at B=64: 60 ns of bytes; at B=16384: 51.4 MB, 15.4 us), where
// these kernels take four launches and move every pooled map through
// device memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_word.cuh"

namespace {

constexpr int kThreads = 256;

// One conv word at (h, w) of a (H, W) image: 4-tap MAC, bias, optional PLAN.
__device__ __forceinline__ int32_t conv_word(const int32_t* __restrict__ img,
                                             int H, int W, int h, int w,
                                             const int32_t (&taps)[4],
                                             int32_t bias, int plan,
                                             const FixedCfg& c) {
  const bool right = w + 1 < W;
  const bool down = h + 1 < H;
  const long long row = (long long)h * W;
  const int32_t x00 = img[row + w];
  const int32_t x01 = right ? img[row + w + 1] : 0;
  const int32_t x10 = down ? img[row + W + w] : 0;
  const int32_t x11 = (down && right) ? img[row + W + w + 1] : 0;
  uint32_t acc = (uint32_t)fixed_mul(x00, taps[0], c);
  acc += (uint32_t)fixed_mul(x01, taps[1], c);
  acc += (uint32_t)fixed_mul(x10, taps[2], c);
  acc += (uint32_t)fixed_mul(x11, taps[3], c);
  int32_t y = fixed_add((int32_t)acc, bias, c);
  if (plan) y = plan_sigmoid(y, c);
  return y;
}

__global__ void fixed_conv2d_kernel(const int32_t* __restrict__ x,
                                    const int32_t* __restrict__ w4,
                                    const int32_t* __restrict__ b,
                                    int32_t* __restrict__ out, int B, int H,
                                    int W, int Ho, int Wo, int stride, int plan,
                                    int pool, FixedCfg c) {
  const long long n = (long long)B * Ho * Wo;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ow = (int)(i % Wo);
  const long long t = i / Wo;
  const int oh = (int)(t % Ho);
  const long long bi = t / Ho;
  const int32_t* img = x + bi * H * W;
  const int32_t taps[4] = {w4[0], w4[1], w4[2], w4[3]};
  const int32_t bias = b[0];
  int32_t y;
  if (pool) {
    // comparator tree over the 2x2 window of conv words; odd extents are
    // cropped because Ho = H/2, Wo = W/2
    const int h = 2 * oh, w = 2 * ow;
    const int32_t y00 = conv_word(img, H, W, h, w, taps, bias, plan, c);
    const int32_t y01 = conv_word(img, H, W, h, w + 1, taps, bias, plan, c);
    const int32_t y10 = conv_word(img, H, W, h + 1, w, taps, bias, plan, c);
    const int32_t y11 = conv_word(img, H, W, h + 1, w + 1, taps, bias, plan, c);
    y = max(max(y00, y01), max(y10, y11));
  } else {
    // stride decimates the stride-1 output: only the kept words are computed
    y = conv_word(img, H, W, oh * stride, ow * stride, taps, bias, plan, c);
  }
  out[i] = y;
}

__global__ void fixed_maxpool2x2_kernel(const int32_t* __restrict__ x,
                                        int32_t* __restrict__ out, int B,
                                        int H, int W, int Ho, int Wo) {
  const long long n = (long long)B * Ho * Wo;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ow = (int)(i % Wo);
  const long long t = i / Wo;
  const int oh = (int)(t % Ho);
  const long long bi = t / Ho;
  const int32_t* p = x + (bi * H + 2 * oh) * W + 2 * ow;
  out[i] = max(max(p[0], p[1]), max(p[W], p[W + 1]));
}

__global__ void fixed_sigmoid_kernel(const int32_t* __restrict__ x,
                                     int32_t* __restrict__ out, long long n,
                                     FixedCfg c) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = plan_sigmoid(x[i], c);
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// The C interface (loaded with ctypes).  Each launcher makes `device`
// current for this thread, enqueues one kernel on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int fixed_conv2d_launch(int device, const int32_t* x,
                                   const int32_t* w4, const int32_t* b,
                                   int32_t* out, int B, int H, int W, int Ho,
                                   int Wo, int stride, int plan, int pool,
                                   FixedCfg cfg, void* stream) {
  cudaSetDevice(device);
  const long long n = (long long)B * Ho * Wo;
  fixed_conv2d_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, w4, b, out, B, H, W, Ho, Wo, stride, plan, pool, cfg);
  return (int)cudaGetLastError();
}

extern "C" int fixed_maxpool2x2_launch(int device, const int32_t* x,
                                       int32_t* out, int B, int H, int W,
                                       int Ho, int Wo, void* stream) {
  cudaSetDevice(device);
  const long long n = (long long)B * Ho * Wo;
  fixed_maxpool2x2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, B, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}

extern "C" int fixed_sigmoid_launch(int device, const int32_t* x,
                                    int32_t* out, long long n, FixedCfg cfg,
                                    void* stream) {
  cudaSetDevice(device);
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 32) grid = 132 * 32;   // grid-stride beyond 32 blocks/SM
  fixed_sigmoid_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, cfg);
  return (int)cudaGetLastError();
}
