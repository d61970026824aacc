// Float NHWC conv, 2x2/2 max pool and PLAN sigmoid for sm_90a.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/:
//   conv2d_launch      <- conv2d_pallas (_conv_kernel), conv2d/kernel.py
//   maxpool2d_launch   <- maxpool2d_pallas (_pool_kernel), maxpool2d/kernel.py
//   sigmoid_pla_launch <- sigmoid_pla_pallas (_plan_kernel), sigmoid_pla/kernel.py
//
// Design: one thread per output element, straight from device memory.
//   * conv: a TPU program holds a whole pre-padded image in VMEM and does one
//     (H*W,Cin)@(Cin,Cout) MXU dot per tap.  Here thread (b, i, j, co) sums
//     its taps in (dh, dw) order and Cin inside each tap, as the reference
//     accumulates, reading input (i*stride+dh, j*stride+dw): a tap past the
//     bottom or right edge is SAME's zero padding (0 before, k-1 after), so
//     no padded copy is made, and only the kept (strided) outputs are
//     computed.  Then the bias, then the optional epilogue.  nvcc may
//     contract a product and its sum into an FMA; the conv is held to its
//     plain version within a tolerance, not bit for bit.
//   * PLAN: the same __device__ function serves the standalone sigmoid and
//     the conv's fused epilogue.  Its affine pieces are written with
//     __fmul_rn/__fadd_rn so no contraction can move the last bit: it gives
//     the float of the plain version's separate PyTorch ops.
//   * pool: crops odd extents (reads only the even part), f32 or bf16, NaN
//     propagating as torch.maximum does; exact in both types.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA cores):
//   engine shapes, B=64, Cin=Cout=1: conv 28x28 moves 401 KB (0.12 us)
//     against 0.45 MFLOP (7 ns); the pools 251 KB and 63 KB; PLAN (64,10)
//     5 KB.  Every launch is bound by launch latency (microseconds), far
//     above either bound, so the design stays plain.
//   large: a 512x512 stride-2 frame, 2^24-word PLAN: bytes bound.
// The sweep's many small launches per frame are the lever (fusing them, or
// a CUDA graph), which is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_error.cuh"

namespace {

constexpr int kThreads = 256;
enum Activation { kNone = 0, kSigmoid = 1, kPlan = 2 };

// PLAN sigmoid (breakpoints 1, 2.375, 5; odd symmetry through x < 0).
__device__ __forceinline__ float plan_sigmoid_f32(float x) {
  const float ax = fabsf(x);
  float y;
  if (ax >= 5.0f)
    y = 1.0f;
  else if (ax >= 2.375f)
    y = __fadd_rn(__fmul_rn(0.03125f, ax), 0.84375f);
  else if (ax >= 1.0f)
    y = __fadd_rn(__fmul_rn(0.125f, ax), 0.625f);
  else
    y = __fadd_rn(__fmul_rn(0.25f, ax), 0.5f);
  return x < 0.0f ? __fsub_rn(1.0f, y) : y;
}

__global__ void conv2d_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              float* __restrict__ out, int B, int H, int W,
                              int Cin, int kh, int kw, int Cout, int Ho, int Wo,
                              int stride, int act) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Ho * Wo * Cout) return;
  const int co = (int)(i % Cout);
  long long r = i / Cout;
  const int oj = (int)(r % Wo);
  r /= Wo;
  const int oi = (int)(r % Ho);
  const long long img = r / Ho;
  const float* xb = x + img * H * W * Cin;
  float acc = 0.0f;
  for (int dh = 0; dh < kh; ++dh) {
    const int h = oi * stride + dh;
    if (h >= H) break;                       // SAME's bottom zero rows
    for (int dw = 0; dw < kw; ++dw) {
      const int c = oj * stride + dw;
      if (c >= W) break;                     // SAME's right zero columns
      const float* px = xb + ((long long)h * W + c) * Cin;
      const float* wt = w + (long long)(dh * kw + dw) * Cin * Cout + co;
      for (int ci = 0; ci < Cin; ++ci) acc += px[ci] * wt[(long long)ci * Cout];
    }
  }
  acc += b[co];
  if (act == kSigmoid)
    acc = 1.0f / (1.0f + expf(-acc));
  else if (act == kPlan)
    acc = plan_sigmoid_f32(acc);
  out[i] = acc;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// torch.maximum's rule: a NaN operand propagates.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  const float fa = as_float(a), fb = as_float(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa < fb ? b : a;
}

template <typename T>
__global__ void maxpool2d_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int B, int H, int W, int C, int Ho, int Wo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Ho * Wo * C) return;
  const int c = (int)(i % C);
  long long r = i / C;
  const int oj = (int)(r % Wo);
  r /= Wo;
  const int oi = (int)(r % Ho);
  const long long img = r / Ho;
  const long long row = (long long)W * C;
  const T* p = x + ((img * H + 2 * oi) * W + 2 * oj) * C + c;
  out[i] = max_nan(max_nan(p[0], p[C]), max_nan(p[row], p[row + C]));
}

__global__ void sigmoid_pla_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = plan_sigmoid_f32(x[i]);
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue on
// `stream`, no synchronisation, return cudaGetLastError().

// x (B,H,W,Cin), w (kh,kw,Cin,Cout), b (Cout,), out (B,Ho,Wo,Cout), all f32
// and contiguous; `act` 0 none, 1 sigmoid, 2 PLAN.
extern "C" int conv2d_launch(int device, const float* x, const float* w,
                             const float* b, float* out, int B, int H, int W,
                             int Cin, int kh, int kw, int Cout, int Ho, int Wo,
                             int stride, int act, void* stream) {
  cudaSetDevice(device);
  const long long n = (long long)B * Ho * Wo * Cout;
  conv2d_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, w, b, out, B, H, W, Cin, kh, kw, Cout, Ho, Wo, stride, act);
  return (int)cudaGetLastError();
}

// x (B,H,W,C) -> out (B,H/2,W/2,C); `bf16` 0 for float32, 1 for bfloat16.
extern "C" int maxpool2d_launch(int device, const void* x, void* out, int B,
                                int H, int W, int C, int bf16, void* stream) {
  cudaSetDevice(device);
  const int Ho = H / 2, Wo = W / 2;
  const long long n = (long long)B * Ho * Wo * C;
  if (bf16)
    maxpool2d_kernel<__nv_bfloat16>
        <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)x, (__nv_bfloat16*)out, B, H, W, C, Ho, Wo);
  else
    maxpool2d_kernel<float><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, B, H, W, C, Ho, Wo);
  return (int)cudaGetLastError();
}

// One flat grid over n float32 words, any shape (a grid-stride loop).
extern "C" int sigmoid_pla_launch(int device, const float* x, float* out,
                                  long long n, void* stream) {
  cudaSetDevice(device);
  const unsigned blocks = blocks_for(n) < 132u * 32u ? blocks_for(n) : 132u * 32u;
  sigmoid_pla_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
