// Fixed-point (Qm.n) dense layer for sm_90a.
//
// Replaces fixed_matmul_pallas (_fixed_mm_kernel) of
// src/repro/kernels/quant_matmul/kernel.py: out = fixed_add(wrap(sum_k
// fixed_mul(x[m,k], w[k,n])), b[n]) for x (M,K), w (K,N), b (N,), all int32.
//
// Design: one thread per output word (m, n), looping over K.  Each product
// is renormalized (>> frac_bits with the round bit) and wrapped before it
// is summed, so a tensor-core GEMM or cuBLAS computes something else; the
// loop runs on the CUDA cores.  The sum is taken in uint32_t: wraparound
// addition is associative, and the saturating mode also sums with
// wraparound (only the product and the bias add saturate), so the order of
// the K loop cannot change a word.
//
// Bounds on an H100 SXM (3.35 TB/s; int32 on CUDA cores 16.7 Tops/s,
// 2 ops per multiply-accumulate):
//   engine shapes (64,49)@(49,10): 17 KB (5 ns) against 63 Kops (4 ns);
//     the launch latency (microseconds) is the whole cost.
//   large (16384,49)@(49,10): 3.9 MB (1.2 us) against 16 Mops (1 us).
// Consecutive threads share a row of x and read consecutive w columns, so
// the loads of a warp coalesce well enough; the design stays plain because
// no tiling beats the launch at the served shapes.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_word.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void fixed_dense_kernel(const int32_t* __restrict__ x,
                                   const int32_t* __restrict__ w,
                                   const int32_t* __restrict__ b,
                                   int32_t* __restrict__ out, int M, int K,
                                   int N, FixedCfg c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  const int n = (int)(i % N);
  const long long m = i / N;
  const int32_t* xr = x + m * K;
  uint32_t acc = 0;
  for (int k = 0; k < K; ++k)
    acc += (uint32_t)fixed_mul(xr[k], w[(long long)k * N + n], c);
  const int32_t y = wrap_bits((int32_t)acc, c.total_bits);
  out[i] = fixed_add(y, b[n], c);
}

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue on
// `stream`, no synchronisation, return cudaGetLastError().
extern "C" int fixed_dense_launch(int device, const int32_t* x,
                                  const int32_t* w, const int32_t* b,
                                  int32_t* out, int M, int K, int N,
                                  FixedCfg cfg, void* stream) {
  cudaSetDevice(device);
  const long long n = (long long)M * N;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fixed_dense_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, b, out, M, K, N, cfg);
  return (int)cudaGetLastError();
}
