// int8 x int8 -> int32 GEMM with a fused per-row x per-column dequant, sm_90a.
//
// Replaces quant_matmul_pallas (_qmm_kernel) of
// src/repro/kernels/quant_matmul/kernel.py: out[m,n] = (float)acc[m,n] *
// sx[m] * sw[n], acc the exact int32 sum over k of xq[m,k]*wq[k,n], for xq
// (M,K) and wq (K,N) int8, sx (M,) and sw (N,) float32.
//
// Design: the TPU kernel walks K innermost over (bm,bn,bk) VMEM blocks with a
// resident int32 accumulator.  Here a block of 256 threads owns a 64x64
// output tile, each thread a 4x4 sub-tile held in registers; K is walked in
// steps of 32, with the x and w slices staged in shared memory as packed
// 4-byte words (w transposed so that each output column's four k values sit
// in one word), and every product-sum of four k values is one __dp4a on the
// CUDA cores.  Loads past M, N or K stage zeros, which add nothing: K = 49
// (the dense layer) needs no padded copy.  The sum is exact int32 in any
// order; the epilogue is (float)acc * sx[m] * sw[n], left to right, with
// __fmul_rn so no contraction changes it.
//
// Bounds on an H100 SXM (3.35 TB/s; int8 tensor cores 1,979 TOP/s, 2 ops a
// multiply-accumulate):
//   engine shape (64,49)@(49,10): 6 KB (2 ns) against 63 Kops (0.03 ns):
//     launch latency is the whole cost.
//   (4096,4096)@(4096,4096): 101 MB (30 us) against 137 Gops (69 us):
//     bound by operations, on tensor cores this kernel does not use.
// __dp4a on the CUDA cores runs far below the tensor cores' rate; an
// int8 mma/wgmma kernel is the later PR that closes that gap.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_error.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;   // kBK int8 values = 8 words
constexpr int kWords = kBK / 4;
constexpr int kThreads = 256;                 // 16 x 16, 4x4 outputs each

__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    float* __restrict__ out, int M, int K, int N) {
  // one padding word a row keeps the transposed w stores free of conflicts
  __shared__ int32_t xs[kBM][kWords + 1];
  __shared__ int32_t ws[kBN][kWords + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int32_t acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int t = tid; t < kBM * kBK; t += kThreads) {
      const int r = t / kBK, kk = t % kBK;         // a warp reads one x row
      const int m = m0 + r, k = k0 + kk;
      reinterpret_cast<int8_t*>(xs[r])[kk] =
          (m < M && k < K) ? xq[(long long)m * K + k] : (int8_t)0;
    }
    for (int t = tid; t < kBK * kBN; t += kThreads) {
      const int kk = t / kBN, c = t % kBN;         // a warp reads one w row
      const int k = k0 + kk, n = n0 + c;
      reinterpret_cast<int8_t*>(ws[c])[kk] =
          (k < K && n < N) ? wq[(long long)k * N + n] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        out[(long long)m * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sx[m]), sw[n]);
    }
  }
}

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue on
// `stream`, no synchronisation, return cudaGetLastError().
extern "C" int quant_matmul_launch(int device, const int8_t* xq,
                                   const int8_t* wq, const float* sx,
                                   const float* sw, float* out, int M, int K,
                                   int N, void* stream) {
  cudaSetDevice(device);
  const dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM));
  quant_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xq, wq, sx, sw, out, M, K, N);
  return (int)cudaGetLastError();
}
