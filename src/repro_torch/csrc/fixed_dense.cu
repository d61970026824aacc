// Fixed-point (Qm.n) dense layer, and the frame sweep's window head, for
// sm_90a.
//
// Replaces fixed_matmul_pallas (_fixed_mm_kernel) of
// src/repro/kernels/quant_matmul/kernel.py: out = fixed_add(wrap(sum_k
// fixed_mul(x[m,k], w[k,n])), b[n]) for x (M,K), w (K,N), b (N,), all int32.
// Each product is renormalized (>> frac_bits with the round bit) before it
// is summed, so a tensor-core GEMM or cuBLAS computes something else; the
// MACs run on the CUDA cores, in the arithmetic of fixed_format.cuh.
//
// Three kernels:
//   fixed_dense_rows_kernel   the dense layer for N <= 16 (the smallNet
//     head's N = 10): a block takes kRows rows and stages them in shared
//     memory with asynchronous 16-byte copies (a block's rows are one
//     contiguous run of rows*K words), w and b beside them; kSplit threads
//     share a row, each summing every kSplit-th k for all N outputs in
//     registers (dense_sums), the parts added by shuffles; the rows'
//     outputs are staged and stored with coalesced 16-byte stores.  One
//     thread a row would leave an SM four warps at M = 16384.
//   fixed_dense_kernel        the generic route, N > 16 or a K whose rows
//     do not fit the shared memory: one thread per output word.
//   fixed_window_head_kernel  the sweep's head in one launch: kSplit
//     threads take a window at pooled offset (gy, gx) and copy its k x k
//     features straight from the four role maps (feature (i, j) from map
//     is_last_row(i) + 2*is_last_col(j), as the sweep lays them out), then
//     dense_sums, the shuffles and the PLAN.  It replaces the stack of the
//     four maps, the index gather (a (Nw, k*k) matrix written and read
//     back), the dense and the PLAN launch.
// The wraparound STANDARD_CONFIGS take kernels specialised on their
// format (products summed mod 2^32, then one wrap and the bias); the
// saturating formats take the runtime FixedCfg, each product saturated
// through fixed_mul and the sum wrapped to total_bits before the
// saturating fixed_add.  The order and grouping of the K sum cannot change
// a word: it is taken mod 2^32 in every format.
//
// Bounds on an H100 SXM (3.35 TB/s; int32 on the CUDA cores 16.7 Tops/s,
// 2 ops per multiply-accumulate):
//   (64,49)@(49,10): 17 KB (5 ns) against 63 Kops (4 ns): the launch is
//     the whole cost.
//   (16384,49)@(49,10): 3.9 MB (1.2 us) against 16 Mops (1 us).
//   window head, 1080x1920 (31,654 windows): 2.07 MB of quad, 0.25 MB of
//     offsets and 1.27 MB of scores (1.07 us) against 31 Mops (1.9 us):
//     bound by the MACs, where the composed head's traffic (over 30 MB)
//     bound the four launches it replaces.
// Each block loads, then computes, then stores, and at these sizes the
// grid is one wave, so the three phases of the card do not overlap; a
// rounded product is four instructions (IMAD.WIDE, the 64-bit add of the
// rounding bit, LEA.HI), which the MAC phase spends most of its time on.
#include <cuda_runtime.h>

#include <cstdint>

#include "fixed_format.cuh"

namespace {

constexpr int kThreads = 256;   // generic kernel
constexpr int kRows = 64;       // rows (windows) a block of the row kernels takes
constexpr int kSplit = 4;       // threads a row: each sums every kSplit-th k

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

// Shared memory of the row kernels, in bytes, every part 16-byte aligned:
// w (K, ld) and b (ld) zero past N, the block's rows (kRows, K), their
// outputs (kRows, N).
long long rows_smem_bytes(int K, int N) {
  const long long ld = N <= 10 ? 12 : 16;
  return 4 * (K * ld + ld + (long long)kRows * K + round4(kRows * N));   // kRows % 4 == 0
}

// The row kernels take N <= 16 outputs whose rows fit the shared memory (K
// up to about 700); the generic kernel takes the rest
bool rows_fit(int K, int N) {
  return N <= 16 && rows_smem_bytes(K, N) <= kSmemMax;
}

// w and b into shared memory, zero-padded to `ld` columns
__device__ __forceinline__ void stage_weights(const int32_t* __restrict__ w,
                                              const int32_t* __restrict__ b, int K,
                                              int N, int ld, int32_t* ws, int32_t* bs) {
  for (int i = threadIdx.x; i < K * ld; i += blockDim.x) {
    const int k = i / ld, n = i - k * ld;
    if (n < N) copy_async(ws + i, w + k * N + n, 4);
    else ws[i] = 0;
  }
  for (int i = threadIdx.x; i < ld; i += blockDim.x) {
    if (i < N) copy_async(bs + i, b + i, 4);
    else bs[i] = 0;
  }
}

// `n` contiguous words into shared memory, as 16-byte vectors where `vec`
// says both ends are 16-byte aligned
__device__ __forceinline__ void stage_words(int32_t* __restrict__ dst,
                                            const int32_t* __restrict__ src, int n, int vec) {
  int i0 = 0;
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      copy_async(dst + 4 * i, src + 4 * i, 16);
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) copy_async(dst + i, src + i, 4);
}

// `n` contiguous words from shared to device memory, coalesced
__device__ __forceinline__ void store_words(int32_t* __restrict__ dst,
                                            const int32_t* __restrict__ src, int n, int vec) {
  int i0 = 0;
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The row sums of thread (row, part) of a block: part `part` of the row's
// kN sums over k = part, part + kSplit, ..., then the kSplit parts added
// across the row's threads (neighbouring lanes), so every thread of the
// row holds the whole sums.  Each thread then keeps outputs n = part,
// part + kSplit, ...: Word::dense, then PLAN where `plan`, into os.
template <int kN, bool kPlan, class F>
__device__ __forceinline__ void row_outputs(const F& f, const int32_t* xr, int K,
                                            int part, const int32_t* ws, const int32_t* bs,
                                            int N, bool valid, int32_t* orow) {
  uint32_t acc[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n] = 0;
  if (valid) dense_sums<kN>(f, xr, K, part, kSplit, ws, acc);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int d = 1; d < kSplit; d *= 2) acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], d);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    if (valid && n % kSplit == part && n < N) {
      const int32_t y = f.dense(acc[n], bs[n]);
      orow[n] = kPlan ? f.plan(y) : y;
    }
  }
}

// kN output registers per row: N <= kN, the columns past N are zero
template <int kFrac, int kTotal, int kRound, int kN>
__global__ void __launch_bounds__(kRows * kSplit)
fixed_dense_rows_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                        const int32_t* __restrict__ b, int32_t* __restrict__ out, int M,
                        int K, int N, int vec_x, int vec_out, FixedCfg cfg) {
  extern __shared__ int4 smem4[];
  constexpr int ld = dense_ld<kN>();
  int32_t* ws = reinterpret_cast<int32_t*>(smem4);
  int32_t* bs = ws + K * ld;
  int32_t* xs = bs + ld;
  int32_t* os = xs + round4(kRows * K);
  const auto F = Word<kFrac, kTotal, kRound>::make(cfg);
  const long long m0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, M - m0);
  stage_weights(w, b, K, N, ld, ws, bs);
  // kRows*K and kRows*N are multiples of 4: every block's run is aligned
  // where the tensor's start is
  stage_words(xs, x + m0 * K, rows * K, vec_x);
  commit_copies();
  wait_copies();
  __syncthreads();
  const int r = threadIdx.x / kSplit, part = threadIdx.x % kSplit;
  row_outputs<kN, false>(F, xs + r * K, K, part, ws, bs, N, r < rows, os + r * N);
  __syncthreads();
  store_words(out + m0 * N, os, rows * N, vec_out);
}

template <int kFrac, int kTotal, int kRound, int kN>
__global__ void __launch_bounds__(kRows * kSplit)
fixed_window_head_kernel(const int32_t* __restrict__ qI, const int32_t* __restrict__ qB,
                         const int32_t* __restrict__ qR, const int32_t* __restrict__ qC,
                         const int32_t* __restrict__ gy, const int32_t* __restrict__ gx,
                         const int32_t* __restrict__ w, const int32_t* __restrict__ b,
                         int32_t* __restrict__ out, int Nw, int mh, int mw, int k, int N,
                         int vec_out, FixedCfg cfg) {
  extern __shared__ int4 smem4[];
  constexpr int ld = dense_ld<kN>();
  const int K = k * k;
  int32_t* ws = reinterpret_cast<int32_t*>(smem4);
  int32_t* bs = ws + K * ld;
  int32_t* xs = bs + ld;
  int32_t* os = xs + round4(kRows * K);
  const auto F = Word<kFrac, kTotal, kRound>::make(cfg);
  const long long i0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, Nw - i0);
  stage_weights(w, b, K, N, ld, ws, bs);
  const int r = threadIdx.x / kSplit, part = threadIdx.x % kSplit;
  int32_t* xr = xs + r * K;
  if (r < rows) {
    // the features this thread sums, e = part, part + kSplit, ...: feature
    // (i, j) of the window from I inside, R in the last column, B in the
    // last row, C at the corner
    const int y = gy[i0 + r], x = gx[i0 + r];
    // a window past the maps is the caller's fault: stop the kernel with
    // an error, as a device-side assert does, rather than read past them
    if (y < 0 || x < 0 || y > mh - k || x > mw - k) __trap();
    const long long o = (long long)y * mw + x;
    int i = part / k, j = part - i * k;             // feature e = i*k + j
    for (int e = part; e < K; e += kSplit) {
      const bool lr = i == k - 1, lc = j == k - 1;
      const int32_t* m = lr ? (lc ? qC : qB) : (lc ? qR : qI);
      copy_async(xr + e, m + o + (long long)i * mw + j, 4);
      for (j += kSplit; j >= k; j -= k) ++i;
    }
  }
  commit_copies();
  wait_copies();
  __syncthreads();
  row_outputs<kN, true>(F, xr, K, part, ws, bs, N, r < rows, os + r * N);
  __syncthreads();
  store_words(out + i0 * N, os, rows * N, vec_out);
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue one
// kernel on `stream`, no synchronisation, return a CUDA error code, or
// kShapeUnsupported for a shape the kernel cannot take.

// 1 where fixed_dense_launch takes the row kernel for (K, N), 0 where it
// takes the generic one
extern "C" int fixed_dense_rows_route(int K, int N) { return rows_fit(K, N); }

// fixed_dense_launch: x (M, K) @ w (K, N) + b (N,) -> out (M, N), on the
// row kernel where rows_fit, else on the generic kernel
extern "C" int fixed_dense_launch(int device, const int32_t* x,
                                  const int32_t* w, const int32_t* b,
                                  int32_t* out, int M, int K, int N,
                                  FixedCfg cfg, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  if (!rows_fit(K, N)) {
    const long long n = (long long)M * N;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    fixed_dense_kernel<<<blocks, kThreads, 0, s>>>(x, w, b, out, M, K, N, cfg);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((M + kRows - 1) / kRows);
  const int smem = (int)rows_smem_bytes(K, N);
  const int vx = aligned16(x), vo = aligned16(out);
  return (int)dispatch_format(cfg, [&](auto f) {
    using Fm = decltype(f);
    auto launch = [&](auto kernel) {
      const cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<blocks, kRows * kSplit, smem, s>>>(x, w, b, out, M, K, N, vx, vo, cfg);
      return cudaGetLastError();
    };
    return N <= 10 ? launch(fixed_dense_rows_kernel<Fm::kFrac, Fm::kTotal, Fm::kRound, 10>)
                   : launch(fixed_dense_rows_kernel<Fm::kFrac, Fm::kTotal, Fm::kRound, 16>);
  });
}

// fixed_window_head_launch: the four (mh, mw) role maps, the windows'
// pooled offsets gy, gx (Nw,), w (k*k, N) and b (N,) -> out (Nw, N), PLAN
// applied.  Only where rows_fit(k*k, N): kShapeUnsupported otherwise.  A
// window past the maps traps the kernel.
extern "C" int fixed_window_head_launch(int device, const int32_t* qI, const int32_t* qB,
                                        const int32_t* qR, const int32_t* qC,
                                        const int32_t* gy, const int32_t* gx,
                                        const int32_t* w, const int32_t* b, int32_t* out,
                                        int Nw, int mh, int mw, int k, int N, FixedCfg cfg,
                                        void* stream) {
  if (k < 1 || !rows_fit(k * k, N)) return kShapeUnsupported;
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((Nw + kRows - 1) / kRows);
  const int smem = (int)rows_smem_bytes(k * k, N);
  const int vo = aligned16(out);
  return (int)dispatch_format(cfg, [&](auto f) {
    using Fm = decltype(f);
    auto launch = [&](auto kernel) {
      const cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<blocks, kRows * kSplit, smem, s>>>(qI, qB, qR, qC, gy, gx, w, b, out, Nw, mh,
                                                  mw, k, N, vo, cfg);
      return cudaGetLastError();
    };
    return N <= 10
               ? launch(fixed_window_head_kernel<Fm::kFrac, Fm::kTotal, Fm::kRound, 10>)
               : launch(fixed_window_head_kernel<Fm::kFrac, Fm::kTotal, Fm::kRound, 16>);
  });
}
