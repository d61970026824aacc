// int8 x int8 -> int32 GEMM with a fused per-row x per-column dequant, sm_90a.
//
// Replaces quant_matmul_pallas (_qmm_kernel) of
// src/repro/kernels/quant_matmul/kernel.py: out[m,n] = (float)acc[m,n] *
// sx[m] * sw[n], acc the exact int32 sum over k of xq[m,k]*wq[k,n], for xq
// (M,K) and wq (K,N) int8, sx (M,) and sw (N,) float32.
//
// Two kernels, one function; the wrapper (kernels/quant_matmul/ops.py,
// `quant_matmul_route`) picks one by shape:
//
//   wgmma  K % 16 == 0 and N % 4 == 0: the int8 tensor cores.  A block of
//          384 threads owns a 128 x 256 output tile.  Warpgroup 0 is the
//          producer: one thread keeps a ring of kStages tiles of xq (128
//          rows x 128 bytes) and of the K-major weights (256 rows x 128
//          bytes) in dynamic shared
//          memory filled by TMA (cp.async.bulk.tensor, 128-byte swizzle,
//          mbarrier completion), so the loads of later K steps overlap the
//          products of this one.  Warpgroups 1 and 2 each own a 64-row slab
//          and issue four wgmma.m64n256k32.s32.s8.s8 per 128-byte K step,
//          keeping one step's group in flight, the int32 sums in registers
//          (128 a thread).  `wgmma` takes s8 operands only K-major, and wq
//          arrives (K,N), N-major: a transpose kernel here writes one
//          K-major (N,K) copy first, in the same call.  TMA needs 16-byte
//          global strides, hence K % 16; rows past M or N and columns past
//          K are filled with zeros by TMA and add nothing.
//   dp4a   every other shape (the dense layer's K = 49): a 64 x 64 tile of
//          256 threads, each a 4x4 sub-tile, K walked in 32-byte steps
//          staged in shared memory with zeros past M, N and K, every four
//          products one __dp4a on the CUDA cores.  At those shapes a launch
//          costs more than the work, and no copy of wq is made.
//
// Both sums are exact int32 in any order (|sum| < 2^31 for K < 2^17, which
// the wrapper enforces), so both routes give the same words; the epilogue
// is (float)acc * sx[m] * sw[n], left to right, with __fmul_rn so no
// contraction changes it.
//
// Bounds on an H100 SXM (3.35 TB/s; int8 tensor cores 1,979 TOP/s, 2 ops a
// multiply-accumulate):
//   engine shape (64,49)@(49,10): 6 KB (2 ns) against 63 Kops (0.03 ns):
//     launch latency is the whole cost.
//   (4096,4096)@(4096,4096): 101 MB (30 us) against 137 Gops (69 us):
//     bound by operations.  A 128 x 256 tile with 128-byte K steps reads
//     48 KB of shared memory a step for 4 M multiply-accumulates, so L2 and
//     shared-memory bandwidth, the per-step waits and the epilogue's
//     stores (64 MB of floats), not the tensor cores, are expected to
//     hold it back; the transposed copy of wq adds 32 MB of traffic.
#include <cuda.h>          // CUtensorMap types only: no libcuda link
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_error.cuh"

namespace {

// -- the dp4a route --------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;   // kBK int8 values = 8 words
constexpr int kWords = kBK / 4;
constexpr int kThreads = 256;                 // 16 x 16, 4x4 outputs each

__global__ void __launch_bounds__(kThreads)
qmm_dp4a_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
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

// -- the wgmma route -------------------------------------------------------

constexpr int kTM = 128, kTN = 256;           // output tile
constexpr int kTK = 128;                      // K bytes a stage: one swizzle row
constexpr int kStages = 4;
constexpr int kWgThreads = 384;               // producer + two consumer warpgroups
constexpr int kA = kTM * kTK, kB = kTN * kTK;  // bytes of a stage's tiles
// dynamic shared memory: the ring, its barriers, and room to align the
// ring to 1024 bytes
constexpr int kSmemBytes = kStages * (kA + kB) + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A phase that
// never completes (a copy that never lands) traps after ten seconds, so a
// fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 10000000000ull) __trap();
  }
}

// One TMA tile load: box (kTK bytes, rows) at (k, row) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// the leading offset unused for a swizzled K-major operand.  Stepping K by
// 32 bytes inside the row moves the start address by 32; the hardware
// applies the swizzle to the addresses it forms, which is why every tile
// starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d[128] = A(64 x 32, K-major) * B(256 x 32, K-major)^T (+ d if `accumulate`),
// s8 in, s32 out.
__device__ __forceinline__ void wgmma_k32(int32_t (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The int8 product of one 128 x 256 output tile (see the note at the top).
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 float* __restrict__ out, int M, int K, int N, int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sa = smem;                               // kStages x (128 x 128 B)
  uint8_t* sb = smem + kStages * kA;                // kStages x (256 x 128 B)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kB);
  uint64_t* empty = full + kStages;
  const int tile_m = blockIdx.x / tiles_n, tile_n = blockIdx.x % tiles_n;
  const int kblocks = (K + kTK - 1) / kTK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                            // producer: one thread issues TMA
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kA + kB);
        tma_load(sa + s * kA, &map_x, &full[s], kb * kTK, tile_m * kTM);
        tma_load(sb + s * kB, &map_w, &full[s], kb * kTK, tile_n * kTN);
      }
    }
    return;
  }

  // consumers: warpgroup 1 or 2 owns rows 64*slab.. of the tile.  One
  // group of wgmmas stays in flight: a stage goes back to the producer
  // once the group after it has been issued and its own has completed.
  // The first product overwrites d (scale-d 0) instead of adding to zeros:
  // an instruction that wrote the accumulators would serialise the wgmmas.
  const int slab = wg - 1;
  int32_t d[kTN / 2];
  for (int kb = 0; kb < kblocks; ++kb) {
    const int s = kb % kStages;
    mbar_wait(&full[s], (kb / kStages) & 1);
    const uint8_t* a = sa + s * kA + slab * 64 * kTK;
    const uint8_t* b = sb + s * kB;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kTK / 32; ++k)
      wgmma_k32(d, smem_desc(a + 32 * k), smem_desc(b + 32 * k), kb > 0 || k > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kb > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(kb - 1) % kStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // the accumulator layout of wgmma m64nN: warp w of the warpgroup holds
  // rows 16w + lane/4 (+8); d[4j..4j+3] are columns 8j + 2(lane%4) (+1)
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int m_lo = tile_m * kTM + slab * 64 + 16 * w + lane / 4;
  const int n_base = tile_n * kTN + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m_lo + 8 * h;
    if (m >= M) continue;
    const float fx = sx[m];
    float* row = out + (long long)m * N;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int n = n_base + 8 * j;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n + e < N)
          row[n + e] = __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h + e]), fx),
                                 sw[n + e]);
    }
  }
}

// wt (N, K) = the transpose of wq (K, N), int8, K % 4 == N % 4 == 0.  A
// block moves a 64 x 64-byte tile: each thread reads one 4-byte word from
// each of four rows, transposes the 4 x 4 bytes in registers (byte
// permutes) and parks the four words in shared memory; the writes then run
// along wt's rows, so both sides move whole words along rows.
__global__ void __launch_bounds__(256)
qmm_transpose_kernel(const int8_t* __restrict__ wq, int8_t* __restrict__ wt, int K,
                     int N) {
  __shared__ uint32_t tile[64][17];               // [n][k word], padded
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int kq = threadIdx.x / 16, nw = threadIdx.x % 16;
  const int k = k0 + 4 * kq, n = n0 + 4 * nw;
  uint32_t r[4] = {0, 0, 0, 0};
  if (n < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k + i < K)
        r[i] = *reinterpret_cast<const uint32_t*>(wq + (long long)(k + i) * N + n);
  }
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  tile[4 * nw + 0][kq] = __byte_perm(t0, t2, 0x5410);
  tile[4 * nw + 1][kq] = __byte_perm(t0, t2, 0x7632);
  tile[4 * nw + 2][kq] = __byte_perm(t1, t3, 0x5410);
  tile[4 * nw + 3][kq] = __byte_perm(t1, t3, 0x7632);
  __syncthreads();
  const int kw = threadIdx.x % 16;
  for (int i = threadIdx.x / 16; i < 64; i += 16) {
    const int n_out = n0 + i, k_out = k0 + 4 * kw;
    if (n_out < N && k_out < K)
      *reinterpret_cast<uint32_t*>(wt + (long long)n_out * K + k_out) = tile[i][kw];
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, K) row-major int8 matrix as 128-byte x `box_rows` TMA boxes with
// the 128-byte swizzle; elements past either edge load as zero.
bool encode_kmajor(EncodeTiledFn enc, CUtensorMap* map, const int8_t* base,
                   int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kTK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue on
// `stream`, no synchronisation, return a CUDA error code (0 on success).
extern "C" int quant_matmul_dp4a_launch(int device, const int8_t* xq,
                                        const int8_t* wq, const float* sx,
                                        const float* sw, float* out, int M,
                                        int K, int N, void* stream) {
  cudaSetDevice(device);
  const dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM));
  qmm_dp4a_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(xq, wq, sx, sw,
                                                               out, M, K, N);
  return (int)cudaGetLastError();
}

// wt (N, K) = wq (K, N) transposed: the K-major copy the wgmma route reads.
extern "C" int quant_matmul_transpose_launch(int device, const int8_t* wq,
                                             int8_t* wt, int K, int N,
                                             void* stream) {
  cudaSetDevice(device);
  const dim3 grid((unsigned)((N + 63) / 64), (unsigned)((K + 63) / 64));
  qmm_transpose_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(wq, wt, K, N);
  return (int)cudaGetLastError();
}

// `wt` is the (N, K) K-major copy of wq; xq and wt 16-byte aligned, K % 16
// == 0 (checked by the wrapper, refused by the tensor-map encoder).
extern "C" int quant_matmul_wgmma_launch(int device, const int8_t* xq,
                                         const int8_t* wt, const float* sx,
                                         const float* sw, float* out, int M,
                                         int K, int N, void* stream) {
  cudaSetDevice(device);
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_x, map_w;
  if (!encode_kmajor(enc, &map_x, xq, M, K, kTM) ||
      !encode_kmajor(enc, &map_w, wt, N, K, kTN))
    return (int)cudaErrorInvalidValue;
  const long long tiles_n = (N + kTN - 1) / kTN;
  const long long tiles = ((M + kTM - 1) / kTM) * tiles_n;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t attr = cudaFuncSetAttribute(
      qmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  qmm_wgmma_kernel<<<(unsigned)tiles, kWgThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map_x, map_w, sx, sw, out, M, K, N, (int)tiles_n);
  return (int)cudaGetLastError();
}
