// Kimi Delta Attention's chunked prefill in one launch, for sm_90a: the
// gated delta rule over a whole prompt, every head, from a zero state, in
// chunks of kC tokens, writing each token's output and the final state.
//
// Replaces no pallas_call: the JAX package has no KDA layer.  Its plain
// version, the same chunked form in torch ops, is
// kernels/kda/ops.py `kda_chunk_prefill_plain`; the per-token recurrence
// that defines it is models/kimi_linear_ref.py's.
//
//   inputs   q, k (B, T, H, K), v (B, T, H, V), beta (B, T, H), float32;
//            b (B, Tp, H, K) float32, the cumulative log decay from each
//            chunk's start, over whole chunks (Tp = kC * chunks; the
//            padding's decay is 0)
//   outputs  o (B, T, H, V), state (B, H, K, V), float32
//
// Inside a chunk, with S the state carried in (the WY/UT form):
//
//   A[t, s] = sum_c k_tc k_sc exp(b_tc - b_sc)      (s < t)
//   P[t, s] = sum_c q_tc k_sc exp(b_tc - b_sc)      (s <= t)
//   (I + Diag(beta) A) U = Diag(beta) (V - (k * exp(b)) S)
//   O = (q * exp(b)) S + P U
//   S <- exp(b_C) S + (k * exp(b_C - b))^T U
//
// Every exponent is a later cumulative decay less an earlier one, so no
// factor passes 1 however fast a channel decays.  The exponentials are
// exp2f of b scaled by log2(e) as it is loaded.
//
// Design.  One block a (head, sequence): the block holds the head's whole
// state, K x V float32 (64 KB), in shared memory from the first chunk to
// the last, and computes A and P once a chunk for all V columns.  A chunk
// in shared memory: q, k, b and v (32 KB each), A and P (16 KB each); the
// buffers are rewritten in place as the chunk goes (q -> q exp(b), k ->
// k exp(b), b -> k exp(b_C - b), v -> the right side -> U), 224.8 KB in
// all.  The 128-float rows are stored with their float4 groups swizzled by
// the row's quarter (`at`), so the float4 reads of four-row tiles hit
// distinct banks.  The phases of a chunk, each ended by a barrier:
//   1 load q, k, b, v, beta (float4, one row of a head a warp);
//   2 A and P: a thread a 4x4 tile of the lower triangle (136 tiles), one
//     exp2f a (pair, channel), shared by A and P;
//   3 the elementwise rescales of q and k;
//   4 the right side, beta (V - (k exp(b)) S): a thread 4 rows x 8 columns;
//   5 the unit lower-triangular solve, by forward substitution: two threads
//     a column, the even and odd earlier rows, their sums joined by a shuffle;
//   6 O = (q exp(b)) S + P U, stored to o: a thread 4 rows x 8 columns;
//   7 S <- exp(b_C) S + (k exp(b_C - b))^T U: a thread 8 rows x 8 columns.
// The products are float32 FMAs on the CUDA cores, in the plain version's
// precision (no TF32).
//
// Bound on an H100 SXM: a chunk of a head is 8.4 MFLOP (A and P, the
// state's three products, the solve and P U) and 266,240 exponentials; at
// 8,192 tokens and 32 heads, 34.4 GFLOP, 0.51 ms at the 67 TFLOP/s float32
// peak, over 0.67 GB read and written (0.20 ms).  With one block a head a
// prompt fills 32 of the 132 SMs, and the chunks of a head run in series
// on one SM: 2.1 ms at that SM's share of the peak.
#include <cuda_runtime.h>

#include "launch_error.cuh"

namespace {

constexpr int kC = 64;                    // tokens a chunk
constexpr int kK = 128;                   // key channels a head
constexpr int kV = 128;                   // value channels a head
constexpr int kThreads = 256;
constexpr int kGroups = kK / 4;           // float4 groups a row (K == V)
constexpr int kTiles = (kC / 4) * (kC / 4 + 1) / 2;   // 4x4 tiles of A's lower triangle
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, in floats
constexpr int kS = 0;                     // the state (K, V)
constexpr int kQ = kS + kK * kV;          // q, then q exp(b)
constexpr int kKe = kQ + kC * kK;         // k, then k exp(b)
constexpr int kB = kKe + kC * kK;         // b, then k exp(b_C - b)
constexpr int kU = kB + kC * kK;          // v, then the right side, then U
constexpr int kA = kU + kC * kV;          // beta A, (C, C)
constexpr int kP = kA + kC * kC;          // P, (C, C)
constexpr int kBl = kP + kC * kC;         // b_C, the chunk's last b (K,)
constexpr int kBeta = kBl + kK;           // beta (C,)
constexpr int kSmemFloats = kBeta + kC;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kSmemBytes <= 227 * 1024, "the chunk does not fit in shared memory");
static_assert(kK == kV && kK == 128 && kThreads == 256, "the thread maps assume these");

// float4 group g of row r of a 128-float row-major buffer: the group index
// xor the row's quarter, mod 8
__device__ __forceinline__ int at(int r, int g) {
  return r * kK + ((g ^ ((r >> 2) & 7)) << 2);
}

__device__ __forceinline__ void load4(float (&d)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float (&d)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
kda_chunk_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ b,
                         const float* __restrict__ beta, float* __restrict__ o,
                         float* __restrict__ state, int T, int H) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const S = sm + kS;
  float* const Q = sm + kQ;
  float* const Ke = sm + kKe;
  float* const Bs = sm + kB;
  float* const U = sm + kU;
  float* const A = sm + kA;
  float* const P = sm + kP;
  float* const Bl = sm + kBl;
  float* const Beta = sm + kBeta;

  const int h = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int chunks = (T + kC - 1) / kC;
  const long long Tp = (long long)chunks * kC;
  const int ty = tid >> 4, tx = tid & 15;  // phases 4, 6, 7: a 16 x 16 grid of threads

  for (int i = tid; i < kK * kGroups; i += kThreads)
    reinterpret_cast<float4*>(S)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < T; t0 += kC) {
    // 1. the chunk's rows; rows past T read as zero (their b is the padding's)
    for (int i = tid; i < kC * kGroups; i += kThreads) {
      const int r = i / kGroups, g = i % kGroups, t = t0 + r;
      float qv[4] = {0.f, 0.f, 0.f, 0.f}, kv[4] = {0.f, 0.f, 0.f, 0.f};
      float vv[4] = {0.f, 0.f, 0.f, 0.f}, bv[4];
      if (t < T) {
        const long long row = ((long long)n * T + t) * H + h;
        load4(qv, q + row * kK + 4 * g);
        load4(kv, k + row * kK + 4 * g);
        load4(vv, v + row * kV + 4 * g);
      }
      load4(bv, b + (((long long)n * Tp + t) * H + h) * kK + 4 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[e] *= kLog2e;
      store4(Q + at(r, g), qv);
      store4(Ke + at(r, g), kv);
      store4(U + at(r, g), vv);
      store4(Bs + at(r, g), bv);
      if (r == kC - 1) store4(Bl + 4 * g, bv);
    }
    if (tid < kC)
      Beta[tid] = t0 + tid < T ? beta[((long long)n * T + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    // 2. A (strict lower, its rows times beta) and P (lower), a 4x4 tile a
    // thread: tile row ti, tile column si <= ti
    if (tid < kTiles) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
      const int si = tid - ti * (ti + 1) / 2;
      float a[4][4] = {}, p[4][4] = {};
      for (int g = 0; g < kGroups; ++g) {
        float kt[4][4], qt[4][4], bt[4][4], ks[4][4], bs[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          load4(kt[i], Ke + at(4 * ti + i, g));
          load4(qt[i], Q + at(4 * ti + i, g));
          load4(bt[i], Bs + at(4 * ti + i, g));
          load4(ks[i], Ke + at(4 * si + i, g));
          load4(bs[i], Bs + at(4 * si + i, g));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float d = 4 * si + j <= 4 * ti + i ? exp2f(bt[i][e] - bs[j][e]) : 0.f;
              const float kd = ks[j][e] * d;
              a[i][j] = fmaf(kt[i][e], kd, a[i][j]);
              p[i][j] = fmaf(qt[i][e], kd, p[i][j]);
            }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ti + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * si + j;
          A[t * kC + s] = s < t ? Beta[t] * a[i][j] : 0.f;
          P[t * kC + s] = s <= t ? p[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. q <- q exp(b), k <- k exp(b), b <- k exp(b_C - b)
    for (int i = tid; i < kC * kGroups; i += kThreads) {
      const int r = i / kGroups, g = i % kGroups;
      float qv[4], kv[4], bv[4], bl[4], ke[4], kl[4];
      load4(qv, Q + at(r, g));
      load4(kv, Ke + at(r, g));
      load4(bv, Bs + at(r, g));
      load4(bl, Bl + 4 * g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float eb = exp2f(bv[e]);
        qv[e] *= eb;
        ke[e] = kv[e] * eb;
        kl[e] = kv[e] * exp2f(bl[e] - bv[e]);
      }
      store4(Q + at(r, g), qv);
      store4(Ke + at(r, g), ke);
      store4(Bs + at(r, g), kl);
    }
    __syncthreads();

    // 4. the right side, beta (v - (k exp(b)) S), in place of v: rows 4 ty
    // + i, columns of groups tx and tx + 16
    {
      float acc[4][8] = {};
      for (int g = 0; g < kGroups; ++g) {
        float kr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(kr[i], Ke + at(4 * ty + i, g));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s0[4], s1[4];
          load4(s0, S + at(4 * g + e, tx));
          load4(s1, S + at(4 * g + e, tx + 16));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(kr[i][e], s0[j], acc[i][j]);
              acc[i][4 + j] = fmaf(kr[i][e], s1[j], acc[i][4 + j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        float u0[4], u1[4];
        load4(u0, U + at(t, tx));
        load4(u1, U + at(t, tx + 16));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          u0[j] = Beta[t] * (u0[j] - acc[i][j]);
          u1[j] = Beta[t] * (u1[j] - acc[i][4 + j]);
        }
        store4(U + at(t, tx), u0);
        store4(U + at(t, tx + 16), u1);
      }
    }
    __syncthreads();

    // 5. (I + beta A) U = the right side, by forward substitution in place:
    // column c by the pair of lanes 2c, 2c + 1, each over every other
    // earlier row; a column's rows are read and written by its warp alone
    {
      const int c = tid >> 1, half = tid & 1;
      for (int i = 1; i < kC; ++i) {
        float part = 0.f;
        for (int j = half; j < i; j += 2)
          part = fmaf(A[i * kC + j], U[at(j, c >> 2) + (c & 3)], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (half == 0) U[at(i, c >> 2) + (c & 3)] -= part;
        __syncwarp();
      }
    }
    __syncthreads();

    // 6. O = (q exp(b)) S + P U, rows past T not stored
    {
      float acc[4][8] = {};
      for (int g = 0; g < kGroups; ++g) {
        float qr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(qr[i], Q + at(4 * ty + i, g));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s0[4], s1[4];
          load4(s0, S + at(4 * g + e, tx));
          load4(s1, S + at(4 * g + e, tx + 16));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(qr[i][e], s0[j], acc[i][j]);
              acc[i][4 + j] = fmaf(qr[i][e], s1[j], acc[i][4 + j]);
            }
        }
      }
      for (int sg = 0; sg <= ty; ++sg) {          // P is zero right of the diagonal
        float pr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(pr[i], P + (4 * ty + i) * kC + 4 * sg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float u0[4], u1[4];
          load4(u0, U + at(4 * sg + e, tx));
          load4(u1, U + at(4 * sg + e, tx + 16));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(pr[i][e], u0[j], acc[i][j]);
              acc[i][4 + j] = fmaf(pr[i][e], u1[j], acc[i][4 + j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        if (t >= T) break;
        float* const row = o + (((long long)n * T + t) * H + h) * kV;
        const float o0[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
        const float o1[4] = {acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
        store4(row + 4 * tx, o0);
        store4(row + 4 * (tx + 16), o1);
      }
    }
    __syncthreads();

    // 7. S <- exp(b_C) S + (k exp(b_C - b))^T U: rows 8 ty + r, columns of
    // groups tx and tx + 16
    {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int c = 8 * ty + r;
        const float el = exp2f(Bl[c]);
        float s0[4], s1[4];
        load4(s0, S + at(c, tx));
        load4(s1, S + at(c, tx + 16));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][j] = el * s0[j];
          acc[r][4 + j] = el * s1[j];
        }
      }
      for (int t = 0; t < kC; ++t) {
        float k0[4], k1[4], u0[4], u1[4];
        load4(k0, Bs + at(t, 2 * ty));
        load4(k1, Bs + at(t, 2 * ty + 1));
        load4(u0, U + at(t, tx));
        load4(u1, U + at(t, tx + 16));
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][j] = fmaf(k0[r], u0[j], acc[r][j]);
            acc[r][4 + j] = fmaf(k0[r], u1[j], acc[r][4 + j]);
            acc[4 + r][j] = fmaf(k1[r], u0[j], acc[4 + r][j]);
            acc[4 + r][4 + j] = fmaf(k1[r], u1[j], acc[4 + r][4 + j]);
          }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int c = 8 * ty + r;
        const float s0[4] = {acc[r][0], acc[r][1], acc[r][2], acc[r][3]};
        const float s1[4] = {acc[r][4], acc[r][5], acc[r][6], acc[r][7]};
        store4(S + at(c, tx), s0);
        store4(S + at(c, tx + 16), s1);
      }
    }
    __syncthreads();
  }

  float* const out = state + ((long long)n * H + h) * kK * kV;
  for (int i = tid; i < kK * kGroups; i += kThreads) {
    const int r = i / kGroups, g = i % kGroups;
    float s[4];
    load4(s, S + at(r, g));
    store4(out + r * kV + 4 * g, s);
  }
}

}  // namespace

// q, k, v, b, beta, o, state as above, each contiguous and 16-byte aligned
// (checked by the wrapper); K and V must be 128.
extern "C" int kda_chunk_prefill_launch(int device, const float* q, const float* k,
                                        const float* v, const float* b, const float* beta,
                                        float* o, float* state, int B, int T, int H, int K,
                                        int V, void* stream) {
  if (K != kK || V != kV || B < 1 || B > 65535 || T < 1 || H < 1 || H > 65535)
    return kShapeUnsupported;
  cudaSetDevice(device);
  const cudaError_t attr = cudaFuncSetAttribute(
      kda_chunk_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  kda_chunk_prefill_kernel<<<dim3(H, B), kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      q, k, v, b, beta, o, state, T, H);
  return (int)cudaGetLastError();
}
