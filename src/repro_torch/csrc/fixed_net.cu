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
// Design: a group of G warps takes one image at a time, G in {1, 2, 4, 8}
// chosen per launch: 8 where the batch fits on the card at once (B=64: a
// level-1 phase of one pass, the served step's latency), 1 at large
// batches (B=16384: no thread of an image waits at a barrier for another
// phase, each warp walks over images).  A block is 8 warps, 8/G groups;
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
#include <map>
#include <mutex>
#include <tuple>

#include "fixed_format.cuh"

namespace {

constexpr int kWarps = 8;       // warps a block: 8/G groups of G warps
constexpr int kGroupWarps[4] = {8, 4, 2, 1};   // the G a launch may take
constexpr int kMaxExtent = 16384;              // past it no image fits anyway

// The layout of one group's shared memory, in words: the image and the
// level-1 map, each with a zero row below and zero columns right of the
// map (row strides in whole 16-byte vectors), then the level-2 map
struct Layout {
  int ld0, ld1, buf, l1, words;
  __host__ __device__ Layout(int H, int W) {
    const int H1 = H / 2, W1 = W / 2;
    ld0 = round4(W + 1);
    ld1 = round4(W1 + 1);
    buf = (H + 1) * ld0;
    l1 = (H1 + 1) * ld1;
    words = buf + l1 + round4((H1 / 2) * (W1 / 2));
  }
};

// Shared memory of the kernel, in bytes: the dense words, then each
// group's part
long long smem_bytes(int H, int W, int N, int groups) {
  const long long K = (H / 4) * (W / 4), n = N;
  return 4 * ((K * n + 3) / 4 * 4 + (n + 3) / 4 * 4 + (long long)groups * Layout(H, W).words);
}

// The images the kernel takes: at least 4x4 (a dense input), and one
// group's maps and the dense words within the shared memory (up to about
// 170x170 words with N = 10)
bool fits(int H, int W, int N) {
  return H >= 4 && W >= 4 && N >= 1 && H <= kMaxExtent && W <= kMaxExtent &&
         smem_bytes(H, W, N, 1) <= kSmemMax;
}

// A walk over the positions (r, c) of a map with `w` columns in steps of
// `step` positions, from position `start`, without a division a step
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int start, int step, int w_) : w(w_) {
    r = start / w;
    c = start - r * w;
    dr = step / w;
    dc = step - dr * w;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

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

// Thread t of a group of GT threads: its copies of one (H, W) image into
// the padded buffer `dst`, committed as one group of copies; 16-byte
// vectors where `vec`, words otherwise
__device__ __forceinline__ void fetch_image(int32_t* dst, const int32_t* __restrict__ src,
                                            int H, int W, int ld, int vec, int t, int GT) {
  const int per_row = vec ? W / 4 : W, n = H * per_row;
  Walk q(t, GT, per_row);
  for (int i = t; i < n; i += GT, q.next()) {
    if (vec) copy_async(dst + q.r * ld + 4 * q.c, src + q.r * W + 4 * q.c, 16);
    else copy_async(dst + q.r * ld + q.c, src + q.r * W + q.c, 4);
  }
  commit_copies();
}

// The group's barrier: a warp's own, or named barrier 1 + group over its
// GT threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int group, int GT) {
  if (GT == 32) __syncwarp();
  else asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(GT) : "memory");
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
  if (img < B) fetch_image(xs, x + img * H * W, H, W, L.ld0, vec, t, GT);
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
    if (img + stride < B) fetch_image(xs, x + (img + stride) * H * W, H, W, L.ld0, vec, t, GT);
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

// What a launch of one format's kernel needs for (device, H, W, N), for
// each G of kGroupWarps: its shared memory (0 where it does not fit) and
// the blocks the card holds at once.  The SM count, the occupancy query
// and the shared-memory opt-in are host calls that the served step would
// otherwise pay every launch: each key asks them once, and then a launch
// only picks G from B.
struct Plan {
  int bytes[4];
  long long resident[4];
};

template <int kFrac, int kTotal, int kRound>
cudaError_t plan_of(int device, int H, int W, int N, Plan& plan) {
  const auto kernel = fixed_smallnet_kernel<kFrac, kTotal, kRound>;
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, Plan> plans;
  static std::map<int, long long> opted_in;    // per device: the shared memory allowed
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, H, W, N);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    plan = it->second;
    return cudaSuccess;
  }
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < 4; ++i) {
    const long long bytes = smem_bytes(H, W, N, kWarps / kGroupWarps[i]);
    plan.bytes[i] = 0;
    plan.resident[i] = 0;
    if (bytes > kSmemMax) continue;
    long long& allowed = opted_in[device];       // only ever raised
    if (bytes > 48 * 1024 && bytes > allowed) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return e;
      allowed = bytes;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, (int)bytes);
    if (e != cudaSuccess) return e;
    plan.bytes[i] = (int)bytes;
    plan.resident[i] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  plans.emplace(key, plan);
  return cudaSuccess;
}

template <int kFrac, int kTotal, int kRound>
int launch(const int32_t* x, const int32_t* w1, const int32_t* b1, const int32_t* w2,
           const int32_t* b2, const int32_t* wd, const int32_t* bd, int32_t* out, int B,
           int H, int W, int N, const FixedCfg& cfg, int device, cudaStream_t stream) {
  if (!fits(H, W, N)) return kShapeUnsupported;
  Plan plan;
  const cudaError_t e = plan_of<kFrac, kTotal, kRound>(device, H, W, N, plan);
  if (e != cudaSuccess) return (int)e;
  // the most warps an image for which the whole batch is on the card at
  // once; 1 where it is not
  int G = 1, grid = 0, smem = 0;
  for (int i = 0; i < 4; ++i) {
    if (plan.bytes[i] == 0) continue;
    const int groups = kWarps / kGroupWarps[i];
    const long long need = ((long long)B + groups - 1) / groups;
    G = kGroupWarps[i];
    smem = plan.bytes[i];
    grid = (int)(need < plan.resident[i] ? need : plan.resident[i]);
    if (need <= plan.resident[i]) break;
  }
  int S = 1;                       // threads an output word
  while (S < 32 && N * S * 2 <= 32 * G) S *= 2;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 4 == 0;
  fixed_smallnet_kernel<kFrac, kTotal, kRound><<<grid, 32 * kWarps, smem, stream>>>(
      x, w1, b1, w2, b2, wd, bd, out, B, H, W, N, G, S, vec, cfg);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (loaded with ctypes).
//
// fixed_smallnet_fits: 1 where the kernel takes (H, W) images and N
// classes, 0 where it does not.
extern "C" int fixed_smallnet_fits(int H, int W, int N) { return fits(H, W, N); }

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
