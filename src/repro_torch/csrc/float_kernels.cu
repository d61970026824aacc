// Float NHWC conv, 2x2/2 max pool and PLAN sigmoid for sm_90a.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/:
//   conv2d_launch      <- conv2d_pallas (_conv_kernel), conv2d/kernel.py
//   maxpool2d_launch   <- maxpool2d_pallas (_pool_kernel), maxpool2d/kernel.py
//   sigmoid_pla_launch <- sigmoid_pla_pallas (_plan_kernel), sigmoid_pla/kernel.py
// The served float smallNet step takes all three fused in one launch
// (float_net.cu); these kernels serve the composed stages and the float
// frame sweep.  The device functions (PLAN, the exact sigmoid, the NaN
// rule of the max) are float_format.cuh's.
//
// conv2d, tiled.  A TPU program holds a whole pre-padded image in VMEM and
// does one (H*W,Cin)@(Cin,Cout) MXU dot per tap.  Here a block of 256
// threads owns a tile of TH x TW output pixels of one image across a chunk
// of CC output channels (all of Cout where its kh*kw*Cin*CC weights fit a
// 64 KB budget, else the chunks are the grid's y):
//   * the chunk's weights and bias are copied into shared memory once per
//     block; the block then walks over the tiles of the batch (a grid of
//     at most the blocks the card holds at once), the inputs of the next
//     kStages-1 tiles in flight while it computes one (cp.async);
//   * a tile's input, ((TH-1)*stride+kh) x ((TW-1)*stride+kw) x Cin floats
//     with its halo, arrives by 16-byte cp.async where the rows are
//     aligned (W*Cin and TW*stride*Cin multiples of 4), by 4-byte ones
//     otherwise; what lies past the bottom or right edge is stored as zero,
//     SAME's padding (0 before, k-1 after), so no tap is bounds-checked.
//     (TMA needs 16-byte global strides, which 14x14 maps do not have.)
//   * a thread computes one pixel x V consecutive output channels (V = 4
//     where Cout % 4 == 0, else 1): each staged input float is read once
//     for V products, the weights as float4 from shared memory, and the V
//     outputs leave in one 16-byte store, neighbouring threads on
//     neighbouring addresses (NHWC's innermost axis);
//   * indices inside an image are 32-bit; only the image's base offset is
//     64-bit (images of 2^31 floats or more take the direct kernel);
//   * every output sums its taps in (dh, dw) order and Cin inside each tap,
//     as the reference accumulates, then the bias, then the epilogue
//     (none, the exact sigmoid or PLAN).  nvcc may contract a product and
//     its sum into an FMA: the conv is held to its plain version within a
//     tolerance, not bit for bit.  The 2x2, Cin = 1 conv of smallNet has
//     its taps unrolled.
// No tensor cores: wgmma has no fp32 operand type, TF32 moves results by
// about 1e-3 (the reason cuDNN's TF32 is off in every reference), and
// smallNet's contraction kh*kw*Cin is 4.  A conv whose single-pixel tile
// does not fit (kh*kw*Cin in the tens of thousands) takes the direct
// kernel: one thread per output float, straight from device memory, as
// the first port of this kernel computed every conv.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA cores):
//   engine shapes, B=64, Cin=Cout=1: the two convs move 251 KB and 63 KB
//     (0.15 us together); every launch is bound by launch latency
//     (microseconds), far above either bound;
//   a 512x512 stride-2 frame into 16 channels: 5.2 MB, 1.57 us (bytes);
//   (16384,28,28,1) 2x2 SAME: 103 MB, 30.7 us (bytes).
// pool and PLAN: one thread per output element, bound by bytes at large
// shapes (crops odd extents; f32 or bf16 pool; both exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "float_format.cuh"
#include "launch_error.cuh"
#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRuns = 64;                    // runs of V channels a chunk: >= 4 pixels a pass
constexpr int kMaxRows = 4;                     // output rows a thread
constexpr long long kWeightBudget = 64 * 1024;  // bytes of a block's weight chunk
constexpr int kStages = 2;                      // input tiles a block holds: 1 + those in flight
constexpr long long kTileBudget = 48 * 1024;    // bytes of one of a block's input tiles

// A tiled conv's geometry
struct Tile {
  int V;        // consecutive output channels a thread: 4 where Cout % 4 == 0, else 1
  int CC;       // output channels of a block's chunk, a multiple of V
  int R;        // runs of V channels in a chunk: CC / V
  int TH, TW;   // output pixels of a tile: TH = PR x the rows of one pass of the threads
  int PR;       // consecutive output rows a thread computes
  int IH, IW;   // its input pixels: ((TH-1)*stride + kh) x ((TW-1)*stride + kw)
  int ld;       // floats of a staged input row: round4(IW * Cin)
  int chunks;   // chunks over Cout (the grid's y)
  int smem;     // bytes: kStages input tiles, the weight chunk, the bias chunk
};

// The tile of a conv; false where the direct kernel takes it: the weights
// of V channels or the input of one pixel past the budgets, an image or an
// output image of 2^31 floats or more, or more chunks than a grid's y
bool plan_tile(int H, int W, int Cin, int kh, int kw, int Cout, int Ho, int Wo, int stride,
               Tile& t) {
  if ((long long)H * W * Cin >= (1ll << 31) || (long long)Ho * Wo * Cout >= (1ll << 31))
    return false;
  t.V = Cout % 4 == 0 ? 4 : 1;
  const long long cout_bytes = 4ll * kh * kw * Cin;     // the weights of one channel
  long long cc = std::min<long long>(Cout, (long long)t.V * kMaxRuns);
  cc = std::min(cc, kWeightBudget / cout_bytes / t.V * t.V);
  if (cc < t.V) return false;
  t.CC = (int)cc;
  t.R = t.CC / t.V;
  t.chunks = (Cout + t.CC - 1) / t.CC;
  if (t.chunks > 65535) return false;
  // the pixels of one pass of the threads: up to 32 columns (a warp's
  // stores along a row), the rest rows; each thread takes up to kMaxRows
  // rows (bytes in flight a block); the rows a thread, the rows a pass,
  // then the columns halved while the input tile is past its budget
  const int P = kThreads / t.R;
  int tw = 1;
  while (tw * 2 <= P && tw < 32 && tw < Wo) tw *= 2;
  int tp = std::min(P / tw, Ho);
  int pr = std::min(kMaxRows, (Ho + tp - 1) / tp);
  for (;;) {
    const long long th = (long long)tp * pr;
    const long long ih = (th - 1) * stride + kh, iw = (long long)(tw - 1) * stride + kw;
    const long long ld = (iw * Cin + 3) / 4 * 4;
    if (4 * ih * ld <= kTileBudget) {
      t.IH = (int)ih;
      t.IW = (int)iw;
      t.ld = (int)ld;
      break;
    }
    if (pr > 1) pr /= 2;
    else if (tp > 1) tp = (tp + 1) / 2;
    else if (tw > 1) tw /= 2;
    else return false;
  }
  t.PR = pr;
  t.TH = tp * pr;
  t.TW = tw;
  t.smem = 4 * (kStages * t.IH * t.ld + kh * kw * Cin * t.CC + round4(t.CC));
  return true;
}

// acc[v] += x * w[v] for the V channels of a run (w 16-byte aligned when V is 4)
template <int kV>
__device__ __forceinline__ void tap(float (&acc)[kV], float x, const float* w) {
  if constexpr (kV == 4) {
    const float4 q = *reinterpret_cast<const float4*>(w);
    acc[0] += x * q.x;
    acc[1] += x * q.y;
    acc[2] += x * q.z;
    acc[3] += x * q.w;
  } else {
    acc[0] += x * w[0];
  }
}

template <int kV, int kAct, bool k2x2>
__global__ void __launch_bounds__(kThreads)
conv2d_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out, int B, int H, int W,
                   int Cin, int kh, int kw, int Cout, int Ho, int Wo, int stride, Tile t,
                   int vec) {
  extern __shared__ float4 smem4[];
  const int taps = kh * kw * Cin;
  float* xs = reinterpret_cast<float*>(smem4);   // kStages (IH, ld) input tiles
  float* ws = xs + kStages * t.IH * t.ld;         // (taps, CC): the chunk's weights
  float* bs = ws + taps * t.CC;                   // (CC,)
  const int c0 = blockIdx.y * t.CC;               // the chunk's first channel
  {
    Walk q(threadIdx.x, kThreads, t.CC);
    for (int i = threadIdx.x; i < taps * t.CC; i += kThreads, q.next()) {
      if (c0 + q.c < Cout) copy_async(ws + i, w + (long long)q.r * Cout + c0 + q.c, 4);
      else ws[i] = 0.0f;
    }
    for (int i = threadIdx.x; i < t.CC; i += kThreads) {
      if (c0 + i < Cout) copy_async(bs + i, b + c0 + i, 4);
      else bs[i] = 0.0f;
    }
  }
  // this thread's pixels of a tile, rows ti .. ti + PR - 1 of column tj,
  // and its run of kV channels
  const int run = threadIdx.x % t.R, pix = threadIdx.x / t.R;
  const int ti = pix / t.TW * t.PR, tj = pix % t.TW;
  const int co = c0 + run * kV;
  const bool computes = pix < t.TH / t.PR * t.TW && co < Cout;
  const int tiles_x = (Wo + t.TW - 1) / t.TW;
  const int tiles = tiles_x * ((Ho + t.TH - 1) / t.TH);      // of an image
  const int per_row = vec ? t.ld / 4 : t.ld;                  // copies of a staged row
  const int n_copies = t.IH * per_row;
  const long long in_image = (long long)H * W * Cin, out_image = (long long)Ho * Wo * Cout;

  // this thread's copies of the input of tile `tl` (image tl.r, tile tl.c
  // of it) into buffer `dst`; zeros past the image
  auto stage = [&](const Walk& tl, float* dst) {
    const int ty = tl.c / tiles_x, tx = tl.c - ty * tiles_x;
    const int iy0 = ty * t.TH * stride, ix0 = tx * t.TW * stride;
    const float* xi = x + tl.r * in_image;
    const int in_row = min(t.IW, W - ix0) * Cin;        // floats of a row in the image
    Walk q(threadIdx.x, kThreads, per_row);
    for (int i = threadIdx.x; i < n_copies; i += kThreads, q.next()) {
      const int h = iy0 + q.r;
      const int n = h < H ? in_row : 0;
      const float* src = n ? xi + (h * W + ix0) * Cin : xi;
      float* d = dst + q.r * t.ld;
      if (vec) {
        const int f = 4 * q.c;
        if (f + 4 <= n) {
          copy_async(d + f, src + f, 16);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (f + e < n) copy_async(d + f + e, src + f + e, 4);
            else d[f + e] = 0.0f;
          }
        }
      } else {
        if (q.c < n) copy_async(d + q.c, src + q.c, 4);
        else d[q.c] = 0.0f;
      }
    }
  };

  // tiles i+1 .. i+kStages-1 are in flight while tile i is computed
  Walk tl(blockIdx.x, gridDim.x, tiles);          // (image, tile of the image)
  Walk ahead = tl;
  for (int s = 0; s < kStages - 1; ++s, ahead.next()) {
    if (ahead.r < B) stage(ahead, xs + s * t.IH * t.ld);
    commit_copies();                               // the first with the weights and bias
  }
  for (int i = 0; tl.r < B; ++i, tl.next(), ahead.next()) {
    if (ahead.r < B) stage(ahead, xs + (i + kStages - 1) % kStages * t.IH * t.ld);
    commit_copies();
    wait_copies<kStages - 1>();                    // tile i's copies have landed
    __syncthreads();
    const int buf = i % kStages;
    if (computes) {
      const int ty = tl.c / tiles_x, tx = tl.c - ty * tiles_x;
      const int oy = ty * t.TH + ti, ox = tx * t.TW + tj;
      const float* xp = xs + buf * t.IH * t.ld + ti * stride * t.ld + tj * stride * Cin;
      const float* bias = bs + run * kV;
      float acc[kMaxRows][kV];
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        if (k >= t.PR) break;
#pragma unroll
        for (int v = 0; v < kV; ++v) acc[k][v] = 0.0f;
        const float* xk = xp + k * stride * t.ld;
        const float* wp = ws + run * kV;
        if constexpr (k2x2) {                      // kh = kw = 2, Cin = 1
          tap<kV>(acc[k], xk[0], wp);
          tap<kV>(acc[k], xk[1], wp + t.CC);
          tap<kV>(acc[k], xk[t.ld], wp + 2 * t.CC);
          tap<kV>(acc[k], xk[t.ld + 1], wp + 3 * t.CC);
        } else {
          for (int dh = 0; dh < kh; ++dh)
            for (int dw = 0; dw < kw; ++dw) {
              const float* px = xk + dh * t.ld + dw * Cin;
              for (int ci = 0; ci < Cin; ++ci, wp += t.CC) tap<kV>(acc[k], px[ci], wp);
            }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        if (k >= t.PR || oy + k >= Ho || ox >= Wo) break;
        float* o = out + tl.r * out_image + ((oy + k) * Wo + ox) * Cout + co;
        if constexpr (kV == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(
              activate<kAct>(acc[k][0] + bias[0]), activate<kAct>(acc[k][1] + bias[1]),
              activate<kAct>(acc[k][2] + bias[2]), activate<kAct>(acc[k][3] + bias[3]));
        } else {
          *o = activate<kAct>(acc[k][0] + bias[0]);
        }
      }
    }
    __syncthreads();                               // tile i's buffer is free again
  }
}

// The direct conv: thread (b, i, j, co) sums its taps straight from device
// memory, a tap past the bottom or right edge skipped (SAME's zeros).
// Taken only where a tile does not fit (plan_tile).
__global__ void conv2d_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                     const float* __restrict__ b, float* __restrict__ out,
                                     int B, int H, int W, int Cin, int kh, int kw, int Cout,
                                     int Ho, int Wo, int stride, int act) {
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
    if (h >= H) break;
    for (int dw = 0; dw < kw; ++dw) {
      const int c = oj * stride + dw;
      if (c >= W) break;
      const float* px = xb + ((long long)h * W + c) * Cin;
      const float* wt = w + (long long)(dh * kw + dw) * Cin * Cout + co;
      for (int ci = 0; ci < Cin; ++ci) acc += px[ci] * wt[(long long)ci * Cout];
    }
  }
  acc += b[co];
  if (act == kSigmoid)
    acc = sigmoid_f32(acc);
  else if (act == kPlan)
    acc = plan_sigmoid_f32(acc);
  out[i] = acc;
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

// The blocks of `kernel` the card holds at once with `smem` bytes of
// dynamic shared memory, asked once per (kernel, device, smem); the
// shared-memory opt-in past 48 KB made once per (kernel, device) and size
cudaError_t resident_blocks(const void* kernel, int device, int smem, long long& resident) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, long long> known;
  static std::map<std::tuple<const void*, int>, int> opted_in;     // only ever raised
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, device, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    resident = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  int& allowed = opted_in[std::make_tuple(kernel, device)];
  if (smem > 48 * 1024 && smem > allowed) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)smem);
  if (e != cudaSuccess) return e;
  resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  known.emplace(key, resident);
  return cudaSuccess;
}

// Calls fn(std::integral_constant<int, act>{}) for a runtime activation
// code (0 none, 1 sigmoid, 2 PLAN)
template <class Fn>
auto dispatch_activation(int act, Fn&& fn) {
  if (act == kSigmoid) return fn(std::integral_constant<int, kSigmoid>{});
  if (act == kPlan) return fn(std::integral_constant<int, kPlan>{});
  return fn(std::integral_constant<int, kNone>{});
}

template <int kV, int kAct, bool k2x2>
int launch_tiled(const float* x, const float* w, const float* b, float* out, int B, int H,
                 int W, int Cin, int kh, int kw, int Cout, int Ho, int Wo, int stride,
                 const Tile& t, int device, cudaStream_t stream) {
  const auto kernel = conv2d_tile_kernel<kV, kAct, k2x2>;
  long long resident = 0;
  const cudaError_t e = resident_blocks((const void*)kernel, device, t.smem, resident);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)B * ((Ho + t.TH - 1) / t.TH) * ((Wo + t.TW - 1) / t.TW);
  const long long per_chunk = std::max(1ll, resident / t.chunks);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (W * Cin) % 4 == 0 &&
                  (t.TW * stride * Cin) % 4 == 0;
  const dim3 grid((unsigned)std::min(tiles, per_chunk), (unsigned)t.chunks);
  kernel<<<grid, kThreads, t.smem, stream>>>(x, w, b, out, B, H, W, Cin, kh, kw, Cout, Ho,
                                              Wo, stride, t, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (loaded with ctypes): make `device` current, enqueue on
// `stream`, no synchronisation, return cudaGetLastError().

// x (B,H,W,Cin), w (kh,kw,Cin,Cout), b (Cout,), out (B,Ho,Wo,Cout), all f32
// and contiguous; `act` 0 none, 1 sigmoid, 2 PLAN.  The tiled kernel where
// plan_tile gives a tile, the direct one otherwise.
extern "C" int conv2d_launch(int device, const float* x, const float* w,
                             const float* b, float* out, int B, int H, int W,
                             int Cin, int kh, int kw, int Cout, int Ho, int Wo,
                             int stride, int act, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  Tile t;
  if (!plan_tile(H, W, Cin, kh, kw, Cout, Ho, Wo, stride, t)) {
    const long long n = (long long)B * Ho * Wo * Cout;
    conv2d_direct_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, w, b, out, B, H, W, Cin, kh,
                                                             kw, Cout, Ho, Wo, stride, act);
    return (int)cudaGetLastError();
  }
  const bool small = kh == 2 && kw == 2 && Cin == 1;
  return dispatch_activation(act, [&](auto a) {
    constexpr int kAct = decltype(a)::value;
    if (t.V == 4)
      return small ? launch_tiled<4, kAct, true>(x, w, b, out, B, H, W, Cin, kh, kw, Cout, Ho,
                                                 Wo, stride, t, device, s)
                   : launch_tiled<4, kAct, false>(x, w, b, out, B, H, W, Cin, kh, kw, Cout,
                                                  Ho, Wo, stride, t, device, s);
    return small ? launch_tiled<1, kAct, true>(x, w, b, out, B, H, W, Cin, kh, kw, Cout, Ho,
                                               Wo, stride, t, device, s)
                 : launch_tiled<1, kAct, false>(x, w, b, out, B, H, W, Cin, kh, kw, Cout, Ho,
                                                Wo, stride, t, device, s);
  });
}

// The tile conv2d_launch takes for a conv: 1 and tile = {TH, TW, PR, CC,
// V, shared-memory bytes}, or 0 where it takes the direct kernel
extern "C" int conv2d_tile(int H, int W, int Cin, int kh, int kw, int Cout, int Ho, int Wo,
                           int stride, int* tile) {
  Tile t;
  if (!plan_tile(H, W, Cin, kh, kw, Cout, Ho, Wo, stride, t)) return 0;
  const int v[6] = {t.TH, t.TW, t.PR, t.CC, t.V, t.smem};
  for (int i = 0; i < 6; ++i) tile[i] = v[i];
  return 1;
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
