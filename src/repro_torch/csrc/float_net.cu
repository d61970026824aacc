// The whole float32 smallNet forward in one launch, for sm_90a: images in,
// class scores out.
//
// Replaces, on the served float step (backends `cuda` and `cuda_plan`),
// the composed launches of the Pallas TPU kernels' ports: conv2d_pallas
// (src/repro/kernels/conv2d/kernel.py) twice with its fused epilogue,
// maxpool2d_pallas (maxpool2d/kernel.py) twice, then the dense product,
// the bias add and sigmoid_pla_pallas (sigmoid_pla/kernel.py) or the exact
// sigmoid.  Per image x (H, W) float32 (the NHWC image's one channel):
//   level 1  conv 2x2 SAME (pad 0 before, 1 after; taps w1, bias b1) ->
//            activation -> 2x2/2 max pool
//   level 2  the same with w2, b2
//   dense    flatten (K = (H/4)(W/4) floats) @ wd (K, N) + bd -> activation
// with one activation everywhere: PLAN (`cuda_plan`) or the exact sigmoid
// 1/(1+expf(-x)) (`cuda`).  Odd extents are cropped by the pools, as in
// the reference.  The per-stage kernels (float_kernels.cu) stay for the
// composed stages and the float frame sweep.
//
// Design: fixed_net.cu's, with floats (smallnet_plan.cuh holds the layout
// and launch shape both use).  A group of G warps takes one image at a
// time, G in {1, 2, 4, 8} from the batch and the occupancy; per image, in
// the group's shared memory: the image copied by cp.async (16-byte vectors
// where W % 4 == 0) into a buffer with a zero row and zero columns past it
// (SAME's padding, no bounds checks), while the group finishes the previous
// image; level 1, a thread per pooled float (its 3x3 input window, four
// conv outputs, four activations, their max); level 2 the same over the
// level-1 map; the dense layer split over S threads an output (split K),
// the parts added by shuffles.  Only the (B, N) scores go back to device
// memory.
//
// Arithmetic, as the composed route computes it: each conv output sums its
// taps in (dh, dw) order, then the bias (nvcc may contract a product and
// its sum into an FMA); PLAN is float_format.cuh's, exact to its plain
// version's ops; the exact sigmoid uses IEEE expf and division; the pools
// take torch.maximum's NaN rule; the dense sum runs in another order than
// torch.matmul's.  Never TF32.  Held to the plain version within 2e-5.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores): a
// 28x28 image is 3,136 bytes in and 40 out against about 13.5 kFLOP (12 a
// conv output with its bias and PLAN, 3 compares a pooled float, 2 a dense
// multiply-accumulate), so the kernel is bound by bytes: B=16384 51.4 MB,
// 15.5 us (operations 3.3 us); at B=64 the bound is 61 ns and the launch
// and one image's latency through the four phases are the whole cost.
#include <cuda_runtime.h>

#include <cstdint>

#include "float_format.cuh"
#include "launch_error.cuh"
#include "smallnet_plan.cuh"

namespace {

using smallnet::kWarps;
using smallnet::Layout;

// The pooled float at pooled position (r, c) of a map `s` with row stride
// `ld`: conv 2x2 SAME + activation at the four positions of its 2x2
// window, then the max.  The 3x3 input window may reach into the zero
// padding.
template <int kAct>
__device__ __forceinline__ float pooled(const float* s, int ld, int r, int c,
                                        const float (&w)[4], float bias) {
  const float* q = s + 2 * r * ld + 2 * c;
  float p[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) p[a][b] = q[a * ld + b];
  float y[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float acc = p[i][j] * w[0];
      acc += p[i][j + 1] * w[1];
      acc += p[i + 1][j] * w[2];
      acc += p[i + 1][j + 1] * w[3];
      y[i][j] = activate<kAct>(acc + bias);
    }
  return max_nan(max_nan(y[0][0], y[0][1]), max_nan(y[1][0], y[1][1]));
}

template <int kAct>
__global__ void __launch_bounds__(32 * kWarps, 4)
float_smallnet_kernel(const float* __restrict__ x, const float* __restrict__ w1p,
                      const float* __restrict__ b1p, const float* __restrict__ w2p,
                      const float* __restrict__ b2p, const float* __restrict__ wd,
                      const float* __restrict__ bd, float* __restrict__ out, int B, int H,
                      int W, int N, int G, int S, int vec) {
  extern __shared__ float4 smem4[];
  const int H1 = H / 2, W1 = W / 2, H2 = H1 / 2, W2 = W1 / 2;
  const int n1 = H1 * W1, K = H2 * W2;
  const Layout L(H, W);
  const int GT = 32 * G, groups = kWarps / G;
  const int group = threadIdx.x / GT, t = threadIdx.x - group * GT;
  float* ws = reinterpret_cast<float*>(smem4);     // (K, N) dense weights
  float* bs = ws + round4(K * N);                   // (N,)
  float* xs = bs + round4(N) + group * L.words;     // (H, W), padded
  float* l1 = xs + L.buf;                           // (H1, W1), padded
  float* l2 = l1 + L.l1;                            // (H2, W2), the dense input
  const float wa[4] = {w1p[0], w1p[1], w1p[2], w1p[3]};
  const float wb[4] = {w2p[0], w2p[1], w2p[2], w2p[3]};
  const float b1 = b1p[0], b2 = b2p[0];
  // the padding is zero: clear the groups' maps once, they write only
  // inside the maps
  float* all = bs + round4(N);
  for (int i = threadIdx.x; i < groups * L.words; i += blockDim.x) all[i] = 0.0f;
  for (int i = threadIdx.x; i < K * N; i += blockDim.x) ws[i] = wd[i];
  for (int i = threadIdx.x; i < N; i += blockDim.x) bs[i] = bd[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * groups;
  long long img = (long long)blockIdx.x * groups + group;
  if (img < B) smallnet::fetch_image(xs, x + img * H * W, H, W, L.ld0, vec, t, GT);
  for (; img < B; img += stride) {
    // the image has arrived, and the previous image's dense layer is done
    // with l2 (level 2 writes it after the next barrier)
    wait_copies();
    group_sync(group, GT);
    {
      Walk p(t, GT, W1);
      for (int i = t; i < n1; i += GT, p.next())
        l1[p.r * L.ld1 + p.c] = pooled<kAct>(xs, L.ld0, p.r, p.c, wa, b1);
    }
    group_sync(group, GT);
    // level 1 was the image's only reader: the next image's copies run
    // while this one's level 2 and dense layer are computed
    if (img + stride < B)
      smallnet::fetch_image(xs, x + (img + stride) * H * W, H, W, L.ld0, vec, t, GT);
    {
      Walk p(t, GT, W2);
      for (int i = t; i < K; i += GT, p.next())
        l2[i] = pooled<kAct>(l1, L.ld1, p.r, p.c, wb, b2);
    }
    group_sync(group, GT);
    for (int n0 = 0; n0 < N; n0 += GT / S) {
      if (n0 + (t & ~31) / S >= N) break;               // no output in this warp
      const int n = n0 + t / S;
      float acc = 0.0f;
      if (n < N)
        for (int k = t % S; k < K; k += S) acc += l2[k] * ws[k * N + n];
      for (int d = 1; d < S; d *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, d);
      if (n < N && t % S == 0) out[img * N + n] = activate<kAct>(acc + bs[n]);
    }
  }
}

template <int kAct>
int launch(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
           const float* wd, const float* bd, float* out, int B, int H, int W, int N,
           int device, cudaStream_t stream) {
  const auto kernel = float_smallnet_kernel<kAct>;
  smallnet::Shape s;
  const int rc = smallnet::shape_of((const void*)kernel, device, x, B, H, W, N, s);
  if (rc != 0) return rc;
  kernel<<<s.grid, 32 * kWarps, s.smem, stream>>>(x, w1, b1, w2, b2, wd, bd, out, B, H, W, N,
                                                   s.G, s.S, s.vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface (loaded with ctypes).
//
// float_smallnet_fits: 1 where the kernel takes (H, W) images and N
// classes, 0 where it does not (smallnet_plan.cuh `fits`).
extern "C" int float_smallnet_fits(int H, int W, int N) { return smallnet::fits(H, W, N); }

// float_smallnet_launch: makes `device` current for this thread, enqueues
// one launch on `stream`, does not synchronise, and returns a CUDA error
// code, or kShapeUnsupported where !fits(H, W, N) or `act` is neither 1
// (the exact sigmoid) nor 2 (PLAN).  x (B, H, W), w1/w2 (4,) taps in
// row-major (dh, dw) order, b1/b2 (1,), wd (K, N), bd (N,) -> out (B, N),
// all float32.
extern "C" int float_smallnet_launch(int device, const float* x, const float* w1,
                                     const float* b1, const float* w2, const float* b2,
                                     const float* wd, const float* bd, float* out, int B,
                                     int H, int W, int N, int act, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  if (act == kSigmoid)
    return launch<kSigmoid>(x, w1, b1, w2, b2, wd, bd, out, B, H, W, N, device, s);
  if (act == kPlan) return launch<kPlan>(x, w1, b1, w2, b2, wd, bd, out, B, H, W, N, device, s);
  return kShapeUnsupported;
}
