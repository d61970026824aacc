// What the two whole-net kernels share (fixed_net.cu: Qm.n words;
// float_net.cu: float32): the shared-memory layout of an image group, the
// images they take, the copy of an image into its padded buffer, and the
// launch shape.  Both hold 4-byte words, so one layout serves both.
//
// A block is kWarps warps, 8/G groups of G warps, G in kGroupWarps chosen
// per launch: the most warps an image for which the whole batch is on the
// card at once (B=64: a level-1 phase of one pass, the served step's
// latency), 1 where it is not (B=16384: each warp walks over images, no
// thread waits at a barrier for another phase).  The SM count, the
// occupancy and the shared-memory opt-in are host calls that the served
// step would otherwise pay every launch: each (kernel, device, H, W, N)
// asks them once.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "launch_error.cuh"
#include "staging.cuh"

namespace smallnet {

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

// Shared memory of a kernel, in bytes: the dense words, then each group's
// part
inline long long smem_bytes(int H, int W, int N, int groups) {
  const long long K = (H / 4) * (W / 4), n = N;
  return 4 * ((K * n + 3) / 4 * 4 + (n + 3) / 4 * 4 + (long long)groups * Layout(H, W).words);
}

// The images the kernels take: at least 4x4 (a dense input), and one
// group's maps and the dense words within the shared memory (up to about
// 170x170 words with N = 10)
inline bool fits(int H, int W, int N) {
  return H >= 4 && W >= 4 && N >= 1 && H <= kMaxExtent && W <= kMaxExtent &&
         smem_bytes(H, W, N, 1) <= kSmemMax;
}

// Thread t of a group of GT threads: its copies of one (H, W) image into
// the padded buffer `dst`, committed as one group of copies; 16-byte
// vectors where `vec`, words otherwise
template <class T>
__device__ __forceinline__ void fetch_image(T* dst, const T* __restrict__ src, int H, int W,
                                            int ld, int vec, int t, int GT) {
  static_assert(sizeof(T) == 4, "the layout holds 4-byte words");
  const int per_row = vec ? W / 4 : W, n = H * per_row;
  Walk q(t, GT, per_row);
  for (int i = t; i < n; i += GT, q.next()) {
    if (vec) copy_async(dst + q.r * ld + 4 * q.c, src + q.r * W + 4 * q.c, 16);
    else copy_async(dst + q.r * ld + q.c, src + q.r * W + q.c, 4);
  }
  commit_copies();
}

// What a launch of one kernel needs for (device, H, W, N), for each G of
// kGroupWarps: its shared memory (0 where it does not fit) and the blocks
// the card holds at once
struct Plan {
  int bytes[4];
  long long resident[4];
};

inline cudaError_t plan_of(const void* kernel, int device, int H, int W, int N, Plan& plan) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, Plan> plans;
  static std::map<std::tuple<const void*, int>, long long> opted_in;   // only ever raised
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, device, H, W, N);
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
    long long& allowed = opted_in[std::make_tuple(kernel, device)];
    if (bytes > 48 * 1024 && bytes > allowed) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return e;
      allowed = bytes;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, (size_t)bytes);
    if (e != cudaSuccess) return e;
    plan.bytes[i] = (int)bytes;
    plan.resident[i] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  plans.emplace(key, plan);
  return cudaSuccess;
}

// One launch's shape: G warps an image, the grid, the shared memory, S
// threads a dense output word (a power of two, N*S at most the group's
// threads, in passes where N is larger), 16-byte image copies or not
struct Shape {
  int G, grid, smem, S, vec;
};

// The shape for B images of (H, W) and N classes (a kShapeUnsupported or
// CUDA error code where there is none, 0 otherwise)
inline int shape_of(const void* kernel, int device, const void* x, int B, int H, int W, int N,
                    Shape& s) {
  if (!fits(H, W, N)) return kShapeUnsupported;
  Plan plan;
  const cudaError_t e = plan_of(kernel, device, H, W, N, plan);
  if (e != cudaSuccess) return (int)e;
  // the most warps an image for which the whole batch is on the card at
  // once; 1 where it is not
  s.G = 1;
  s.grid = 0;
  s.smem = 0;
  for (int i = 0; i < 4; ++i) {
    if (plan.bytes[i] == 0) continue;
    const int groups = kWarps / kGroupWarps[i];
    const long long need = ((long long)B + groups - 1) / groups;
    s.G = kGroupWarps[i];
    s.smem = plan.bytes[i];
    s.grid = (int)(need < plan.resident[i] ? need : plan.resident[i]);
    if (need <= plan.resident[i]) break;
  }
  s.S = 1;
  while (s.S < 32 && N * s.S * 2 <= 32 * s.G) s.S *= 2;
  s.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 4 == 0;
  return 0;
}

}  // namespace smallnet
