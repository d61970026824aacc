// Shared-memory staging for the kernels that hold their inputs in shared
// memory: asynchronous copies, the opt-in limit, the walk over a map's
// positions and a group's barrier.  Shared by the Qm.n kernels (through
// fixed_format.cuh) and the float ones (float_kernels.cu, float_net.cu).
#pragma once

#include <cuda_runtime.h>

// dynamic shared memory a block may opt in to on sm_90
constexpr int kSmemMax = 227 * 1024;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// An asynchronous copy of one word (4 bytes) or one 16-byte vector into
// shared memory: a thread issues its copies, commits them as a group
// (`commit_copies`) and waits for them later (`wait_copies`), so a block's
// loads are all in flight together
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for the groups of copies this thread committed, all but the
// newest kPending of them
template <int kPending = 0>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The barrier of a group of GT threads, `group` of the block's groups: a
// warp's own, or named barrier 1 + group (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int group, int GT) {
  if (GT == 32) __syncwarp();
  else asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(GT) : "memory");
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
