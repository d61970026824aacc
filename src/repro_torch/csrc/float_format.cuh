// The float32 device functions of the float kernels, defined once: the
// PLAN sigmoid, the exact sigmoid, the activation a kernel is specialised
// on, and torch.maximum's NaN rule.  Shared by float_kernels.cu (conv2d's
// fused epilogue, sigmoid_pla, maxpool2d) and float_net.cu (the whole
// float smallNet step), as fixed_format.cuh is for the Qm.n kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum Activation { kNone = 0, kSigmoid = 1, kPlan = 2 };

// PLAN sigmoid (breakpoints 1, 2.375, 5; odd symmetry through x < 0).  The
// affine pieces are written with __fmul_rn/__fadd_rn so no contraction can
// move the last bit: it gives the float of the plain version's separate
// PyTorch ops (core/fixed_point.py sigmoid_plan_f32).  Every piece is
// formed and the segment picked by selects, as the plain version's nested
// torch.where does: branches would split a warp whose floats fall in
// different segments (a NaN takes the first piece, and stays NaN).
__device__ __forceinline__ float plan_sigmoid_f32(float x) {
  const float ax = fabsf(x);
  const float y1 = __fadd_rn(__fmul_rn(0.25f, ax), 0.5f);
  const float y2 = __fadd_rn(__fmul_rn(0.125f, ax), 0.625f);
  const float y3 = __fadd_rn(__fmul_rn(0.03125f, ax), 0.84375f);
  float y = ax >= 1.0f ? y2 : y1;
  y = ax >= 2.375f ? y3 : y;
  y = ax >= 5.0f ? 1.0f : y;
  return x < 0.0f ? __fsub_rn(1.0f, y) : y;
}

// The exact sigmoid: IEEE expf and division (no fast-math), within a few
// ulps of torch.sigmoid
__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int kAct>
__device__ __forceinline__ float activate(float x) {
  if constexpr (kAct == kSigmoid) return sigmoid_f32(x);
  else if constexpr (kAct == kPlan) return plan_sigmoid_f32(x);
  else return x;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// torch.maximum's rule: a NaN operand propagates
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  const float fa = as_float(a), fb = as_float(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa < fb ? b : a;
}
