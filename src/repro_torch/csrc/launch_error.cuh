// The text of a launcher's return code (cudaGetLastError() after the launch),
// for the Python wrapper's error.  Every source includes this header once,
// so every library exports `kernel_error_string` (kernels/_build.py `check`).
#pragma once

#include <cuda_runtime.h>

// A launcher's code for a shape its kernel cannot take (no cudaError_t is
// negative): the wrapper raises ValueError for it (kernels/_build.py
// SHAPE_UNSUPPORTED)
constexpr int kShapeUnsupported = -1;

extern "C" const char* kernel_error_string(int code) {
  if (code == kShapeUnsupported) return "the kernel cannot take this shape";
  return cudaGetErrorString((cudaError_t)code);
}
