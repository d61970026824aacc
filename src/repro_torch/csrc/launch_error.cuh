// The text of a launcher's return code (cudaGetLastError() after the launch),
// for the Python wrapper's error.  Every source includes this header once,
// so every library exports `kernel_error_string` (kernels/_build.py `check`).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
