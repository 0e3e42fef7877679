// Shared by every kernel library: the plain C helpers that the Python
// wrappers bind with ctypes (kernels/_build.py).  Each .cu is built into its
// own shared library, so each carries one copy of these helpers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opt a kernel in to `bytes` of dynamic shared memory where it needs more
// than the default 48 KB.
template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
