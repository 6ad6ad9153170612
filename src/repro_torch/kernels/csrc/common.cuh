// Shared declarations of the port's CUDA kernels.
//
// Every kernel is exported through a plain C launcher that takes raw device
// pointers and PyTorch's current stream, launches without synchronising and
// without allocating, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.  Packed hypervectors arrive as uint32_t
// words (the int32 tensors of the port carry the same bits).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HDC_EXPORT extern "C" __attribute__((visibility("default")))

// Size a launch whose dynamic shared memory may exceed the 48 KB default.
template <typename Kernel>
static inline cudaError_t hdc_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
