// Shared by every kernel library: the error-string export the Python
// loader reads, and a warp-wide sum.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Butterfly sum: every lane ends with the total of the 32 lanes.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
