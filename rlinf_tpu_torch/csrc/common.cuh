// Shared by every kernel source of the port. Each source is built into its
// own shared library (ops/cuda/_build.py) and bound with ctypes, so each
// library carries its own copy of the error-string entry point below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

// The JAX package's finite mask value (-2**30): (-inf) - (-inf) never occurs.
#define RLINF_NEG_INF (-1073741824.0f)
#define RLINF_FULL_MASK 0xffffffffu

extern "C" const char* rlinf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float rlinf_warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(RLINF_FULL_MASK, x, off);
  return x;
}

__device__ __forceinline__ float rlinf_warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(RLINF_FULL_MASK, x, off));
  return x;
}
