// Shared helpers for the port's kernels: dtype codes, conversions, dispatch.
//
// Every library exposes plain C functions (loaded with ctypes) that take raw
// device pointers, int shapes and the cudaStream_t of the caller, launch on
// that stream, and return cudaGetLastError() so that a refused launch is
// reported by the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round through T and back: the value a tensor of dtype T would hold.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Runs the statements that follow with `T` bound to the C++ type of a dtype
// code; an unknown code returns cudaErrorInvalidValue from the caller.
#define DISPATCH_DTYPE(code, T, ...)                        \
  if ((code) == kF32) {                                     \
    using T = float;                                        \
    __VA_ARGS__                                             \
  } else if ((code) == kBF16) {                             \
    using T = __nv_bfloat16;                                \
    __VA_ARGS__                                             \
  } else {                                                  \
    return static_cast<int>(cudaErrorInvalidValue);         \
  }
