// Shared by the port's kernels: dtype codes (kept equal to
// repro_torch/kernels/_build.py) and conversions to and from float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DtypeCode : int { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt32 = 3 };

// Returned by an entry point for arguments it does not take.
constexpr int kRefused = -1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(int32_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// cudaGetLastError() right after a launch: a launch the runtime refused
// (too many threads, too much shared memory) never runs and a later
// synchronize does not report it.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
