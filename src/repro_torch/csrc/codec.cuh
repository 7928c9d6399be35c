// The block codec's pieces, shared by csrc/quant.cu and csrc/pack.cu: the
// block and thread counts, the NaN-keeping block max, the local scale rule
// and the quantizer (csrc/quant.cu's header says why each is as it is).
#pragma once

#include "common.cuh"

namespace codec {

constexpr int kBlock = 1024;          // codec block (quant.py BLOCK)
constexpr int kThreads = 256;
constexpr int kPerThread = kBlock / kThreads;

// |v| as the bits of a non-negative float: unsigned order is float order
// there, and a NaN lies above inf, so an integer max keeps a NaN as jnp.max
// does (fmaxf would drop it) at one instruction per element.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Max of every thread's abs_bits over the block, as a float, in every thread.
__device__ __forceinline__ float block_abs_max(unsigned m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
  return __uint_as_float(m);
}

// clamp(rint(v / s), -127, 127), NaN -> 0
__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return r != r ? int8_t{0} : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// The local-scale codec's scale: amax * f32(1/127), 1 when amax is 0 (a NaN
// amax fails the compare and takes 1 too).
__device__ __forceinline__ float local_scale(float amax) {
  return amax > 0.f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.f;
}

}  // namespace codec
