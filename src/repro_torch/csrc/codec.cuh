// The block codec's pieces, shared by csrc/quant.cu and csrc/pack.cu: the
// block and thread counts, the NaN-keeping block and warp max, the local
// scale rule and the quantizer (csrc/quant.cu's header says why each is as
// it is);
// and what quant.cu's streaming kernels share: the tile, the wide
// accesses, values taken out of and put into 32-bit words, and the grid.
#pragma once

#include <algorithm>

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

// The warp-owned blocks of amax_block's vector kernel and fused_pack_quant:
// a warp's 32 lanes hold one block between them and agree on its max by
// shuffles alone (no shared memory, no barrier).
constexpr int kWarpSize = 32;
constexpr int kWarps = kThreads / kWarpSize;
constexpr int kLaneValues = kBlock / kWarpSize;   // values of a block per lane

// Max of every lane's abs_bits over the warp, as a float, in every lane.
__device__ __forceinline__ float warp_abs_max(unsigned m) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
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

// The shared-scale codec's divisor: the caller's scale, 1 where it is not
// > 0 (0, negative or NaN).
__device__ __forceinline__ float shared_divisor(float raw) { return raw > 0.f ? raw : 1.f; }

// ---------------------------------------------------------------------------
// Streaming kernels (quant_scaled, dequant_int8, amax_block, and
// fused_pack_quant's grid): each CTA walks tiles of kTile values, each lane
// moving kTile / kThreads of them in words of 4 to 16 bytes.
// ---------------------------------------------------------------------------

constexpr int kTile = 8192;                   // a multiple of kBlock
constexpr int kPerLane = kTile / kThreads;    // values a lane holds per tile

__device__ __forceinline__ uint4 load16(const void* p) {
  return *static_cast<const uint4*>(p);
}
__device__ __forceinline__ uint2 load8(const void* p) { return *static_cast<const uint2*>(p); }
__device__ __forceinline__ unsigned load4(const void* p) {
  return *static_cast<const unsigned*>(p);
}
__device__ __forceinline__ void store16(void* p, uint4 v) { *static_cast<uint4*>(p) = v; }
__device__ __forceinline__ void store8(void* p, uint2 v) { *static_cast<uint2*>(p) = v; }
__device__ __forceinline__ void store4(void* p, unsigned v) { *static_cast<unsigned*>(p) = v; }

// Value j of the 32-bit words w holding values of type T, as a float: the
// same float as to_float(T) gives (bf16 widens by a shift, ints convert
// with round to nearest).
template <typename T> __device__ __forceinline__ float word_value(const unsigned* w, int j);
template <> __device__ __forceinline__ float word_value<float>(const unsigned* w, int j) {
  return __uint_as_float(w[j]);
}
template <> __device__ __forceinline__ float word_value<__nv_bfloat16>(const unsigned* w, int j) {
  return __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
}
template <> __device__ __forceinline__ float word_value<int8_t>(const unsigned* w, int j) {
  return static_cast<float>(static_cast<int>(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
}
template <> __device__ __forceinline__ float word_value<int32_t>(const unsigned* w, int j) {
  return static_cast<float>(static_cast<int>(w[j]));
}

// from_float<T>(v) into value j of the 32-bit words w; word j / (4 /
// sizeof(T)) must be zero before its first value is put.
template <typename T> __device__ __forceinline__ void put_value(unsigned* w, int j, float v);
template <> __device__ __forceinline__ void put_value<float>(unsigned* w, int j, float v) {
  w[j] = __float_as_uint(v);
}
template <> __device__ __forceinline__ void put_value<__nv_bfloat16>(unsigned* w, int j, float v) {
  w[j >> 1] |= static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)))
               << (16 * (j & 1));
}

// The grid of a streaming kernel: one CTA per tile of work, at most as many
// as can be resident at once (kCtasPerSm per SM, fewer where registers
// allow fewer); the CTAs then walk the tiles with a grid stride.  The SM
// count and the occupancy are asked once per device and kernel.
template <auto kKernel, int kCtasPerSm>
unsigned streaming_grid(long long tiles) {
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = resident[dev % 64];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
    cap = std::max(1, sms * std::min(per_sm, kCtasPerSm));
  }
  return static_cast<unsigned>(std::max(1ll, std::min(tiles, static_cast<long long>(cap))));
}

}  // namespace codec
