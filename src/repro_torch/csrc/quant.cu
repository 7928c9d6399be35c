// Blockwise int8 codecs: the local-scale codec of the disaggregated KV
// transfer and the shared-scale codec of the gradient sync.
//
// Replaces four Pallas kernels of src/repro/kernels/quant.py:
//   quant_int8_launch    <- quant_int8_call   (_quant_kernel)
//   dequant_int8_launch  <- dequant_int8_call (_dequant_kernel)
//   amax_block_launch    <- amax_block_call   (_amax_kernel)
//   quant_scaled_launch  <- quant_scaled_call (_quant_scaled_kernel)
//
// Per 1024-element block: amax = max|x|; s = amax * f32(1/127) (1.0 when
// amax is 0); q = clamp(rint(x / s), -127, 127).  The scale is the
// reciprocal product because the reference's compiled code computes
// amax / 127 so (XLA rewrites a division by a constant), which can differ
// from a true division by one ulp.  rintf and IEEE division (__fdiv_rn;
// the build never uses --use_fast_math) round as the reference's
// jnp.round (half to even) and x / s do, so q and s are bit-equal to the
// reference and to the plain version.  NaN follows the reference too: the
// block max propagates it (jnp.max), a NaN amax fails "amax > 0" and takes
// scale 1, and a NaN quotient converts to q = 0 (XLA's float -> int).
//
// Bound on this card: bytes.  Each element is read once and written once
// (2 or 4 bytes in, 1 byte out, plus 4 bytes of scale per 1024), with one
// division per element: far below the 295 operations per byte at which
// an H100 stops being memory-bound.  The design therefore does one pass:
// the block's values stay in registers between the amax reduction and
// the quantize, so the payload is read once.  The quantizer reads the
// bf16 or f32 leaf directly and treats the ragged tail as zeros, which
// replaces the f32 upcast and the zero-pad concatenate (two payload-sized
// copies) of the JAX path.  Loads and stores are one element per thread
// with neighbouring threads on neighbouring addresses.
//
// The shared-scale codec splits the quantizer in two so the per-block
// amax can be agreed across the pod group (an all-reduce MAX of nb floats)
// before the quantize: amax_block reads the payload once and writes nb
// floats; quant_scaled reads it again with the agreed scale and writes
// int8.  Both are bound by bytes (the gradient segment of qwen2.5-3b is
// 3.09e9 bf16 values: 6.17 GB read by each, 3.09 GB written by the second).
// Both read bf16 or f32 directly and treat the ragged tail as zeros, so
// the JAX path's f32 upcast copy of the payload is never made (bf16 ->
// f32 is exact, so the results are bit-equal to it).  Element indices are
// 64-bit: the segment holds more than 2^31 values.

#include "codec.cuh"

namespace {

using namespace codec;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const T* __restrict__ x, long long size,
                  int8_t* __restrict__ q, float* __restrict__ s) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  float v[kPerThread];
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    v[j] = i < size ? to_float(x[i]) : 0.f;
    bits = max(bits, abs_bits(v[j]));
  }
  const float amax = block_abs_max(bits);

  const float scale = local_scale(amax);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    q[base + j * kThreads + threadIdx.x] = quantize(v[j], scale);
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
}

// Per 1024-element block: a[b] = max |x| over the block (tail as zeros).
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_block_kernel(const T* __restrict__ x, long long size,
                  float* __restrict__ a) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < size) bits = max(bits, abs_bits(to_float(x[i])));
  }
  const float amax = block_abs_max(bits);
  if (threadIdx.x == 0) a[blockIdx.x] = amax;
}

// q = clamp(rint(x / s'), -127, 127) with s' = s[block] if > 0 else 1;
// every q of the last block is written, the tail as 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_scaled_kernel(const T* __restrict__ x, long long size,
                    const float* __restrict__ s, int8_t* __restrict__ q) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const float raw = s[blockIdx.x];
  const float scale = raw > 0.f ? raw : 1.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    q[i] = quantize(i < size ? to_float(x[i]) : 0.f, scale);
  }
}

// out[i] = cvt(float(q[i]) * s[i / 1024]) for i < size; s already holds
// s * gain (folded into the nb-sized vector by the wrapper).
template <typename QT, typename OT>
__global__ void __launch_bounds__(kThreads)
dequant_int8_kernel(const QT* __restrict__ q, const float* __restrict__ s,
                    long long size, OT* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < size; i += stride) {
    out[i] = from_float<OT>(to_float(q[i]) * s[i / kBlock]);
  }
}

template <typename QT, typename OT>
void launch_dequant(const void* q, const void* s, long long size, void* out,
                    cudaStream_t stream) {
  const long long want = (size + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(want < (1ll << 30) ? want : (1ll << 30));
  dequant_int8_kernel<QT, OT><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const float*>(s), size,
      static_cast<OT*>(out));
}

}  // namespace

extern "C" int quant_int8_launch(const void* x, int x_dtype, long long size,
                                 void* q, void* s, long long n_blocks,
                                 void* stream) {
  if (size <= 0 || n_blocks != (size + kBlock - 1) / kBlock) return kRefused;
  if (n_blocks > 0x7fffffffll) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  if (x_dtype == kF32) {
    quant_int8_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), size, static_cast<int8_t*>(q),
        static_cast<float*>(s));
  } else if (x_dtype == kBF16) {
    quant_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), size, static_cast<int8_t*>(q),
        static_cast<float*>(s));
  } else {
    return kRefused;
  }
  return launch_status();
}

extern "C" int dequant_int8_launch(const void* q, int q_dtype, const void* s,
                                   long long size, void* out, int out_dtype,
                                   void* stream) {
  if (size <= 0) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kInt8 && out_dtype == kF32) {
    launch_dequant<int8_t, float>(q, s, size, out, st);
  } else if (q_dtype == kInt8 && out_dtype == kBF16) {
    launch_dequant<int8_t, __nv_bfloat16>(q, s, size, out, st);
  } else if (q_dtype == kInt32 && out_dtype == kF32) {
    launch_dequant<int32_t, float>(q, s, size, out, st);
  } else if (q_dtype == kInt32 && out_dtype == kBF16) {
    launch_dequant<int32_t, __nv_bfloat16>(q, s, size, out, st);
  } else {
    return kRefused;
  }
  return launch_status();
}

extern "C" int amax_block_launch(const void* x, int x_dtype, long long size,
                                 void* a, long long n_blocks, void* stream) {
  if (size <= 0 || n_blocks != (size + kBlock - 1) / kBlock) return kRefused;
  if (n_blocks > 0x7fffffffll) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  if (x_dtype == kF32) {
    amax_block_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), size, static_cast<float*>(a));
  } else if (x_dtype == kBF16) {
    amax_block_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), size, static_cast<float*>(a));
  } else {
    return kRefused;
  }
  return launch_status();
}

extern "C" int quant_scaled_launch(const void* x, int x_dtype, long long size,
                                   const void* s, void* q, long long n_blocks,
                                   void* stream) {
  if (size <= 0 || n_blocks != (size + kBlock - 1) / kBlock) return kRefused;
  if (n_blocks > 0x7fffffffll) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  if (x_dtype == kF32) {
    quant_scaled_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), size, static_cast<const float*>(s),
        static_cast<int8_t*>(q));
  } else if (x_dtype == kBF16) {
    quant_scaled_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), size, static_cast<const float*>(s),
        static_cast<int8_t*>(q));
  } else {
    return kRefused;
  }
  return launch_status();
}
