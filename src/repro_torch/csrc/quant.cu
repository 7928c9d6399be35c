// Blockwise int8 codec of the disaggregated KV transfer.
//
// Replaces two Pallas kernels of src/repro/kernels/quant.py:
//   quant_int8_launch   <- quant_int8_call   (_quant_kernel)
//   dequant_int8_launch <- dequant_int8_call (_dequant_kernel)
//
// Per 1024-element block: amax = max|x|; s = amax * f32(1/127) (1.0 when
// amax is 0); q = clamp(rint(x / s), -127, 127).  The scale is the
// reciprocal product because the reference's compiled code computes
// amax / 127 so (XLA rewrites a division by a constant), which can differ
// from a true division by one ulp.  rintf and IEEE division (__fdiv_rn;
// the build never uses --use_fast_math) round as the reference's
// jnp.round (half to even) and x / s do, so q and s are bit-equal to the
// reference and to the plain version.  NaN inputs are not supported.
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

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;          // codec block (quant.py BLOCK)
constexpr int kThreads = 256;
constexpr int kPerThread = kBlock / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_int8_kernel(const T* __restrict__ x, long long size,
                  int8_t* __restrict__ q, float* __restrict__ s) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  float v[kPerThread];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    v[j] = i < size ? to_float(x[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = amax > 0.f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    float r = rintf(__fdiv_rn(v[j], scale));
    r = fminf(fmaxf(r, -127.f), 127.f);
    q[base + j * kThreads + threadIdx.x] = static_cast<int8_t>(r);
  }
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
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
