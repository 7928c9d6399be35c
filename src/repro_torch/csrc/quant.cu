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
// (1 to 4 bytes in, 1 to 4 bytes out, plus 4 bytes of scale per 1024),
// with at most one division per element: far below the 295 operations per
// byte at which an H100 stops being memory-bound.  Every kernel is one
// pass and reads bf16 or f32 directly, treating the ragged tail as zeros,
// which replaces the JAX path's f32 upcast and zero-pad concatenate (two
// payload-sized copies; bf16 -> f32 is exact, so the bits are the same).
// Element indices are 64-bit: the gradient segment holds more than 2^31.
//
// quant_int8 runs one 256-thread CTA per 1024-value block, one element per
// thread and load, neighbouring threads on neighbouring addresses, and
// keeps the block in registers between its amax reduction and its
// quantize, so the payload is read once.  The
// shared-scale codec splits the quantizer in two so the per-block amax can
// be agreed across the pod group (an all-reduce MAX of nb floats) before
// the quantize: amax_block reads the payload once and writes nb floats;
// quant_scaled reads it again with the agreed scale and writes int8
// (qwen2.5-3b's gradient segment: 3.09e9 bf16 values, 6.17 GB read by
// each, 3.09 GB written by the second), and dequant_int8 decodes the
// int32 ring sum into bf16 (12.3 GB read, 6.17 GB written).
//
// quant_scaled and dequant_int8 are streaming passes with nothing to keep
// on chip, so their speed is the bytes they keep in flight.  Little's law
// asks for about 3.35 TB/s x ~0.7 us / 132 SMs ~ 18 KB per SM; one element
// per thread (a 1- to 4-byte load each, at most 2048 resident threads)
// gives 2-8 KB.  So in their vector variant each lane owns 32 values of an
// 8192-value tile and issues all its loads of the tile before it uses any:
// quant_scaled loads 16-byte words of x (8 bf16 or 4 f32 values) and
// stores their q packed, 8 or 4 int8 in one store; dequant_int8 stores one
// 16-byte word of out (8 bf16 or 4 f32 values) per unit and loads the q
// behind it (two 16-byte words or one of int32, 8 or 4 bytes of int8).
// Neighbouring lanes take neighbouring units, so every store instruction
// of a warp covers whole 32-byte sectors (a lane storing 2 or 4 adjacent
// 16-byte words leaves each instruction half of every sector, and runs
// the int8 -> f32 decode at half the rate).  A unit's values lie in one
// 1024-value block, so
// the scale is loaded once per unit, beside the payload.  The CTAs walk
// the tiles with a grid stride (tile bases 64-bit, offsets in a tile
// 32-bit), as many as can be resident up to a cap per SM: quant_scaled's
// IEEE division, rint and conversion per value bound it by arithmetic
// more than by bytes, so it takes every warp it can (8 CTAs asked, 6 fit
// at 40 registers); the decode runs best with about 64 KB of loads in
// flight per SM and slower with more (2 CTAs for int32 in, 8 for int8).
// In the same kernel, what is left past the last whole tile goes one unit
// at a time, then one value at a time: quant_scaled writes every q of the
// last block (the tail as 0), dequant_int8 exactly `size` values.  The
// arithmetic per value is the scalar kernel's, so the bits are too.
//
// amax_block is a pure read (nb floats out), so its vector variant is the
// same streaming pass with the block max done by warps: a warp owns whole
// blocks, its lanes load 16-byte words of each (4 a lane for bf16, 8 for
// f32; neighbouring lanes on neighbouring words), issue every load of the
// tile before they take any max, and reduce abs_bits by shuffles only: no
// shared memory, no barrier (the scalar kernel's block max passes through
// shared memory behind a __syncthreads, one 2-4 KB block per CTA).  The
// CTAs per SM are capped by the bytes of loads in flight, as the decode's
// are.  The blocks past the last whole tile go one per warp, whole words
// then single values, the tail as zeros.
//
// Each of the three has a second, scalar variant: the vector kernel needs a
// 16-byte-aligned payload base, and a view at another offset occurs (the
// pipelined sync's chunks of a shard are not cut at BLOCK; any contiguous
// (nb, 1024) view may be decoded).  The wrapper picks by the base's
// alignment and counts the vector launches; the C entry refuses a vector
// launch on a misaligned base.

#include "codec.cuh"

namespace {

using namespace codec;

// Caps on the vector kernels' resident CTAs per SM (at 256 threads, 8 fill
// an SM; the header says why): quant_scaled's, and the decode's and
// amax_block's as the bytes of loads in flight per SM over a CTA's loads
// per tile.
constexpr int kQuantScaledCtasPerSm = 8;
constexpr int kDequantLoadBytesPerSm = 64 * 1024;
// amax_block on an H100: 32 to 128 KB and 1 or 2 blocks per warp ran
// within 0.3% of each other, 16 KB 13% slower.
constexpr int kAmaxLoadBytesPerSm = 64 * 1024;
constexpr int kAmaxBlocksPerWarp = 1;   // blocks a warp loads per tile

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
// Scalar variant: one CTA per block, one element per thread and load.
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

// The largest abs_bits of the values in one 16-byte word of x.
template <typename T>
__device__ __forceinline__ unsigned word_abs_bits(uint4 in) {
  const unsigned w[4] = {in.x, in.y, in.z, in.w};
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    m = max(m, abs_bits(word_value<T>(w, j)));
  return m;
}

// Vector variant of amax_block_kernel; x 16-byte aligned.  A tile is
// kAmaxBlocksPerWarp blocks per warp; lane l loads words l, l + 32, ... of
// each of its warp's blocks, all of them before it takes any max.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_block_vec_kernel(const T* __restrict__ x, long long size,
                      float* __restrict__ a, long long n_blocks) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWords = kLaneValues / kVec;            // per lane and block: 4 bf16, 8 f32
  constexpr int kTileBlocks = kWarps * kAmaxBlocksPerWarp;
  const int lane = threadIdx.x % kWarpSize, warp = threadIdx.x / kWarpSize;
  const long long tiles = size / (static_cast<long long>(kTileBlocks) * kBlock);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    uint4 in[kAmaxBlocksPerWarp][kWords];
#pragma unroll
    for (int r = 0; r < kAmaxBlocksPerWarp; ++r) {
      const T* xb = x + (t * kTileBlocks + r * kWarps + warp) * kBlock;
#pragma unroll
      for (int u = 0; u < kWords; ++u) in[r][u] = load16(xb + (u * kWarpSize + lane) * kVec);
    }
#pragma unroll
    for (int r = 0; r < kAmaxBlocksPerWarp; ++r) {
      unsigned bits = 0;
#pragma unroll
      for (int u = 0; u < kWords; ++u) bits = max(bits, word_abs_bits<T>(in[r][u]));
      const float amax = warp_abs_max(bits);
      if (lane == 0) a[t * kTileBlocks + r * kWarps + warp] = amax;
    }
  }
  // The blocks past the last whole tile, the ragged last one included, one
  // per warp: its whole words, then its last values one at a time.
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long b = tiles * kTileBlocks + blockIdx.x * kWarps + warp; b < n_blocks;
       b += warps) {
    const T* xb = x + b * kBlock;
    const int n = static_cast<int>(min(static_cast<long long>(kBlock), size - b * kBlock));
    unsigned bits = 0;
    for (int w = lane; w < n / kVec; w += kWarpSize)
      bits = max(bits, word_abs_bits<T>(load16(xb + w * kVec)));
    for (int i = n / kVec * kVec + lane; i < n; i += kWarpSize)
      bits = max(bits, abs_bits(to_float(xb[i])));
    const float amax = warp_abs_max(bits);
    if (lane == 0) a[b] = amax;
  }
}

// q = clamp(rint(x / s'), -127, 127) with s' = s[block] if > 0 else 1;
// every q of the last block is written, the tail as 0.  Scalar variant:
// one CTA per block, one element per thread and access.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_scaled_kernel(const T* __restrict__ x, long long size,
                    const float* __restrict__ s, int8_t* __restrict__ q) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const float scale = shared_divisor(s[blockIdx.x]);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    q[i] = quantize(i < size ? to_float(x[i]) : 0.f, scale);
  }
}

// One 16-byte word of x (8 bf16 or 4 f32 values, one block) -> its q in
// one 8- or 4-byte store.
template <typename T>
__device__ __forceinline__ void quant_word(uint4 in, float scale, int8_t* q) {
  constexpr int kVec = 16 / sizeof(T);
  const unsigned w[4] = {in.x, in.y, in.z, in.w};
  unsigned out[kVec / 4] = {};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    out[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(quantize(word_value<T>(w, j), scale)))
                   << (8 * (j & 3));
  if constexpr (kVec == 8) {
    store8(q, make_uint2(out[0], out[1]));
  } else {
    store4(q, out[0]);
  }
}

// Vector variant of quant_scaled_kernel; x and q 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_scaled_vec_kernel(const T* __restrict__ x, long long size,
                        const float* __restrict__ s, int8_t* __restrict__ q,
                        long long n_q) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWords = kPerLane / kVec;
  const long long tiles = size / kTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTile;
    const float* st = s + base / kBlock;
    uint4 in[kWords];
    float raw[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int off = (u * kThreads + threadIdx.x) * kVec;
      in[u] = load16(x + base + off);
      raw[u] = st[off / kBlock];
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u)
      quant_word<T>(in[u], shared_divisor(raw[u]), q + base + (u * kThreads + threadIdx.x) * kVec);
  }
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long lanes = static_cast<long long>(gridDim.x) * kThreads;
  const long long words_end = size / kVec * kVec;
  for (long long i = tiles * kTile + lane * kVec; i < words_end; i += lanes * kVec)
    quant_word<T>(load16(x + i), shared_divisor(s[i / kBlock]), q + i);
  for (long long i = words_end + lane; i < n_q; i += lanes)
    q[i] = quantize(i < size ? to_float(x[i]) : 0.f, shared_divisor(s[i / kBlock]));
}

// out[i] = cvt(float(q[i]) * s[i / 1024]) for i < size; s already holds
// s * gain (folded into the nb-sized vector by the wrapper).  Scalar
// variant: one element per thread and access.
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

// dequant_int8's unit: the values of one 16-byte word of out (8 bf16 or 4
// f32; all in one block), so that neighbouring lanes store neighbouring
// words; their q is two 16-byte words or one (int32), or 8 or 4 bytes (int8).
template <typename QT, typename OT>
struct DequantUnit {
  static constexpr int kValues = 16 / sizeof(OT);
  static constexpr int kInBytes = kValues * sizeof(QT);
  static constexpr int kInWords = kInBytes / 4;

  static __device__ __forceinline__ void load(const QT* q, unsigned* w) {
    if constexpr (kInBytes >= 16) {
#pragma unroll
      for (int k = 0; k < kInBytes / 16; ++k) {
        const uint4 v = load16(q + k * (16 / sizeof(QT)));
        w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
      }
    } else if constexpr (kInBytes == 8) {
      const uint2 v = load8(q);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = load4(q);
    }
  }

  static __device__ __forceinline__ void decode(const unsigned* w, float scale, OT* out) {
    unsigned o[4] = {};
#pragma unroll
    for (int j = 0; j < kValues; ++j) put_value<OT>(o, j, word_value<QT>(w, j) * scale);
    store16(out, make_uint4(o[0], o[1], o[2], o[3]));
  }
};

// Vector variant of dequant_int8_kernel; q and out 16-byte aligned.
template <typename QT, typename OT>
__global__ void __launch_bounds__(kThreads)
dequant_int8_vec_kernel(const QT* __restrict__ q, const float* __restrict__ s,
                        long long size, OT* __restrict__ out) {
  using Unit = DequantUnit<QT, OT>;
  constexpr int kVec = Unit::kValues;
  constexpr int kUnits = kPerLane / kVec;
  const long long tiles = size / kTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kTile;
    const float* st = s + base / kBlock;
    unsigned in[kUnits][Unit::kInWords];
    float scale[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int off = (u * kThreads + threadIdx.x) * kVec;
      Unit::load(q + base + off, in[u]);
      scale[u] = st[off / kBlock];
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
      Unit::decode(in[u], scale[u], out + base + (u * kThreads + threadIdx.x) * kVec);
  }
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long lanes = static_cast<long long>(gridDim.x) * kThreads;
  const long long units_end = size / kVec * kVec;
  for (long long i = tiles * kTile + lane * kVec; i < units_end; i += lanes * kVec) {
    unsigned in[Unit::kInWords];
    Unit::load(q + i, in);
    Unit::decode(in, s[i / kBlock], out + i);
  }
  for (long long i = units_end + lane; i < size; i += lanes)
    out[i] = from_float<OT>(to_float(q[i]) * s[i / kBlock]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename QT, typename OT>
void launch_dequant(const void* q, const void* s, long long size, void* out,
                    bool vector, cudaStream_t stream) {
  auto qp = static_cast<const QT*>(q);
  auto sp = static_cast<const float*>(s);
  auto op = static_cast<OT*>(out);
  if (vector) {
    constexpr int kCtasPerSm = std::max<int>(1, kDequantLoadBytesPerSm / (kTile * sizeof(QT)));
    const unsigned grid =
        streaming_grid<dequant_int8_vec_kernel<QT, OT>, kCtasPerSm>((size + kTile - 1) / kTile);
    dequant_int8_vec_kernel<QT, OT><<<grid, kThreads, 0, stream>>>(qp, sp, size, op);
    return;
  }
  const long long want = (size + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(want < (1ll << 30) ? want : (1ll << 30));
  dequant_int8_kernel<QT, OT><<<grid, kThreads, 0, stream>>>(qp, sp, size, op);
}

template <typename T>
void launch_amax_block(const void* x, long long size, void* a, long long n_blocks,
                       bool vector, cudaStream_t stream) {
  auto xp = static_cast<const T*>(x);
  auto ap = static_cast<float*>(a);
  if (vector) {
    constexpr int kTileBlocks = kWarps * kAmaxBlocksPerWarp;
    constexpr int kCtasPerSm =
        std::max<int>(1, kAmaxLoadBytesPerSm / (kTileBlocks * kBlock * sizeof(T)));
    const unsigned grid = streaming_grid<amax_block_vec_kernel<T>, kCtasPerSm>(
        (n_blocks + kTileBlocks - 1) / kTileBlocks);
    amax_block_vec_kernel<T><<<grid, kThreads, 0, stream>>>(xp, size, ap, n_blocks);
    return;
  }
  amax_block_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(xp, size, ap);
}

template <typename T>
void launch_quant_scaled(const void* x, long long size, const void* s, void* q,
                         long long n_blocks, bool vector, cudaStream_t stream) {
  auto xp = static_cast<const T*>(x);
  auto sp = static_cast<const float*>(s);
  auto qp = static_cast<int8_t*>(q);
  if (vector) {
    const unsigned grid = streaming_grid<quant_scaled_vec_kernel<T>, kQuantScaledCtasPerSm>(
        (size + kTile - 1) / kTile);
    quant_scaled_vec_kernel<T><<<grid, kThreads, 0, stream>>>(xp, size, sp, qp,
                                                              n_blocks * kBlock);
    return;
  }
  quant_scaled_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
      xp, size, sp, qp);
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

// vector: 1 for the vector variant (q and out 16-byte aligned), 0 for the
// scalar one.
extern "C" int dequant_int8_launch(const void* q, int q_dtype, const void* s,
                                   long long size, void* out, int out_dtype,
                                   int vector, void* stream) {
  if (size <= 0) return kRefused;
  if (vector && !(aligned16(q) && aligned16(out))) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kInt8 && out_dtype == kF32) {
    launch_dequant<int8_t, float>(q, s, size, out, vector, st);
  } else if (q_dtype == kInt8 && out_dtype == kBF16) {
    launch_dequant<int8_t, __nv_bfloat16>(q, s, size, out, vector, st);
  } else if (q_dtype == kInt32 && out_dtype == kF32) {
    launch_dequant<int32_t, float>(q, s, size, out, vector, st);
  } else if (q_dtype == kInt32 && out_dtype == kBF16) {
    launch_dequant<int32_t, __nv_bfloat16>(q, s, size, out, vector, st);
  } else {
    return kRefused;
  }
  return launch_status();
}

// vector: 1 for the vector variant (x 16-byte aligned), 0 for the scalar one.
extern "C" int amax_block_launch(const void* x, int x_dtype, long long size,
                                 void* a, long long n_blocks, int vector,
                                 void* stream) {
  if (size <= 0 || n_blocks != (size + kBlock - 1) / kBlock) return kRefused;
  if (n_blocks > 0x7fffffffll) return kRefused;
  if (vector && !aligned16(x)) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) {
    launch_amax_block<float>(x, size, a, n_blocks, vector, st);
  } else if (x_dtype == kBF16) {
    launch_amax_block<__nv_bfloat16>(x, size, a, n_blocks, vector, st);
  } else {
    return kRefused;
  }
  return launch_status();
}

// vector: 1 for the vector variant (x and q 16-byte aligned), 0 for the
// scalar one.
extern "C" int quant_scaled_launch(const void* x, int x_dtype, long long size,
                                   const void* s, void* q, long long n_blocks,
                                   int vector, void* stream) {
  if (size <= 0 || n_blocks != (size + kBlock - 1) / kBlock) return kRefused;
  if (n_blocks > 0x7fffffffll) return kRefused;
  if (vector && !(aligned16(x) && aligned16(q))) return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) {
    launch_quant_scaled<float>(x, size, s, q, n_blocks, vector, st);
  } else if (x_dtype == kBF16) {
    launch_quant_scaled<__nv_bfloat16>(x, size, s, q, n_blocks, vector, st);
  } else {
    return kRefused;
  }
  return launch_status();
}
