// Slot packing of the gradient sync's comm buffer, alone and fused with the
// local-scale int8 codec.
//
// Replaces two Pallas kernels of src/repro/kernels/quant.py:
//   pack_slots_launch       <- pack_slots_call       (_pack_leaf_kernel, one
//                                                     pallas_call per leaf)
//   fused_pack_quant_launch <- fused_pack_quant_call (pack into f32, then
//                                                     quant_int8_call)
//
// Both read a device-side table of spans, one row of five int64 per span:
//   (source address or 0, offset in the buffer, length, first tile, dtype)
// The spans cover [0, padded) of the buffer exactly once, in order: a leaf
// part's span copies it, a null span (a gap, the tail pad) writes zeros.  So
// one launch fills the whole buffer and nothing zero-fills it first (the TPU
// kernel writes leaf by leaf into a zeroed buffer that it aliases).  The
// wrapper (kernels/quant.py) builds the table at each call, since the
// gradients' addresses change every step, and copies it to the card through
// pinned memory on the launch stream: no synchronizing copy, no size limit.
//
// pack_slots is bound by bytes: each source read once, the buffer written
// once.  At qwen2.5-3b one bf16 segment of 3,085,938,688 values: 6.17 GB
// read and 6.17 GB written, 3.68 ms at 3.35 TB/s.  A block copies one tile
// of one span (the wrapper passes the tile's length with the table), so no tile straddles two spans and a block
// finds its span with one binary search over the first-tile column.  Where
// the tile's source and destination are both 16-byte aligned and of one
// dtype (the common case: the port's segments share their leaves' dtype) it
// moves 16 bytes per thread per load; otherwise one element per thread per
// step, converting (bf16 -> f32 exactly; f32 -> bf16 to nearest even, as
// copy_ and astype round).  Offsets and lengths are 64-bit: the segment
// holds more than 2^31 values.
//
// fused_pack_quant is bound by bytes too: each source read once, the int8
// blocks and their scales written once.  One block per 1024 buffer values:
// thread 0 finds the span of the block's first value by binary search, each
// thread walks forward from there over the few spans the block touches (the
// current span held in registers, so a value costs one load of its source)
// and widens its 4 values to f32, and the block takes the amax,
// the local scale and the quantized values as quant_int8 does (codec.cuh).
// The f32 buffer never exists, and the blocks and scales are bit-equal to
// pack -> quant_int8: a bf16 value widens exactly, so packing bf16 or f32
// first gives the quantizer the same f32 values.

#include "codec.cuh"

namespace {

using namespace codec;

// One row of the span table (int64 x 5; kernels/quant.py _span_table).
struct Span {
  long long src;     // device address of the source, 0 for zeros
  long long dst;     // first element of the span in the buffer
  long long n;       // length in elements
  long long tile0;   // pack_slots: the span's first tile
  long long dtype;   // source dtype code, kF32 or kBF16
};
static_assert(sizeof(Span) == 40, "a table row is five int64");

constexpr int kPackThreads = 256;

// Element i of a bf16 or f32 source, as f32 (bf16 widens exactly).
__device__ __forceinline__ float load_float(const void* src, long long dtype, long long i) {
  return dtype == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i])
                        : static_cast<const float*>(src)[i];
}

template <typename OT>
__global__ void __launch_bounds__(kPackThreads)
pack_slots_kernel(const Span* __restrict__ spans, int n_spans, long long tile_len,
                  OT* __restrict__ buf) {
  __shared__ int span_idx;
  const long long tile = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_spans - 1;               // the last span with tile0 <= tile
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (spans[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
    }
    span_idx = lo;
  }
  __syncthreads();
  const Span sp = spans[span_idx];
  const long long start = (tile - sp.tile0) * tile_len;
  const long long count = min(tile_len, sp.n - start);
  OT* out = buf + sp.dst + start;
  if (sp.src == 0) {
    for (long long i = threadIdx.x; i < count; i += kPackThreads) out[i] = from_float<OT>(0.f);
    return;
  }
  const long long src_bytes = sp.dtype == kBF16 ? 2 : 4;
  const char* src = reinterpret_cast<const char*>(sp.src) + start * src_bytes;
  if (src_bytes != static_cast<long long>(sizeof(OT))) {
    for (long long i = threadIdx.x; i < count; i += kPackThreads)
      out[i] = from_float<OT>(load_float(src, sp.dtype, i));
    return;
  }
  long long done = 0;                           // elements moved as 16-byte vectors
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const long long n_vec = count * static_cast<long long>(sizeof(OT)) / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(out);
#pragma unroll 4
    for (long long v = threadIdx.x; v < n_vec; v += kPackThreads) d4[v] = s4[v];
    done = n_vec * 16 / static_cast<long long>(sizeof(OT));
  }
  const OT* s = reinterpret_cast<const OT*>(src);
  for (long long i = done + threadIdx.x; i < count; i += kPackThreads) out[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
fused_pack_quant_kernel(const Span* __restrict__ spans, int n_spans,
                        int8_t* __restrict__ q, float* __restrict__ s) {
  __shared__ int first;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_spans - 1;               // the last span with dst <= base
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (spans[mid].dst <= base) lo = mid; else hi = mid - 1;
    }
    first = lo;
  }
  __syncthreads();
  int k = first;
  Span sp = spans[k];                           // kept in registers while it lasts
  float v[kPerThread];
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    while (sp.dst + sp.n <= i && k < n_spans - 1) sp = spans[++k];
    v[j] = sp.src != 0 ? load_float(reinterpret_cast<const void*>(sp.src), sp.dtype,
                                    i - sp.dst)
                       : 0.f;
    bits = max(bits, abs_bits(v[j]));
  }
  const float scale = local_scale(block_abs_max(bits));
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    q[base + j * kThreads + threadIdx.x] = quantize(v[j], scale);
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
}

}  // namespace

extern "C" int pack_slots_launch(const void* spans, int n_spans, long long n_tiles,
                                 long long tile_len, void* buf, int buf_dtype,
                                 void* stream) {
  if (n_spans <= 0 || n_tiles <= 0 || n_tiles > 0x7fffffffll || tile_len <= 0)
    return kRefused;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* table = static_cast<const Span*>(spans);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (buf_dtype == kF32) {
    pack_slots_kernel<float><<<grid, kPackThreads, 0, st>>>(
        table, n_spans, tile_len, static_cast<float*>(buf));
  } else if (buf_dtype == kBF16) {
    pack_slots_kernel<__nv_bfloat16><<<grid, kPackThreads, 0, st>>>(
        table, n_spans, tile_len, static_cast<__nv_bfloat16*>(buf));
  } else {
    return kRefused;
  }
  return launch_status();
}

extern "C" int fused_pack_quant_launch(const void* spans, int n_spans, long long n_blocks,
                                       void* q, void* s, void* stream) {
  if (n_spans <= 0 || n_blocks <= 0 || n_blocks > 0x7fffffffll) return kRefused;
  fused_pack_quant_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Span*>(spans), n_spans, static_cast<int8_t*>(q),
      static_cast<float*>(s));
  return launch_status();
}
