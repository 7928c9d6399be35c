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
// blocks and their scales written once (2.77 ms at 3.35 TB/s for the
// segment above), with quant_scaled's division, rint and conversion per
// value besides.  It is a streaming pass over warp-owned codec blocks.  Each
// CTA takes a contiguous run of blocks (the grid is what can be resident,
// capped per SM); each warp searches the table once, for its first block,
// 32 rows per round by ballot, then walks it forward as it takes every 8th
// block of the run, the current span in registers.  A block inside one
// source span whose first element is 16-byte aligned, which is every block
// inside a leaf at qwen2.5-3b (leaf sizes are multiples of 256, packed back
// to back), is loaded as 16-byte words, neighbouring lanes on neighbouring
// words, all before any is used; any other block (a span edge in it, a null
// span, an unaligned source) one value at a time, each lane walking the
// spans its values lie in.  Then the warp takes the amax by shuffles alone,
// the local scale and the quantized values as quant_int8 does (codec.cuh),
// and stores each unit's q packed (8 or 4 int8 in one store, neighbouring
// lanes on neighbouring words).  The f32 buffer never exists, and the blocks
// and scales are bit-equal to pack -> quant_int8: a bf16 value widens
// exactly, so packing bf16 or f32 first gives the quantizer the same f32
// values.

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
// Cap on fused_pack_quant's resident CTAs per SM.  Its 64 registers let 4
// fit; on an H100, forcing 8 (32 registers) ran 41% slower, 2 ran 13%
// slower.
constexpr int kFusedCtasPerSm = 8;

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

// The last span whose first element is <= i (spans[0].dst is 0), found by
// one warp: each round its lanes probe 32 evenly spaced rows of the range
// still open and keep, by ballot, the stretch after the last row at or
// before i; two rounds cover 1024 rows.
__device__ __forceinline__ int warp_find_span(const Span* spans, int n_spans, long long i,
                                              int lane) {
  int lo = 0, n = n_spans;                      // the answer lies in [lo, lo + n)
  while (n > 1) {
    const int step = (n + kWarpSize - 1) / kWarpSize;
    const int row = lo + lane * step;
    const unsigned le = __ballot_sync(0xffffffffu, row < lo + n && spans[row].dst <= i);
    const int k = kWarpSize - 1 - __clz(le);    // lane 0's row is lo: le is never 0
    lo += k * step;
    n = min(step, n - k * step);
  }
  return lo;
}

// A lane's share of a block is kLaneValues / kVec units of kVec values
// (kVec 4 or 8): value j of unit u is element (u * 32 + lane) * kVec + j of
// the block, so neighbouring lanes hold, and store the q of, neighbouring
// units.  store_unit puts the q of one unit's values (value(j), j < kVec)
// into one 4- or 8-byte store at dst.
template <int kVec, typename Value>
__device__ __forceinline__ void store_unit(Value value, float scale, int8_t* dst) {
  unsigned out[kVec / 4] = {};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    out[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(quantize(value(j), scale)))
                   << (8 * (j & 3));
  if constexpr (kVec == 8) {
    store8(dst, make_uint2(out[0], out[1]));
  } else {
    store4(dst, out[0]);
  }
}

// A block inside one source span whose first element is 16-byte aligned:
// one 16-byte word of src per unit (8 bf16 or 4 f32 values), every load
// issued before any value is used; then the warp's max, the local scale
// and the q from registers.  The source address comes from the table, so
// __ldg says it is global memory (a plain load would be generic).
template <typename T>
__device__ __forceinline__ void block_from_words(const T* src, int lane,
                                                 int8_t* __restrict__ qb, float* __restrict__ sb) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kUnits = kLaneValues / kVec;
  unsigned w[kUnits * 4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + (u * kWarpSize + lane) * kVec));
    w[4 * u] = v.x; w[4 * u + 1] = v.y; w[4 * u + 2] = v.z; w[4 * u + 3] = v.w;
  }
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kLaneValues; ++j) bits = max(bits, abs_bits(word_value<T>(w, j)));
  const float scale = local_scale(warp_abs_max(bits));
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
    store_unit<kVec>([&](int j) { return word_value<T>(w, u * kVec + j); }, scale,
                     qb + (u * kWarpSize + lane) * kVec);
  if (lane == 0) *sb = scale;
}

// The buffer's values at increasing i, one at a time: the table walked
// forward from span k (held in sp) over the spans they lie in.
struct SpanWalk {
  const Span* spans;
  int n_spans;
  int k;
  Span sp;

  __device__ __forceinline__ float operator()(long long i) {
    while (sp.dst + sp.n <= i && k + 1 < n_spans) sp = spans[++k];
    return sp.src != 0 ? load_float(reinterpret_cast<const void*>(sp.src), sp.dtype, i - sp.dst)
                       : 0.f;
  }
};

// Any other block (spans that start or end in it, a null span, a source
// not 16-byte aligned there), in units of 8 values taken one at a time,
// each lane walking the table from the warp's span over the spans its
// values lie in: once for the max, once more (from L1 or L2) for the q, so
// nothing of the block is held in registers.
__device__ __forceinline__ void block_from_values(const SpanWalk& from, long long base, int lane,
                                                  int8_t* __restrict__ qb,
                                                  float* __restrict__ sb) {
  constexpr int kVec = 8;
  SpanWalk walk = from;
  unsigned bits = 0;
  for (int u = 0; u < kLaneValues / kVec; ++u) {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      bits = max(bits, abs_bits(walk(base + (u * kWarpSize + lane) * kVec + j)));
  }
  const float scale = local_scale(warp_abs_max(bits));
  walk = from;
  for (int u = 0; u < kLaneValues / kVec; ++u) {
    const long long first = base + (u * kWarpSize + lane) * kVec;
    store_unit<kVec>([&](int j) { return walk(first + j); }, scale,
                     qb + (u * kWarpSize + lane) * kVec);
  }
  if (lane == 0) *sb = scale;
}

// Each CTA takes a contiguous run of per_cta blocks; warp w of it takes
// blocks w, w + 8, ... of the run, one at a time.  A warp searches the
// table once, for its first block, then walks it forward.
__global__ void __launch_bounds__(kThreads)
fused_pack_quant_kernel(const Span* __restrict__ spans, int n_spans, long long n_blocks,
                        long long per_cta, int8_t* __restrict__ q, float* __restrict__ s) {
  const int lane = threadIdx.x % kWarpSize;
  const long long end = min(n_blocks, (blockIdx.x + 1ll) * per_cta);
  long long b = blockIdx.x * per_cta + threadIdx.x / kWarpSize;
  if (b >= end) return;
  int k = warp_find_span(spans, n_spans, b * kBlock, lane);
  Span sp = spans[k];                           // the warp's span, in registers
  for (; b < end; b += kWarps) {
    const long long base = b * kBlock;
    while (sp.dst + sp.n <= base && k + 1 < n_spans) sp = spans[++k];
    const long long off = base - sp.dst;        // of the block in the span
    const long long src_bytes = sp.dtype == kBF16 ? 2 : 4;
    const long long addr = sp.src + off * src_bytes;
    if (sp.src != 0 && off + kBlock <= sp.n && (addr & 15) == 0) {
      if (sp.dtype == kBF16) {
        block_from_words(reinterpret_cast<const __nv_bfloat16*>(addr), lane, q + base, s + b);
      } else {
        block_from_words(reinterpret_cast<const float*>(addr), lane, q + base, s + b);
      }
    } else {
      block_from_values(SpanWalk{spans, n_spans, k, sp}, base, lane, q + base, s + b);
    }
  }
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
  if (n_spans <= 0 || n_blocks <= 0) return kRefused;
  const unsigned grid = streaming_grid<fused_pack_quant_kernel, kFusedCtasPerSm>(
      (n_blocks + kWarps - 1) / kWarps);
  const long long per_cta = (n_blocks + grid - 1) / grid;
  fused_pack_quant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Span*>(spans), n_spans, n_blocks, per_cta, static_cast<int8_t*>(q),
      static_cast<float*>(s));
  return launch_status();
}
