// FlashAttention forward (causal / sliding-window GQA) for Hopper.
//
// Replaces the Pallas kernel flash_attention_bhsd (_attn_kernel) of
// src/repro/kernels/flash_attention.py.  Same function: q (B,H,Sq,dh),
// k/v (B,K,Skv,dh), query head h reads kv head h / (H/K); masks causal
// (kpos <= q_offset + qi), window (kpos > qpos - window) and
// kpos < valid_kv; running max / sum / accumulator in f32; a row with no
// valid key gives 0 (the guard of flash_attention.py:67-70), and l == 0
// divides by 1 (:81).  q_offset and valid_kv are plain integers.  dh in
// {16, 32, 64, 80, 128} (a multiple of 16); other head sizes are refused.
//
// Three kernels, chosen by dtype and dh alone (the wrapper's route()):
//   bf16, dh 64 and 128   flash_attention_wgmma_kernel  (route "wgmma")
//   bf16, dh 16, 32, 80   flash_attention_mma_kernel    (route "mma")
//   f32, every dh         flash_attention_tf32x3_kernel (route "tf32x3")
// dh 64 and 128 cover every full-width configuration; 16, 32 and 80 only
// smoke models and small ranks.  f32 runs on no full-width path: the f32
// smoke models, the padded TP-8 f32 check and the serve example's f32
// rank.
//
// Bound on this card: operations.  At the serving shape (B=4, H=16, K=2,
// S=1024, dh=128, causal) one call does 17.2 GFLOP over the unmasked
// pairs against 38 MB of q, k, v and o: 0.0174 ms at 989 TFLOP/s bf16,
// far above the 295 operations per byte where an H100 turns
// compute-bound.  So the bf16 kernels keep the tensor cores fed and every
// other cost out of their way.
//
// wgmma (Hopper's own design).  Only wgmma reaches the full tensor-core
// rate, and it wants its operands in shared memory in the 128-byte
// swizzle, fed without costing the math warps instructions:
//   * TMA.  Four tensor maps (q, k, v, o), built on the host per call,
//     each 4-D over (dh, S, heads, B) with the caller's strides, so rows
//     past Sq or Skv inside one (b, head) read as zeros (never the next
//     sequence's rows) and rows past Sq are never written.  Boxes are 64
//     columns (128 bytes) wide in the 128-byte swizzle: dh 128 takes two
//     boxes a tile.
//   * Warp specialisation.  A block is three warpgroups: warpgroup 0
//     gives up its registers (setmaxnreg.dec to 24) and one thread of it
//     issues every load: the 128-row Q tile once, then 128-key K and V
//     tiles into a ring of 2 stages, each with a full and an empty
//     mbarrier.  Warpgroups 1 and 2 (setmaxnreg.inc to 240) own 64 query
//     rows each and walk the same key tiles.  At dh 128 the ring and Q
//     are 160 KB of shared memory: one block per SM.
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory; O += P V is wgmma m64n64k16 (one per 64 columns of dh) with
//     P in registers, and V read MN-major (key-major rows, the transpose
//     bit).  A warp's 16 rows of the accumulator have the mma.sync
//     layout, so P is S rounded to bf16 and re-packed in registers.
//   * 128-key tiles in 2 stages at both head sizes: 64-key tiles with 2
//     or 4 stages, 3 stages, and 2 blocks per SM at dh 64 measured no
//     faster (tools/flash_report.py --variants).
//   * Softmax in registers, quad shuffles for the row max, one
//     ex2.approx per score with log2(e) folded into the scale (with
//     exp2f the exponentials took a third of the time); element masks
//     only on tiles that cross an edge of the band, valid_kv or Skv; tiles
//     outside the band are never loaded (hymba's 1024-token window).
//   * Epilogue: O / l as bf16, staged in the warpgroup's own rows of the
//     Q tile (the boxes' swizzle), written by TMA stores.
//   * What bounds it (ablations on an H100 with tools/flash_report.py
//     --variants): at the qwen2.5-3b shape the loads alone, with the
//     consumers idle, take ~45% of its time (block starts and every Q
//     head's block re-reading its KV head's tiles from L2); the products
//     and the softmax of one warpgroup do not overlap.  Left for later, in
//     that order: a tile's softmax overlapping the next tile's Q K^T,
//     ping-pong of the two consumers, persistent blocks, GQA head packing,
//     clusters with multicast.
//
// mma (dh 16, 32, 80; the sm_80 instruction set):
//   * Tensor cores.  S = Q K^T and O += P V are mma.sync m16n8k16 bf16
//     products with f32 accumulators.  A block owns 64 query rows of one
//     (batch, head), 16 rows per warp, and walks 64-key tiles; m, l and
//     O stay in registers for the whole walk and the S x S scores never
//     leave the SM.
//   * Q once.  The Q tile is copied to shared memory with cp.async and
//     loaded once into registers as mma A-fragments (ldmatrix).
//   * K and V double-buffered.  16-byte cp.async.cg copies fill one
//     buffer while the tensor cores work on the other; rows past Skv
//     are zero-filled (src-size 0), so 0 * v stays finite.  Staged rows
//     are padded by 16 bytes: dh / 8 + 1 chunks is odd for every dh
//     taken, so the 8 rows of an ldmatrix hit 8 different bank groups.
//     K fragments come from ldmatrix, V fragments from ldmatrix.trans.
//   * P and the masks as in the wgmma kernel, the softmax too but with
//     exp2f (bf16 checks hold both kernels within 3e-2).
//   * Suspected limiters (unmeasured): one ldmatrix for every two HMMAs,
//     a __syncthreads pair per 64-key tile, mma.sync from every warp.
//
// Both bf16 kernels hand out the longest query tiles (the last ones of a
// causal prefill) first over every head, and read and write q, k, v and
// o through their strides (the caller's (B,S,H,dh) tensors, no
// transposes).  So they refuse bf16 tensors whose base or strides are
// not 16-byte aligned.
//
// tf32x3 (f32 inputs; the sm_80 instruction set):
//   * What bounds it: operations at f32 accuracy.  The CUDA cores' f32
//     FMAs peak at 67 TFLOP/s; the tensor cores run TF32 at 495, but one
//     TF32 product keeps about 2^-11 of each operand, short of the 2e-3
//     that f32 callers are held to.  Split each operand as hi = tf32(x)
//     (rounded to nearest), lo = x - hi (read as tf32) and take lo*hi +
//     hi*lo + hi*hi (mma.cuh's split_tf32 and mma_tf32x3, the small terms
//     first): about 2^-21 of each product, the precision of CUTLASS's
//     "fast f32", at 495 / 3 TFLOP/s.  At the
//     serving shape that bound is 3 x 17.2 GFLOP / 495 TFLOP/s = 0.1042
//     ms (0.2567 ms on the CUDA cores).
//   * S = Q K^T and O += P V are mma.sync m16n8k8 tf32 products, three
//     into one f32 accumulator.  A block owns 64 query rows of one
//     (batch, head), 16 a warp, and walks 32-key tiles (two blocks an SM
//     at dh 128).  mma.sync and not wgmma: tf32 wgmma takes both operands
//     K-major only, so V (key-major rows) would need a transposed copy of
//     every tile and the split hi / lo copies of K and V in shared
//     memory; mma.sync takes fragments from registers, where the split
//     costs three instructions a value.
//   * Fragments without shuffles.  The sums of both products run over an
//     axis whose order is free, so A's column t stands for element 2t of
//     a k-step and column t + 4 for 2t + 1: Q and K fragments are 8-byte
//     shared loads, S's accumulators are P's A-fragment as they stand,
//     and V's B-fragment pairs two dim blocks in one 8-byte load a row
//     (ldmatrix has no 32-bit transpose).  Staged rows are padded so
//     that every fragment load is free of bank conflicts (TfTiles).
//   * Registers: at dh 128, 64 accumulator floats a thread for O and 16
//     for S; Q's split fragments held whole would take 128 more, so Q
//     stays in shared memory and is read and split per k-step.
//   * K and V double-buffered by cp.async, 16 bytes a copy where every
//     base and stride allow it and 4 bytes otherwise (one kernel
//     templated on the width, so every f32 view is taken); rows past
//     Skv zero-filled.  Dynamic shared memory 256 (3 dh + 20) bytes a
//     block: 17408 at dh 16, 54272 at 64, 103424 at 128.
//   * Softmax once per score: each thread owns its fragment's scores,
//     row max and sum meet through quad shuffles, one ex2.approx per
//     score with log2(e) folded into the scale; element masks only on
//     tiles that cross an edge; tiles outside the band never loaded;
//     longest query tiles first, as the bf16 kernels.
//   * Measured through the C entry point (tools/flash_report.py
//     --baseline --variants f32, on an H100 80GB HBM3 at 700 W): 0.3200
//     ms at the serving shape, 33% of the 0.1042 ms bound, against 2.08-
//     2.10 ms for the CUDA-core kernel it replaced and 1.74 for f32
//     scaled_dot_product_attention; max error 1.6e-6 of the output's
//     largest magnitude.  With one TF32 product 0.1700 ms (error 4.1e-4),
//     loads only 0.0990, 64-key tiles (one block an SM) 0.4907, the split
//     by cvt.rna 0.4457, hi truncated 0.3369.  So the split's and the
//     fragments' instructions, from two warps a scheduler, bound it, not
//     the tensor pipe.

#include <climits>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;   // in elements; the dh axis has stride 1
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, K, Sq, Skv;
  Strides qs, ks, vs, os;
  float scale;
  int causal, window, q_offset, valid_kv;
};

// ---------------------------------------------------------------------------
// f32: tensor cores at f32 accuracy (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

constexpr int kTfWarps = 4;
constexpr int kTfRows = 16 * kTfWarps;     // query rows per block, 16 per warp
constexpr int kTfKeys = 32;                // keys per tile
constexpr int kTfThreads = 32 * kTfWarps;

// Staged rows, in floats.  With g = lane / 4 and t = lane % 4, a warp
// reads Q and K as 8-byte pairs at (row g, column 2t) and V as 8-byte
// pairs at (row 2t, column 2g); an 8-byte load is served per half-warp.
// Q and K rows of DH + 8 floats put (g, 2t) at bank 8g + 2t (or 24g + 2t),
// V rows of DH + 4 put (2t, 2g) at bank 8t + 2g: 32 distinct banks each.
template <int DH>
struct TfTiles {
  static constexpr int kQK = DH + 8;
  static constexpr int kV = DH + 4;
  static constexpr int kQ = kTfRows * kQK;    // floats
  static constexpr int kK = kTfKeys * kQK;
  static constexpr int kVT = kTfKeys * kV;
  // Q, then K[2], then V[2]: 256 (3 DH + 20) bytes, 103424 at dh 128
  static constexpr int kBytes = (kQ + 2 * kK + 2 * kVT) * 4;
};

// ROWS rows of DH floats from `src` (row stride `ld`) into shared rows of
// STRIDE floats at `dst`, VEC bytes a cp.async (16, or 4 for views that
// are not 16-byte aligned); rows at or past `avail` are zero-filled.
template <int DH, int ROWS, int STRIDE, int VEC>
__device__ __forceinline__ void load_f32_rows(uint32_t dst, const float* src, long long ld,
                                              int row0, int avail) {
  constexpr int kPer = VEC / 4;            // floats a copy
  constexpr int kCopies = ROWS * (DH / kPer);
  constexpr int kPasses = (kCopies + kTfThreads - 1) / kTfThreads;
  const auto copy = [&](int i) {
    const int c = threadIdx.x + i * kTfThreads;
    if (kCopies % kTfThreads != 0 && c >= kCopies) return;   // a part pass
    const int r = c / (DH / kPer), col = (c % (DH / kPer)) * kPer;
    const bool ok = row0 + r < avail;
    const float* g = ok ? src + (row0 + r) * ld + col : src;
    const uint32_t d = dst + (r * STRIDE + col) * 4;
    if constexpr (VEC == 16) {
      cp_async_16(d, g, ok);
    } else {
      cp_async_4(d, g, ok);
    }
  };
  if constexpr (VEC == 16) {
#pragma unroll
    for (int i = 0; i < kPasses; ++i) copy(i);
  } else {
    // up to 64 copies a tile: unrolled whole, their addresses were held
    // across the tile loop and spilled
#pragma unroll 4
    for (int i = 0; i < kPasses; ++i) copy(i);
  }
}

template <int DH, int VEC>
__global__ void __launch_bounds__(kTfThreads, 2)
flash_attention_tf32x3_kernel(const FlashArgs a, int n_qtiles, int B) {
  using T = TfTiles<DH>;
  constexpr int kN = kTfKeys / 8;       // 8-key blocks of S, k-steps of P V
  extern __shared__ __align__(128) unsigned char tf_smem[];
  float* const sq = reinterpret_cast<float*>(tf_smem);
  float* const sk = sq + T::kQ;         // two buffers
  float* const sv = sk + 2 * T::kK;

  // longest query tiles first over the whole grid; heads vary fastest
  const int h = blockIdx.x % a.H;
  const int rest = blockIdx.x / a.H;
  const int b = rest % B;
  const int qt = n_qtiles - 1 - rest / B;
  const int kvh = h / (a.H / a.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kTfRows;

  const auto* qp = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const auto* kp = static_cast<const float*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const auto* vp = static_cast<const float*>(a.v) + b * a.vs.b + kvh * a.vs.h;

  // kv tiles this query tile can see; tiles outside are never loaded
  const int last_q = min(q0 + kTfRows, a.Sq) - 1 + a.q_offset;
  int k_end = a.valid_kv;
  if (a.causal) k_end = min(k_end, last_q + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.q_offset - a.window + 1);
  k_begin = (k_begin / kTfKeys) * kTfKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTfKeys - 1) / kTfKeys : 0;

  load_f32_rows<DH, kTfRows, T::kQK, VEC>(smem_u32(sq), qp, a.qs.s, q0, a.Sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_f32_rows<DH, kTfKeys, T::kQK, VEC>(smem_u32(sk), kp, a.ks.s, k_begin, a.Skv);
    load_f32_rows<DH, kTfKeys, T::kV, VEC>(smem_u32(sv), vp, a.vs.s, k_begin, a.Skv);
  }
  cp_async_commit();

  // this warp's 16 rows and the keys they can see
  const int wq0 = q0 + 16 * warp;
  const bool warp_rows = wq0 < a.Sq;
  const int w_first = wq0 + a.q_offset;
  const int w_last = min(wq0 + 16, a.Sq) - 1 + a.q_offset;
  int wk_end = a.valid_kv, wk_begin = 0;
  if (a.causal) wk_end = min(wk_end, w_last + 1);
  if (a.window > 0) wk_begin = max(0, w_first - a.window + 1);
  // a thread's two rows, g and g + 8 of the warp's 16, see the keys in
  // [kmin, kmax)
  int kmin[2], kmax[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w_first + g + 8 * r;
    kmax[r] = a.causal ? min(a.valid_kv, qpos + 1) : a.valid_kv;
    kmin[r] = a.window > 0 ? qpos - a.window + 1 : INT_MIN;
  }
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const float* qw = sq + 16 * warp * T::kQK;    // this warp's Q rows

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kTfKeys;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {             // the next tile loads while this one computes
      load_f32_rows<DH, kTfKeys, T::kQK, VEC>(smem_u32(sk + (buf ^ 1) * T::kK), kp, a.ks.s,
                                             k0 + kTfKeys, a.Skv);
      load_f32_rows<DH, kTfKeys, T::kV, VEC>(smem_u32(sv + (buf ^ 1) * T::kVT), vp, a.vs.s,
                                            k0 + kTfKeys, a.Skv);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();     // Q and tile `it` have landed
    __syncthreads();

    if (warp_rows && k0 < wk_end && k0 + kTfKeys > wk_begin) {
      const float* kb = sk + buf * T::kK;
      const float* vb = sv + buf * T::kVT;

      // S = Q K^T: 16 x 32, 4 accumulators of 16 x 8.  A sum over dims
      // takes them in any order, so A's column t stands for dim 2t of the
      // k-step and column t + 4 for dim 2t + 1 (B's rows likewise): each
      // fragment pair is one 8-byte load.  Q is read and split per k-step,
      // as its split fragments held whole would take 4 DH registers.
      float s[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const float2 qa = *reinterpret_cast<const float2*>(qw + g * T::kQK + 8 * kk + 2 * t);
        const float2 qb =
            *reinterpret_cast<const float2*>(qw + (g + 8) * T::kQK + 8 * kk + 2 * t);
        uint32_t qh[4], ql[4];
        split_tf32(qa.x, qh[0], ql[0]);
        split_tf32(qb.x, qh[1], ql[1]);
        split_tf32(qa.y, qh[2], ql[2]);
        split_tf32(qb.y, qh[3], ql[3]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float2 kf =
              *reinterpret_cast<const float2*>(kb + (8 * j + g) * T::kQK + 8 * kk + 2 * t);
          uint32_t h0, l0, h1, l1;
          split_tf32(kf.x, h0, l0);
          split_tf32(kf.y, h1, l1);
          mma_tf32x3(s[j], qh, ql, h0, h1, l0, l1);
        }
      }

      // element masks only on a tile that crosses an edge of the band
      const bool interior = k0 + kTfKeys <= a.valid_kv &&
                            (!a.causal || k0 + kTfKeys - 1 <= w_first) &&
                            (a.window <= 0 || k0 > w_last - a.window);
      if (!interior) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + 2 * t + (e & 1);
            if (kpos < kmin[e >> 1] || kpos >= kmax[e >> 1]) s[j][e] = kNegInf;
          }
        }
      }

      // online softmax, one ex2 per score; a row's max meets over its quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no valid key so far keeps ms = 0: its scores and old
        // max (kNegInf) give ex2 of about -1e29, that is 0
        ms[r] = mx[r] > kNegInf / 2 ? mx[r] * scale_log2 : 0.f;
        alpha[r] = exp2_approx(fmaf(m[r], scale_log2, -ms[r]));
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
        o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(fmaf(s[j][e], scale_log2, -ms[e >> 1]));
          l[e >> 1] += s[j][e];
        }
      }

      // O += P V, a k-step per key block j.  With A's column t standing
      // for key 2t of the block and column t + 4 for key 2t + 1, S's
      // accumulators are P's A-fragment as they stand (a0..a3 = c0, c2,
      // c1, c3), and V's B-fragment is rows 2t and 2t + 1.  B's column g
      // is dim 2g of a 16-dim pair of blocks for the first block and
      // 2g + 1 for the second, so one 8-byte load a row feeds both, and a
      // thread's outputs are 4 neighbouring dims: 16d + 4t .. 16d + 4t + 3.
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* v0 = vb + (8 * j + 2 * t) * T::kV + 2 * g;
#pragma unroll
        for (int d = 0; d < DH / 16; ++d) {
          const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * d);
          const float2 x1 = *reinterpret_cast<const float2*>(v0 + T::kV + 16 * d);
          uint32_t h0, l0, h1, l1;
          split_tf32(x0.x, h0, l0);
          split_tf32(x1.x, h1, l1);
          mma_tf32x3(o[2 * d], ph, pl, h0, h1, l0, l1);
          split_tf32(x0.y, h0, l0);
          split_tf32(x1.y, h1, l1);
          mma_tf32x3(o[2 * d + 1], ph, pl, h0, h1, l0, l1);
        }
      }
    }
    __syncthreads();    // buffer `buf` is refilled at it + 1
  }
  cp_async_wait_all();                  // Q's copy, where no tile was walked
  if (!warp_rows) return;

  // O / l: row g + 8r, dims 16d + 4t .. + 3 from blocks 2d and 2d + 1
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  auto* op = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row >= a.Sq) continue;
    float* dst = op + row * a.os.s + 4 * t;
#pragma unroll
    for (int d = 0; d < DH / 16; ++d) {
      const float4 val = make_float4(o[2 * d][2 * r] * inv[r], o[2 * d + 1][2 * r] * inv[r],
                                     o[2 * d][2 * r + 1] * inv[r],
                                     o[2 * d + 1][2 * r + 1] * inv[r]);
      if constexpr (VEC == 16) {
        *reinterpret_cast<float4*>(dst + 16 * d) = val;
      } else {
        dst[16 * d] = val.x;
        dst[16 * d + 1] = val.y;
        dst[16 * d + 2] = val.z;
        dst[16 * d + 3] = val.w;
      }
    }
  }
}

template <int DH, int VEC>
int launch_tf32x3_dh(const FlashArgs& a, int B, cudaStream_t stream) {
  // above 48 KB the dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tf32x3_kernel<DH, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TfTiles<DH>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qtiles = (a.Sq + kTfRows - 1) / kTfRows;
  const long long blocks = static_cast<long long>(n_qtiles) * a.H * B;
  if (blocks > 0x7fffffffLL) return kRefused;
  flash_attention_tf32x3_kernel<DH, VEC><<<static_cast<unsigned>(blocks), kTfThreads,
                                           TfTiles<DH>::kBytes, stream>>>(a, n_qtiles, B);
  return launch_status();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBr = 16 * kWarps;        // query rows per block, 16 per warp
constexpr int kBc = 64;                 // keys per tile
constexpr int kMmaThreads = 32 * kWarps;

template <int DH>
struct Tiles {
  static constexpr int kStride = DH + 8;          // staged row, 16 bytes of pad
  static constexpr int kChunks = DH / 8;          // 16-byte chunks per row
  static constexpr int kQ = kBr * kStride;        // elements
  static constexpr int kKV = kBc * kStride;
  // Q, then K[2], then V[2]
  static constexpr int kBytes = (kQ + 4 * kKV) * 2;
};

// ROWS rows of DH values from `src` (row stride `ld`) into shared rows
// of Tiles<DH>::kStride; rows at or past `avail` are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int avail) {
  using T = Tiles<DH>;
  static_assert((ROWS * T::kChunks) % kMmaThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < ROWS * T::kChunks / kMmaThreads; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = c / T::kChunks, ch = c % T::kChunks;
    const bool ok = row0 + r < avail;
    const __nv_bfloat16* g = ok ? src + (row0 + r) * ld + ch * 8 : src;
    cp_async_16(dst + (r * T::kStride + ch * 8) * 2, g, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_attention_mma_kernel(const FlashArgs a, int n_qtiles, int B) {
  using T = Tiles<DH>;
  constexpr int kSteps = DH / 16;       // k-steps of Q K^T, d-pairs of P V
  constexpr int kN = kBc / 8;           // 8-key column blocks of S
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + T::kQ * 2;             // two buffers
  const uint32_t s_v = s_k + 2 * T::kKV * 2;

  // longest query tiles first over the whole grid; heads vary fastest
  const int h = blockIdx.x % a.H;
  const int rest = blockIdx.x / a.H;
  const int b = rest % B;
  const int qt = n_qtiles - 1 - rest / B;
  const int kh = h / (a.H / a.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kBr;

  const auto* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const auto* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const auto* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + kh * a.vs.h;

  // kv tiles this query tile can see; tiles outside are never loaded
  const int last_q = min(q0 + kBr, a.Sq) - 1 + a.q_offset;
  int k_end = a.valid_kv;
  if (a.causal) k_end = min(k_end, last_q + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.q_offset - a.window + 1);
  k_begin = (k_begin / kBc) * kBc;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBc - 1) / kBc : 0;

  load_tile<DH, kBr>(s_q, qp, a.qs.s, q0, a.Sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DH, kBc>(s_k, kp, a.ks.s, k_begin, a.Skv);
    load_tile<DH, kBc>(s_v, vp, a.vs.s, k_begin, a.Skv);
  }
  cp_async_commit();

  // this warp's 16 rows and the keys they can see
  const int wq0 = q0 + 16 * warp;
  const bool warp_rows = wq0 < a.Sq;
  const int w_first = wq0 + a.q_offset;
  const int w_last = min(wq0 + 16, a.Sq) - 1 + a.q_offset;
  int wk_end = a.valid_kv, wk_begin = 0;
  if (a.causal) wk_end = min(wk_end, w_last + 1);
  if (a.window > 0) wk_begin = max(0, w_first - a.window + 1);
  // a thread's two rows, lane / 4 and lane / 4 + 8 of the warp's 16, see
  // the keys in [kmin, kmax)
  int kmin[2], kmax[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w_first + lane / 4 + 8 * r;
    kmax[r] = a.causal ? min(a.valid_kv, qpos + 1) : a.valid_kv;
    kmin[r] = a.window > 0 ? qpos - a.window + 1 : INT_MIN;
  }
  const float scale_log2 = a.scale * 1.4426950408889634f;

  cp_async_wait_all_but_newest();       // Q has landed
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(s_q + ((16 * warp + (lane & 15)) * T::kStride + kk * 16 + (lane >> 4) * 8) * 2,
                qf[kk]);

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBc;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {              // the next tile loads while this one computes
      const uint32_t nb = (buf ^ 1) * T::kKV * 2;
      load_tile<DH, kBc>(s_k + nb, kp, a.ks.s, k0 + kBc, a.Skv);
      load_tile<DH, kBc>(s_v + nb, vp, a.vs.s, k0 + kBc, a.Skv);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();     // tile t has landed
    __syncthreads();

    if (warp_rows && k0 < wk_end && k0 + kBc > wk_begin) {
      const uint32_t kb = s_k + buf * T::kKV * 2;
      const uint32_t vb = s_v + buf * T::kKV * 2;

      // S = Q K^T: a 16 x 64 tile, 8 accumulators of 16 x 8
      float s[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int j = 0; j < kN; j += 2) {
          uint32_t kf[4];   // b-fragments of key blocks j and j + 1
          ldmatrix_x4(kb + ((j * 8 + (lane & 7) + ((lane >> 4) << 3)) * T::kStride
                            + kk * 16 + ((lane >> 3) & 1) * 8) * 2, kf);
          mma_bf16(s[j], qf[kk], kf[0], kf[1]);
          mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // element masks only on a tile that crosses an edge of the band
      const bool interior = k0 + kBc <= a.valid_kv &&
                            (!a.causal || k0 + kBc - 1 <= w_first) &&
                            (a.window <= 0 || k0 > w_last - a.window);
      if (!interior) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
            if (kpos < kmin[e >> 1] || kpos >= kmax[e >> 1]) s[j][e] = kNegInf;
          }
        }
      }

      // online softmax; a row's max meets over its quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], ms[2];
      bool safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no valid key so far: exp(NEG_INF - NEG_INF) would be 1
        safe[r] = mx[r] > kNegInf / 2;
        ms[r] = mx[r] * scale_log2;
        alpha[r] = safe[r] ? exp2f(m[r] * scale_log2 - ms[r]) : 1.f;
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
        o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = safe[r] ? exp2f(fmaf(s[j][e], scale_log2, -ms[r])) : 0.f;
          s[j][e] = p;
          l[r] += p;
        }
      }

      // O += P V: the accumulators of key blocks 2c and 2c + 1 are the
      // A-fragment of keys 16c .. 16c + 15
#pragma unroll
      for (int c = 0; c < kBc / 16; ++c) {
        const uint32_t pf[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int d = 0; d < kSteps; ++d) {
          uint32_t vf[4];   // b-fragments of dim blocks 2d and 2d + 1
          ldmatrix_x4_trans(vb + ((c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::kStride
                                  + d * 16 + (lane >> 4) * 8) * 2, vf);
          mma_bf16(o[2 * d], pf, vf[0], vf[1]);
          mma_bf16(o[2 * d + 1], pf, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();    // buffer `buf` is refilled at t + 1
  }
  if (!warp_rows) return;

  // O / l, staged as bf16 in this warp's own Q rows, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  auto* so = reinterpret_cast<__nv_bfloat16*>(smem) + 16 * warp * T::kStride;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(so + (lane / 4) * T::kStride + col) =
        pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (lane / 4 + 8) * T::kStride + col) =
        pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  auto* op = static_cast<__nv_bfloat16*>(a.o) + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int i = 0; i < 16 * T::kChunks / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / T::kChunks, ch = c % T::kChunks;
    if (wq0 + r < a.Sq)
      *reinterpret_cast<uint4*>(op + (wq0 + r) * a.os.s + ch * 8) =
          *reinterpret_cast<const uint4*>(so + r * T::kStride + ch * 8);
  }
}

template <int DH>
int launch_mma_dh(const FlashArgs& a, int B, cudaStream_t stream) {
  // above 48 KB the dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tiles<DH>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qtiles = (a.Sq + kBr - 1) / kBr;
  const long long blocks = static_cast<long long>(n_qtiles) * a.H * B;
  if (blocks > 0x7fffffffLL) return kRefused;
  flash_attention_mma_kernel<DH><<<static_cast<unsigned>(blocks), kMmaThreads,
                                   Tiles<DH>::kBytes, stream>>>(a, n_qtiles, B);
  return launch_status();
}

// ---------------------------------------------------------------------------
// bf16 at dh 64 and 128: TMA, an mbarrier ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;           // query rows per block
constexpr int kWgConsumerRows = 64;    // of them per consumer warpgroup
constexpr int kWgKeys = 128;           // keys per tile
constexpr int kWgStages = 2;           // K/V tiles in the ring
constexpr int kWgThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kWgConsumerWarps = 8;
constexpr int kProducerRegs = 24;      // 128 x 24 + 256 x 240 = 384 x 168, what
constexpr int kConsumerRegs = 240;     // a block holds at launch
constexpr int kBox = 64;               // bf16 columns per TMA box
constexpr int kBoxRowBytes = 128;      // one 128-byte swizzle row

template <int DH>
struct WgSmem {
  static constexpr int kBoxes = DH / kBox;                // boxes per tile row
  static constexpr int kQBox = kWgRows * kBoxRowBytes;    // one 64-column box
  static constexpr int kKVBox = kWgKeys * kBoxRowBytes;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKV = kBoxes * kKVBox;             // one K or V tile
  // full[stages], empty[stages], q: 8 bytes each
  static constexpr int kBars = 8 * (2 * kWgStages + 1);
  // 1024 of slack puts the tiles on the swizzle's 1024-byte boundary
  static constexpr int kBytes = 1024 + kQ + 2 * kWgStages * kKV + kBars;
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to,
                             const FlashArgs a, int n_qtiles, int B) {
  using L = WgSmem<DH>;
  constexpr int kN = kWgKeys / 8;       // 8-key column blocks of S
  extern __shared__ unsigned char wg_smem[];
  const uint32_t s_q = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t s_k = s_q + L::kQ;                     // kWgStages tiles
  const uint32_t s_v = s_k + kWgStages * L::kKV;
  const uint32_t bar_full = s_v + kWgStages * L::kKV;   // kWgStages barriers
  const uint32_t bar_empty = bar_full + 8 * kWgStages;
  const uint32_t bar_q = bar_empty + 8 * kWgStages;

  // longest query tiles first over the whole grid; heads vary fastest
  const int h = blockIdx.x % a.H;
  const int rest = blockIdx.x / a.H;
  const int b = rest % B;
  const int qt = n_qtiles - 1 - rest / B;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * kWgRows;

  // kv tiles this query tile can see; the producer loads exactly these
  // and both consumers walk them, so tiles outside are never loaded
  const int last_q = min(q0 + kWgRows, a.Sq) - 1 + a.q_offset;
  int k_end = a.valid_kv;
  if (a.causal) k_end = min(k_end, last_q + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.q_offset - a.window + 1);
  k_begin = (k_begin / kWgKeys) * kWgKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWgKeys - 1) / kWgKeys : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);                  // the producer, plus bytes
      mbar_init(bar_empty + 8 * st, kWgConsumerWarps);  // every consumer warp
    }
    mbar_init(bar_q, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int role = threadIdx.x / 128;   // 0 producer, 1 and 2 consumers
  if (role == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(bar_q, L::kQ);
      for (int j = 0; j < L::kBoxes; ++j)
        tma_load_4d(s_q + j * L::kQBox, &tq, bar_q, j * kBox, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kWgStages;
        // the consumers have released this stage's previous tile
        mbar_wait(bar_empty + 8 * st, ((t / kWgStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_arrive_expect_tx(full, 2 * L::kKV);
        const int k0 = k_begin + t * kWgKeys;
        for (int j = 0; j < L::kBoxes; ++j) {
          tma_load_4d(s_k + st * L::kKV + j * L::kKVBox, &tk, full, j * kBox, k0, kh, b);
          tma_load_4d(s_v + st * L::kKV + j * L::kKVBox, &tv, full, j * kBox, k0, kh, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // this consumer's 64 rows and the keys they can see
  const int c = role - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wq0 = q0 + kWgConsumerRows * c;
  const bool wg_rows = wq0 < a.Sq;
  const int w_first = wq0 + a.q_offset;
  const int w_last = min(wq0 + kWgConsumerRows, a.Sq) - 1 + a.q_offset;
  int wk_end = a.valid_kv, wk_begin = 0;
  if (a.causal) wk_end = min(wk_end, w_last + 1);
  if (a.window > 0) wk_begin = max(0, w_first - a.window + 1);
  // a thread's two rows, 16 warp + lane / 4 and 8 below it, see the keys
  // in [kmin, kmax)
  int kmin[2], kmax[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = w_first + 16 * warp + lane / 4 + 8 * r;
    kmax[r] = a.causal ? min(a.valid_kv, qpos + 1) : a.valid_kv;
    kmin[r] = a.window > 0 ? qpos - a.window + 1 : INT_MIN;
  }
  const float scale_log2 = a.scale * 1.4426950408889634f;
  // this consumer's rows of each Q box (a multiple of 1024 bytes in)
  const uint32_t q_rows = s_q + kWgConsumerRows * c * kBoxRowBytes;

  float o[L::kBoxes][32];
#pragma unroll
  for (int j = 0; j < L::kBoxes; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kWgKeys;
    const int st = t % kWgStages;
    mbar_wait(bar_full + 8 * st, (t / kWgStages) & 1);
    if (wg_rows && k0 < wk_end && k0 + kWgKeys > wk_begin) {
      const uint32_t kb = s_k + st * L::kKV, vb = s_v + st * L::kKV;

      // S = Q K^T: 64 x kWgKeys, k16 slices 32 bytes apart inside a box
      float s[kWgKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss(
            s, sw128_desc(q_rows + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
            sw128_desc(kb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // element masks only on a tile that crosses an edge of the band
      const bool interior = k0 + kWgKeys <= a.valid_kv &&
                            (!a.causal || k0 + kWgKeys - 1 <= w_first) &&
                            (a.window <= 0 || k0 > w_last - a.window);
      if (!interior) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
            if (kpos < kmin[e >> 1] || kpos >= kmax[e >> 1]) s[4 * j + e] = kNegInf;
          }
        }
      }

      // online softmax; a row's max meets over its quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // A row with no valid key so far keeps ms = 0, so its scores and old
        // max (kNegInf) give exp2 of about -1e29, that is 0, where exp(NEG_INF
        // - NEG_INF) would be 1; no select per element.
        ms[r] = mx[r] > kNegInf / 2 ? mx[r] * scale_log2 : 0.f;
        alpha[r] = exp2_approx(fmaf(m[r], scale_log2, -ms[r]));
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < kWgKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], scale_log2, -ms[r]));
        l[r] += s[i];
      }

      // O += P V: the accumulators of key blocks 2c and 2c + 1 are the
      // A-fragment of keys 16c .. 16c + 15; V's k16 slice is 16 rows
      uint32_t pf[kWgKeys / 16][4];
#pragma unroll
      for (int kc = 0; kc < kWgKeys / 16; ++kc) {
        pf[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        pf[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pf[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pf[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kWgKeys / 16; ++kc)
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j)
          wgmma_m64n64k16_rs_tb(
              o[j], pf[kc],
              sw128_desc(vb + j * L::kKVBox + kc * 16 * kBoxRowBytes, 1024, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j) fence_regs(o[j]);
    }
    // this warp no longer reads the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }
  if (!wg_rows) return;

  // O / l as bf16 into this consumer's rows of the Q boxes, in their
  // swizzle (chunk c of row r at c ^ (r % 8)); one TMA store per box,
  // which drops the rows past Sq
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
#pragma unroll
  for (int j = 0; j < L::kBoxes; ++j) {
#pragma unroll
    for (int blk = 0; blk < kBox / 8; ++blk) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        st_shared_u32(q_rows + j * L::kQBox + row * kBoxRowBytes + ((blk ^ (row & 7)) << 4)
                          + (lane & 3) * 4,
                      pack_bf16(o[j][4 * blk + 2 * r] * inv[r],
                                o[j][4 * blk + 2 * r + 1] * inv[r]));
      }
    }
  }
  fence_proxy_async_smem();
  named_barrier_sync(1 + c, 128);
  if (threadIdx.x % 128 == 0) {
    for (int j = 0; j < L::kBoxes; ++j)
      tma_store_4d(&to, q_rows + j * L::kQBox, j * kBox, wq0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A map over a bf16 (B, heads, rows, dh) view: 4-D, innermost first
// (dh, rows, heads, B) with the view's strides, so a box never runs from
// one (b, head) into the next; boxes of 64 columns x box_rows rows in the
// 128-byte swizzle, zeros read past the edges.  An axis of extent 1 is
// never stepped: its stride (free in the view) is given as one row's.
int tensor_map(CUtensorMap* map, const void* base, int dh, int rows, int heads, int B,
               const Strides& st, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const auto bytes = [dh](long long stride, int extent) {
    return static_cast<cuuint64_t>(extent == 1 ? dh : stride) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st.s, rows), bytes(st.h, heads), bytes(st.b, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(box_rows),
                             1u, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kRefused;
}

template <int DH>
int launch_wgmma_dh(const FlashArgs& a, int B, cudaStream_t stream) {
  using L = WgSmem<DH>;
  // Once: ask for the dynamic shared memory, and check that the registers
  // a block holds at launch cover what setmaxnreg.inc asks for (a
  // shortfall would leave the consumers waiting for good).
  static const cudaError_t setup = [] {
    cudaFuncAttributes f{};
    cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&f, flash_attention_wgmma_kernel<DH>);
    if (e == cudaSuccess &&
        f.numRegs * kWgThreads < 128 * kProducerRegs + 256 * kConsumerRegs)
      e = cudaErrorLaunchOutOfResources;
    return e;
  }();
  if (setup != cudaSuccess) return static_cast<int>(setup);
  CUtensorMap tq, tk, tv, to;
  int err = tensor_map(&tq, a.q, DH, a.Sq, a.H, B, a.qs, kWgRows);
  if (err == 0) err = tensor_map(&tk, a.k, DH, a.Skv, a.K, B, a.ks, kWgKeys);
  if (err == 0) err = tensor_map(&tv, a.v, DH, a.Skv, a.K, B, a.vs, kWgKeys);
  if (err == 0) err = tensor_map(&to, a.o, DH, a.Sq, a.H, B, a.os, kWgConsumerRows);
  if (err != 0) return err;
  const int n_qtiles = (a.Sq + kWgRows - 1) / kWgRows;
  const long long blocks = static_cast<long long>(n_qtiles) * a.H * B;
  if (blocks > 0x7fffffffLL) return kRefused;
  flash_attention_wgmma_kernel<DH><<<static_cast<unsigned>(blocks), kWgThreads, L::kBytes,
                                     stream>>>(tq, tk, tv, to, a, n_qtiles, B);
  return launch_status();
}

// 16-byte cp.async and stores: every base and every stride that is used
// (an axis of extent 1 is never stepped) a multiple of 16 bytes, kPer16
// values (8 bf16, 4 f32)
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
template <int kPer16>
bool strides_ok(const Strides& s, int B, int heads, int rows) {
  const auto step_ok = [](long long stride, int extent) {
    return extent == 1 || stride % kPer16 == 0;
  };
  return step_ok(s.b, B) && step_ok(s.h, heads) && step_ok(s.s, rows);
}

// f32 takes any strides: 16-byte copies and stores where q, k, v and o
// all allow them, 4-byte ones otherwise (one kernel, two instantiations)
int launch_tf32x3(const FlashArgs& a, int B, int dh, cudaStream_t stream) {
  const bool v16 = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.o) &&
                   strides_ok<4>(a.qs, B, a.H, a.Sq) && strides_ok<4>(a.ks, B, a.K, a.Skv) &&
                   strides_ok<4>(a.vs, B, a.K, a.Skv) && strides_ok<4>(a.os, B, a.H, a.Sq);
  switch (dh) {
    case 16: return v16 ? launch_tf32x3_dh<16, 16>(a, B, stream)
                        : launch_tf32x3_dh<16, 4>(a, B, stream);
    case 32: return v16 ? launch_tf32x3_dh<32, 16>(a, B, stream)
                        : launch_tf32x3_dh<32, 4>(a, B, stream);
    case 64: return v16 ? launch_tf32x3_dh<64, 16>(a, B, stream)
                        : launch_tf32x3_dh<64, 4>(a, B, stream);
    case 80: return v16 ? launch_tf32x3_dh<80, 16>(a, B, stream)
                        : launch_tf32x3_dh<80, 4>(a, B, stream);
    case 128: return v16 ? launch_tf32x3_dh<128, 16>(a, B, stream)
                         : launch_tf32x3_dh<128, 4>(a, B, stream);
    default: return kRefused;
  }
}

int launch_bf16(const FlashArgs& a, int B, int dh, cudaStream_t stream) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.o))
    return kRefused;
  if (!strides_ok<8>(a.qs, B, a.H, a.Sq) || !strides_ok<8>(a.ks, B, a.K, a.Skv) ||
      !strides_ok<8>(a.vs, B, a.K, a.Skv) || !strides_ok<8>(a.os, B, a.H, a.Sq))
    return kRefused;
  switch (dh) {
    case 16: return launch_mma_dh<16>(a, B, stream);
    case 32: return launch_mma_dh<32>(a, B, stream);
    case 64: return launch_wgmma_dh<64>(a, B, stream);
    case 80: return launch_mma_dh<80>(a, B, stream);
    case 128: return launch_wgmma_dh<128>(a, B, stream);
    default: return kRefused;
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int K, int Sq, int Skv, int dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, int q_offset, int valid_kv,
    void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Skv <= 0)
    return kRefused;
  if (valid_kv < 0 || valid_kv > Skv || window < 0) return kRefused;
  FlashArgs a{q, k, v, o, H, K, Sq, Skv,
              {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
              {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
              scale, causal, window, q_offset, valid_kv};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_tf32x3(a, B, dh, st);
  if (dtype == kBF16) return launch_bf16(a, B, dh, st);
  return kRefused;
}
