// FlashAttention-2 forward (causal / sliding-window GQA) for Hopper.
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
// Bound on this card: operations.  At the serving shape (B=4, H=16, K=2,
// S=1024, dh=128, causal) one call does 17.2 GFLOP over the unmasked
// pairs against 38 MB of q, k, v and o: 0.0174 ms at 989 TFLOP/s bf16,
// far above the 295 operations per byte where an H100 turns
// compute-bound.  So the bf16 kernel keeps the tensor cores fed and
// every other cost out of their way:
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
//   * P in registers.  The m16n8 accumulator layout of two neighbouring
//     S tiles is the m16k16 A-layout, so P is rounded to bf16 and fed to
//     P V without a trip through shared memory (as every tensor-core
//     flash kernel does; bf16 checks hold it within 3e-2).
//   * Softmax in registers.  A thread holds 2 rows; the row max meets
//     over the 4 threads of a quad in 2 shuffles per tile, the row sum
//     only once at the end.  exp2f with log2(e) folded into the scale.
//   * Masks only where needed.  Tiles wholly outside a warp's causal or
//     window band are skipped (about half of a causal prefill); element
//     masks run only on tiles that cross an edge of the band, valid_kv
//     or Skv.
//   * Causal balance.  The flat grid hands out the longest query tiles
//     (the last ones of a causal prefill) first, over every head.
//   * Strided in and out.  q, k, v and o are read and written through
//     their strides (the caller's (B,S,H,dh) tensors, no transposes);
//     the output tile is staged in the Q tile's shared memory and
//     written with 16-byte stores.  So the kernel refuses bf16 tensors
//     whose base or strides are not 16-byte aligned.
//
// f32 inputs run the first version's kernel: f32 FMAs on the CUDA cores
// (67 TFLOP/s peak).  TF32 tensor cores keep about three decimal digits,
// short of the 2e-3 that f32 callers are held to.

#include <climits>

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
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;

// Four threads share a query row: thread `sub` owns the dims
// 16c + 4sub .. 16c + 4sub + 3, so a row's four threads read four
// neighbouring float4s of a staged K or V row and the partial q.k sums
// meet through two warp shuffles.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FlashArgs a) {
  constexpr int kChunks = DH / 16;      // float4 groups owned by a thread
  __shared__ __align__(16) float k_tile[kBlockK * DH];
  __shared__ __align__(16) float v_tile[kBlockK * DH];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int row = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x % kThreadsPerRow;
  const int qi = qt * kBlockQ + row;
  const bool row_ok = qi < a.Sq;
  const int qpos = qi + a.q_offset;

  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = c * 16 + sub * 4;
    if (row_ok) {
      const T* src = qp + static_cast<long long>(qi) * a.qs.s + d;
      qr[c] = make_float4(to_float(src[0]), to_float(src[1]),
                          to_float(src[2]), to_float(src[3]));
    } else {
      qr[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // kv range this query tile can see; tiles outside it are skipped
  const int last_q = min(qt * kBlockQ + kBlockQ, a.Sq) - 1 + a.q_offset;
  const int first_q = qt * kBlockQ + a.q_offset;
  int k_end = a.valid_kv;
  if (a.causal) k_end = min(k_end, last_q + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, first_q - a.window + 1);
  k_begin = (k_begin / kBlockK) * kBlockK;

  const float4* k4 = reinterpret_cast<const float4*>(k_tile);
  const float4* v4 = reinterpret_cast<const float4*>(v_tile);

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBlockK * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH;
      const int kpos = k0 + j;
      float kv = 0.f, vv = 0.f;   // zeros past Skv keep 0 * v finite
      if (kpos < a.Skv) {
        kv = to_float(kp[static_cast<long long>(kpos) * a.ks.s + d]);
        vv = to_float(vp[static_cast<long long>(kpos) * a.vs.s + d]);
      }
      k_tile[idx] = kv;
      v_tile[idx] = vv;
    }
    __syncthreads();

    float sc[kBlockK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = k4[j * (DH / 4) + c * 4 + sub];
        dot += qr[c].x * kk.x + qr[c].y * kk.y + qr[c].z * kk.z + qr[c].w * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + j;
      bool ok = kpos < a.valid_kv;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      sc[j] = ok ? dot * a.scale : kNegInf;
      m_cur = fmaxf(m_cur, sc[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const bool safe = m_new > kNegInf / 2;
    const float alpha = safe ? expf(m - m_new) : 1.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = safe ? expf(sc[j] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = v4[j * (DH / 4) + c * 4 + sub];
        acc[c].x += p * vv.x; acc[c].y += p * vv.y;
        acc[c].z += p * vv.z; acc[c].w += p * vv.w;
      }
    }
    l = alpha * l + psum;
    m = m_new;
  }

  if (!row_ok) return;
  const float denom = l == 0.f ? 1.f : l;
  T* op = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h +
          static_cast<long long>(qi) * a.os.s;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = c * 16 + sub * 4;
    op[d + 0] = from_float<T>(acc[c].x / denom);
    op[d + 1] = from_float<T>(acc[c].y / denom);
    op[d + 2] = from_float<T>(acc[c].z / denom);
    op[d + 3] = from_float<T>(acc[c].w / denom);
  }
}

int launch_f32(const FlashArgs& a, int B, int dh, cudaStream_t stream) {
  if (a.H > 65535 || B > 65535) return kRefused;
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, B);
  switch (dh) {
    case 16: flash_attention_kernel<float, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: flash_attention_kernel<float, 32><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: flash_attention_kernel<float, 64><<<grid, kThreads, 0, stream>>>(a); break;
    case 80: flash_attention_kernel<float, 80><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: flash_attention_kernel<float, 128><<<grid, kThreads, 0, stream>>>(a); break;
    default: return kRefused;
  }
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

// 16-byte cp.async and stores: every base and every stride that is used
// (an axis of extent 1 is never stepped) a multiple of 8 bf16 values
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
bool step_ok(long long stride, int extent) { return extent == 1 || stride % 8 == 0; }
bool strides_ok(const Strides& s, int B, int heads, int rows) {
  return step_ok(s.b, B) && step_ok(s.h, heads) && step_ok(s.s, rows);
}

int launch_bf16(const FlashArgs& a, int B, int dh, cudaStream_t stream) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.o))
    return kRefused;
  if (!strides_ok(a.qs, B, a.H, a.Sq) || !strides_ok(a.ks, B, a.K, a.Skv) ||
      !strides_ok(a.vs, B, a.K, a.Skv) || !strides_ok(a.os, B, a.H, a.Sq))
    return kRefused;
  switch (dh) {
    case 16: return launch_mma_dh<16>(a, B, stream);
    case 32: return launch_mma_dh<32>(a, B, stream);
    case 64: return launch_mma_dh<64>(a, B, stream);
    case 80: return launch_mma_dh<80>(a, B, stream);
    case 128: return launch_mma_dh<128>(a, B, stream);
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
  if (dtype == kF32) return launch_f32(a, B, dh, st);
  if (dtype == kBF16) return launch_bf16(a, B, dh, st);
  return kRefused;
}
