// FlashAttention-2 forward (causal / sliding-window GQA) for Hopper.
//
// Replaces the Pallas kernel flash_attention_bhsd (_attn_kernel) of
// src/repro/kernels/flash_attention.py.  Same function: q (B,H,Sq,dh),
// k/v (B,K,Skv,dh), query head h reads kv head h / (H/K); masks causal
// (kpos <= q_offset + qi), window (kpos > qpos - window) and
// kpos < valid_kv; running max / sum / accumulator in f32; a row with no
// valid key gives 0 (the guard of flash_attention.py:67-70), and l == 0
// divides by 1 (:81).  q_offset and valid_kv are plain integers.
//
// Bound on this card: operations.  At the serving shape (B=4, H=16,
// S=1024, dh=128, causal) one call does about 17 GFLOP against about
// 38 MB of q, k, v and o, far above the 295 operations per byte where an
// H100 turns compute-bound.  This first version computes in f32 on the
// CUDA cores (peak 67 TFLOP/s), not on the tensor cores (989 TFLOP/s in
// bf16); wgmma and TMA are later work.  What the design does about the
// bound:
//   * The TPU grid walked kv tiles as a sequential grid axis with m, l
//     and acc in VMEM scratch.  Here one block owns (b, h, 64-query
//     tile) and loops over 32-key tiles itself; m, l and acc live in
//     registers for the whole loop, and the S x S scores never leave
//     the SM.
//   * kv tiles that lie wholly outside the causal or window band are
//     skipped, not masked: about half the work of a causal prefill.
//   * Four threads share a query row.  Thread `sub` owns the dims
//     16c + 4sub .. 16c + 4sub + 3, so a row's four threads read four
//     neighbouring float4s of a staged K or V row (no bank conflicts)
//     and the other rows of the warp read the same words (broadcast).
//     The partial q.k sums meet through two warp shuffles.
//   * The kernel masks ragged Sq and Skv itself and reads q, k, v and
//     writes o through strides, so the caller's (B,S,H,dh) tensors need
//     no transpose copies and dh needs no padding.
// dh in {16, 32, 64, 80, 128} (a multiple of 16); other head sizes are
// refused.

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;
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

template <typename T>
int launch_for_dtype(const FlashArgs& a, int B, int dh, cudaStream_t stream) {
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, B);
  switch (dh) {
    case 16: flash_attention_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(a); break;
    case 80: flash_attention_kernel<T, 80><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(a); break;
    default: return kRefused;
  }
  return launch_status();
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
  if (H > 65535 || B > 65535 || valid_kv < 0 || valid_kv > Skv || window < 0)
    return kRefused;
  FlashArgs a{q, k, v, o, H, K, Sq, Skv,
              {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
              {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
              scale, causal, window, q_offset, valid_kv};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_for_dtype<float>(a, B, dh, st);
  if (dtype == kBF16) return launch_for_dtype<__nv_bfloat16>(a, B, dh, st);
  return kRefused;
}
