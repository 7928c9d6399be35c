// Mamba2 SSD chunk (state-space duality, the within-chunk part) for Hopper.
//
// Replaces the Pallas kernel ssd_chunk_call (_ssd_chunk_kernel) of
// src/repro/kernels/ssd.py.  Same function, per (batch b, chunk c, head h)
// over the chunk's q positions:
//   dA_cs   = cumsum(dt * A)                                 (q,)
//   L[i,j]  = exp(dA_cs[i] - dA_cs[j]) for j <= i, masked to -1e30 BEFORE
//             the exp (so 0 above the diagonal)
//   y_diag  = ((C B^T) * L) (x * dt)                          (q, p)
//   states  = x^T (B * exp(dA_cs[q-1] - dA_cs) * dt)          (p, n)
// The inter-chunk scan and y_off stay in PyTorch (kernels/ops.py).
//
// Layout: x (b, s, h, p), dt (b, s, h), B and C (b, s, g, n) are read
// through element strides (the last axis contiguous; x, B and C four
// elements at a time, so their strides and base addresses are multiples
// of four elements), so the caller's views of the conv output need no
// copy; head h reads group
// h / (h_total / g) of B and C, so the repeat over heads that the
// reference materializes (kernels/ops.py:76-77) never exists.  Outputs:
// y_diag (b, nc, q, h, p) f32 (the model's sequence-major order, so the
// caller adds y_off without a transpose) and states (b, nc, h, p, n) f32,
// both contiguous.  s must be a multiple of q: the caller pads.
//
// Bound on this card.  At the mamba2-2.7b prefill (b 4, s 1024, h 80,
// p 64, g 1, n 128, q 128) one call moves 213 MB (x, dt, B, C read once,
// y_diag and states written once in f32): 0.0636 ms at 3.35 TB/s.  It
// needs 8.14 GFLOP: C B^T once per (b, chunk, group) and the scores times
// x once per head, each over the causal half (j <= i), and x^T (B w) once
// per head.  So with bf16 inputs it is bound by bytes (8.2 us of work at
// the 989 TFLOP/s tensor-core peak), and with f32 inputs by operations,
// 0.1215 ms at 67 TFLOP/s (chip_smoke.ssd_bound_ms counts both).
// This first version computes in f32 on the CUDA cores (67 TFLOP/s peak;
// about 7.4 G FMA with the causal skip), so it is bound by its own
// arithmetic and shared-memory traffic; wgmma and TMA are later work.
// What the design does:
//   * One block of 512 threads per (h, c, b), heads fastest: the blocks
//     of one (b, chunk) share B and C, which then come from L2.  The
//     shared memory allows one block per SM, so the block is large: 16
//     warps hide the latency that 8 did not (on an H100 at the shape
//     above, with the vector loads below: 1.9 -> 1.0 ms).
//   * x, B and C are read 4 elements per thread per load (8 bytes of
//     bf16, 16 of f32), several loads in flight per thread.
//   * The TPU kernel held f32 copies of x, B, C and the whole q x q score
//     tile in VMEM (~0.4 MiB); that does not fit in 227 KB.  Here x, B
//     and C sit in shared memory as f32 (202 KB at the shape above), and
//     the scores exist only as 4-row strips, one per warp (2 KB each).
//   * Each warp owns 4 query rows at a time, lanes own key columns
//     lane + 32m: a k-step of 4 reads 4 broadcast float4s of C and one
//     float4 of B per column for 16 FMAs per column; B rows are padded
//     to n + 4 floats so 8 lanes' float4s fall in distinct banks.
//     Column groups wholly above the diagonal are skipped, and query rows
//     are dealt to warps round-robin so the causal work balances.
//   * The chunk-state product gives lanes the n axis (consecutive, no
//     conflicts) and a warp 4 rows of p, reading x as broadcast float4s.
//   * The cumsum is one warp's scan: q / 32 values per lane in order,
//     then a shuffle scan over the lanes' totals.
// Limits: q in {32, 64, 96, 128}, p and n multiples of 4 up to 128,
// h % g == 0, 4-element aligned x, B and C, and the shared memory a
// block can have (at q = n = 128, p up to 120); anything else is
// refused.  All offsets are 64-bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // rows of a warp's tile
constexpr int kMaxCols = 4;    // columns a lane owns: 32 * 4 = 128 at most
constexpr int kMaxSmem = 232448;
constexpr float kNeg = -1e30f;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  float* y;
  float* st;
  int nc, H, G, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// four consecutive elements as floats; p is 4-element aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) * static_cast<size_t>(Q) *
         (2 * (N + 4) + P + kWarps * kRows + 3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, P = a.P, N = a.N;
  const int ldb = N + 4;
  float* sB = smem;                       // (Q, N + 4)
  float* sC = sB + Q * ldb;               // (Q, N + 4)
  float* sX = sC + Q * ldb;               // (Q, P)
  float* sS = sX + Q * P;                 // kWarps strips of (kRows, Q)
  float* sCs = sS + kWarps * kRows * Q;   // cumsum of dt * A
  float* sDt = sCs + Q;
  float* sW = sDt + Q;                    // dt * exp(dA_cs[Q-1] - dA_cs)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = h / (a.H / a.G);
  const long long s0 = static_cast<long long>(c) * Q;

  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + s0 * a.x_ss;
  const T* bp = static_cast<const T*>(a.B) + b * a.b_sb + grp * a.b_sg + s0 * a.b_ss;
  const T* cp = static_cast<const T*>(a.C) + b * a.c_sb + grp * a.c_sg + s0 * a.c_ss;
  const float* dtp = a.dt + b * a.dt_sb + h * a.dt_sh + s0 * a.dt_ss;

  const int n4 = N / 4, p4 = P / 4;
#pragma unroll 4
  for (int idx = tid; idx < Q * n4; idx += kThreads) {
    const int j = idx / n4, k = (idx - j * n4) * 4;
    const float4 bv = load4(bp + j * a.b_ss + k), cv = load4(cp + j * a.c_ss + k);
    *reinterpret_cast<float4*>(sB + j * ldb + k) = bv;
    *reinterpret_cast<float4*>(sC + j * ldb + k) = cv;
  }
#pragma unroll 4
  for (int idx = tid; idx < Q * p4; idx += kThreads) {
    const int j = idx / p4, d = (idx - j * p4) * 4;
    *reinterpret_cast<float4*>(sX + j * P + d) = load4(xp + j * a.x_ss + d);
  }
  for (int j = tid; j < Q; j += kThreads) sDt[j] = dtp[j * a.dt_ss];
  __syncthreads();

  if (warp == 0) {
    const float A = a.A[h];
    const int per = Q / 32;
    float part[kMaxCols];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      if (u < per) {
        run += sDt[lane * per + u] * A;
        part[u] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float before = incl - run;
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      if (u < per) sCs[lane * per + u] = before + part[u];
    }
  }
  __syncthreads();
  const float cs_end = sCs[Q - 1];
  for (int j = tid; j < Q; j += kThreads) sW[j] = sDt[j] * expf(cs_end - sCs[j]);
  __syncthreads();

  // chunk state: st[pp][nn] = sum_j (x[j][pp] * w[j]) * B[j][nn]
  const int n_cols = (N + 31) / 32;
  float* stp = a.st + ((static_cast<long long>(b) * a.nc + c) * a.H + h) *
                          static_cast<long long>(P) * N;
  for (int p0 = warp * kRows; p0 < P; p0 += kWarps * kRows) {
    float acc[kRows][kMaxCols] = {};
    for (int j = 0; j < Q; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(sX + j * P + p0);
      const float wj = sW[j];
      const float xw[kRows] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        const int nn = lane + 32 * m;
        if (m < n_cols && nn < N) {
          const float bv = sB[j * ldb + nn];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][m] += xw[r] * bv;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      const int nn = lane + 32 * m;
      if (m < n_cols && nn < N) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) stp[(p0 + r) * static_cast<long long>(N) + nn] = acc[r][m];
      }
    }
  }

  // y_diag, 4 query rows per warp: a strip of scores, then its product with x
  const int q_cols = Q / 32;
  const int p_cols = (P + 31) / 32;
  float* strip = sS + warp * kRows * Q;
  for (int i0 = warp * kRows; i0 < Q; i0 += kWarps * kRows) {
    const int mc = min(q_cols, (i0 + kRows - 1) / 32 + 1);   // groups with j <= i
    float acc[kRows][kMaxCols] = {};
    for (int k = 0; k < N; k += 4) {
      float4 cv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        cv[r] = *reinterpret_cast<const float4*>(sC + (i0 + r) * ldb + k);
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (m < mc) {
          const float4 bv =
              *reinterpret_cast<const float4*>(sB + (lane + 32 * m) * ldb + k);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][m] += cv[r].x * bv.x + cv[r].y * bv.y + cv[r].z * bv.z + cv[r].w * bv.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      const float cs_i = sCs[i];
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        if (m < mc) {
          const int j = lane + 32 * m;
          const float seg = j <= i ? cs_i - sCs[j] : kNeg;   // mask before exp
          strip[r * Q + j] = acc[r][m] * expf(seg) * sDt[j];
        }
      }
    }
    __syncwarp();

    float yacc[kRows][kMaxCols] = {};
    const int j_end = i0 + kRows;                 // a multiple of 4
    for (int j = 0; j < j_end; j += 4) {
      float4 sv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        sv[r] = *reinterpret_cast<const float4*>(strip + r * Q + j);
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        const int d = lane + 32 * m;
        if (m < p_cols && d < P) {
          const float x0 = sX[j * P + d], x1 = sX[(j + 1) * P + d];
          const float x2 = sX[(j + 2) * P + d], x3 = sX[(j + 3) * P + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            yacc[r][m] += sv[r].x * x0 + sv[r].y * x1 + sv[r].z * x2 + sv[r].w * x3;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float* yp = a.y + ((static_cast<long long>(b) * a.nc * Q + s0 + i0 + r) * a.H + h) *
                            static_cast<long long>(P);
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        const int d = lane + 32 * m;
        if (m < p_cols && d < P) yp[d] = yacc[r][m];
      }
    }
    __syncwarp();   // the strip is rewritten by the next rows
  }
}

template <typename T>
bool aligned4(const void* p, long long s0, long long s1, long long s2) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  return addr % (4 * sizeof(T)) == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
}

template <typename T>
int launch_typed(const SsdArgs& a, int batch, cudaStream_t stream) {
  if (!aligned4<T>(a.x, a.x_sb, a.x_ss, a.x_sh) ||
      !aligned4<T>(a.B, a.b_sb, a.b_ss, a.b_sg) ||
      !aligned4<T>(a.C, a.c_sb, a.c_ss, a.c_sg))
    return kRefused;
  const size_t smem = smem_bytes(a.Q, a.P, a.N);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.nc, batch);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return launch_status();
}

}  // namespace

extern "C" int ssd_chunk_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, int dtype, float* y, float* st,
    int batch, int S, int H, int G, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return kRefused;
  if (Q < 32 || Q > 32 * kMaxCols || Q % 32 != 0 || S % Q != 0) return kRefused;
  if (P < 4 || P > 32 * kMaxCols || P % 4 != 0) return kRefused;
  if (N < 4 || N > 32 * kMaxCols || N % 4 != 0) return kRefused;
  if (smem_bytes(Q, P, N) > static_cast<size_t>(kMaxSmem)) return kRefused;
  const int nc = S / Q;
  if (batch > 65535 || nc > 65535) return kRefused;
  SsdArgs a{x, dt, A, B, C, y, st, nc, H, G, P, N, Q,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_typed<float>(a, batch, s);
  if (dtype == kBF16) return launch_typed<__nv_bfloat16>(a, batch, s);
  return kRefused;
}
