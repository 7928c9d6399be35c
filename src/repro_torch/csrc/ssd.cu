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
// elements aligned), so the caller's views of the conv output need no
// copy; head h reads group h / (h_total / g) of B and C, so the repeat
// over heads that the reference materializes (kernels/ops.py:76-77)
// never exists.  Outputs: y_diag (b, nc, q, h, p) f32 (the model's
// sequence-major order, so the caller adds y_off without a transpose)
// and states (b, nc, h, p, n) f32, both contiguous.  s must be a
// multiple of q: the caller pads.
//
// Bound on this card.  At the mamba2-2.7b prefill (b 4, s 1024, h 80,
// p 64, g 1, n 128, q 128) one call moves 213 MB (x, dt, B, C read once,
// y_diag and states written once in f32, 168 MB of it): 0.0636 ms at
// 3.35 TB/s.  It needs 8.14 GFLOP: C B^T once per (b, chunk, group) and
// the scores times x once per head, each over the causal half (j <= i),
// and x^T (B w) once per head.  So with bf16 inputs it is bound by bytes
// (8.2 us of work at the 989 TFLOP/s tensor-core peak), above all by its
// f32 stores, and with f32 inputs by operations, 0.1215 ms at 67 TFLOP/s
// (chip_smoke.ssd_bound_ms counts both).
//
// bf16 inputs: ssd_chunk_mma_kernel, on the tensor cores.
//   * Every product is an mma.sync m16n8k16 bf16 with f32 accumulators
//     (the helpers of mma.cuh, shared with flash attention).
//   * C B^T once per block.  A block of 16 warps owns one (b, chunk) and
//     a run of heads of one group.  It copies B and C once (cp.async, as
//     bf16); its 8 row warps compute the causal half of C B^T once, each
//     the 16 query rows of one row tile up to the diagonal, and keep the
//     tiles in shared memory in the accumulator layout (one float4 per
//     lane and 16 x 8 tile, 36 KB at q = 128) for all the block's heads.
//     Row warp w owns row tile w (w < 4) or 11 - w, so the two row warps
//     of one scheduler (w, w + 4) own tiles r and 7 - r: every scheduler
//     has the same causal work.
//   * Then the heads, one after another, two roles side by side.  A row
//     warp turns its C B^T tiles into S = C B^T * exp(seg) * dt_j in
//     registers and feeds them as mma A-fragments (the m16n8 accumulator
//     layout of two neighbouring column tiles is the m16k16 A-layout, as
//     P is in flash) against x tiles read by ldmatrix.trans, for the key
//     tiles up to its diagonal only.  A state warp owns 16 rows of p and
//     a run of 16-column pairs of n of the chunk state (x * w)^T B, x * w
//     from ldmatrix.trans of x and B from ldmatrix.trans of the B tile
//     that C B^T used.  Accumulators per pass: 64 columns of p (y_diag)
//     or of n (states), so no warp needs more than 128 registers.  The
//     cumsums (one warp's shuffle scan per head), dt and w = dt *
//     exp(dA_cs[q-1] - dA_cs) of all the block's heads are made once,
//     before the heads.
//   * The f32 operands are split.  S and x * w are f32; one rounding to
//     bf16 costs about 2^-9 of each term, 25x over the 1e-4 the kernel is
//     held to.  So each goes in as hi = bf16(v) and lo = bf16(v - hi)
//     (pack_bf16_split), two mma into one accumulator, and the products
//     with the exact bf16 operand (x or B) keep about 2^-17.  C B^T
//     needs no split: C and B are exact in bf16.
//   * Loads overlap compute.  The x tile of the next head is copied with
//     cp.async into a second buffer while the current head computes: one
//     __syncthreads per head.  Staged rows are padded by 16 bytes (an
//     odd number of 16-byte chunks), so the 8 rows of an ldmatrix hit 8
//     bank groups.  Copies are 16 bytes where base, strides and width
//     allow it and 8 bytes otherwise (p = 100 rows lie 200 bytes apart);
//     columns past p or n are zero-filled (src-size 0), so C B^T sums
//     zeros and the padding only reaches outputs that are not written.
//   * Stores straight from the accumulators: a quad's four 8-byte stores
//     fill one 32-byte sector, and one warp store writes 8 whole sectors
//     of y_diag rows (256 contiguous bytes at p = 64) or of the states.
//   * Heads per block against wave quantisation: the launcher picks the
//     split of a group's heads over blocks whose waves (one block per SM)
//     take the least time, counting a block's C B^T and first copies as
//     one head more; at the shape above 4 blocks of 20 heads per
//     (b, chunk), 128 blocks in one wave on 132 SMs.  A caller may name
//     the heads per block (measurements); at most 32, and as many as the
//     shared memory holds.
//   What the card showed (H100 80GB HBM3, 700 W; tools/flash_report.py): 8 warps
//   holding C B^T in registers (223 of them, one block per SM) ran 0.139
//   ms; 16 warps with C B^T in shared memory 0.122-0.126.  Deeper x prefetch
//   (3-4 buffers), heads interleaved over the blocks of a (b, chunk),
//   whole-line stores and streaming stores gained nothing or lost.  With
//   no mma the stores and x loads alone take 0.097 ms, with no stores the
//   mma work alone 0.109-0.113: neither alone is the limit.
//
// f32 inputs: ssd_chunk_kernel<float>, the first version, f32 FMAs on
// the CUDA cores.  One block of 512 threads per (h, c, b); x, B and C in
// shared memory as f32 (202 KB at the shape above, one block per SM); 4
// query rows per warp at a time with the scores in 2 KB strips, column
// groups above the diagonal skipped; B rows padded to n + 4 floats.
//
// Limits: q in {32, 64, 96, 128}, p and n multiples of 4 up to 128,
// h % g == 0, 4-element aligned x, B and C, and (f32) the shared memory a
// block can have (at q = n = 128, p up to 120); anything else is
// refused.  All offsets are 64-bit.

#include <algorithm>
#include <climits>

#include "mma.cuh"

namespace {

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
  int parts;           // bf16: blocks per (b, chunk, group)
  int vec_x, vec_bc;   // bf16: values per cp.async of x, of B and C (4 or 8)
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // rows of a warp's tile
constexpr int kMaxCols = 4;    // columns a lane owns: 32 * 4 = 128 at most

// four consecutive floats; p is 4-element aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

int launch_f32(const SsdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Q, a.P, a.N);
  if (smem > static_cast<size_t>(kMaxSmem)) return kRefused;
  if (batch > 65535 || a.nc > 65535) return kRefused;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.nc, batch);
  ssd_chunk_kernel<float><<<grid, kThreads, smem, stream>>>(a);
  return launch_status();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;            // y_diag: 16 query rows each
constexpr int kStateWarps = 8;          // the chunk states
constexpr int kMmaWarps = kRowWarps + kStateWarps;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxHeads = 32;           // heads of one block, at most
constexpr int kPassTiles = 4;           // 16-column tiles of p (y) or n (states) per pass

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// Shared memory of a block: B and C (q rows of round16(n) + 8 bf16), the
// causal tiles of C B^T (f32, 16 x 8 each, in the accumulator layout),
// dt, the cumsum and w (f32, q per head), then two x buffers (q rows of
// round16(p) + 8 bf16).
size_t mma_smem_bytes(int Q, int P, int N, int heads) {
  const size_t q = Q, qt = Q / 16;
  return 4 * q * (round16(N) + 8) + qt * (qt + 1) * 512 + 12 * heads * q +
         4 * q * (round16(P) + 8);
}

// `rows` rows of `cols` bf16 values from `src` (row stride `ld`) into
// shared rows of `ld_s` values, `vec` (4 or 8) values per cp.async;
// copies past `cols`, up to `cols_pad`, are zero-filled.
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src,
                                          long long ld, int rows, int cols, int cols_pad,
                                          int ld_s, int vec) {
  const int per_row = cols_pad / vec;
  for (int i = threadIdx.x; i < rows * per_row; i += kMmaThreads) {
    const int r = i / per_row, col = (i - r * per_row) * vec;
    const bool ok = col < cols;
    const __nv_bfloat16* g = ok ? src + r * ld + col : src;
    const uint32_t d = dst + (r * ld_s + col) * 2;
    if (vec == 8) cp_async_16(d, g, ok);
    else cp_async_8(d, g, ok);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_chunk_mma_kernel(const SsdArgs a) {
  static_assert(kRowWarps == 8 && kMmaWarps % 4 == 0,
                "row tiles r and 7 - r share a scheduler");
  extern __shared__ __align__(128) unsigned char mma_smem[];

  const int Q = a.Q, P = a.P, N = a.N;
  const int NN = round16(N), PP = round16(P);
  const int ldb = NN + 8, ldx = PP + 8;
  const int QT = Q / 16;
  // block -> (b, c, g, part); heads [h0, h0 + nh) of group g
  int blk = blockIdx.x;
  const int part = blk % a.parts;
  blk /= a.parts;
  const int g = blk % a.G;
  blk /= a.G;
  const int c = blk % a.nc, b = blk / a.nc;
  const int rep = a.H / a.G;
  const int h0 = g * rep + part * rep / a.parts;
  const int nh = g * rep + (part + 1) * rep / a.parts - h0;
  const int heads_max = (rep + a.parts - 1) / a.parts;

  const uint32_t s_b = smem_u32(mma_smem);
  const uint32_t s_c = s_b + Q * ldb * 2;
  float4* sCB = reinterpret_cast<float4*>(mma_smem + 4 * Q * ldb);   // QT (QT + 1) tiles
  float* sDt = reinterpret_cast<float*>(sCB + QT * (QT + 1) * 32);
  float* sCs = sDt + heads_max * Q;
  float* sW = sCs + heads_max * Q;
  const uint32_t s_x = smem_u32(sW + heads_max * Q);   // two buffers of Q * ldx
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t2 = 2 * (lane & 3);
  const long long s0 = static_cast<long long>(c) * Q;

  const auto* xp = static_cast<const __nv_bfloat16*>(a.x) + b * a.x_sb + s0 * a.x_ss;
  const auto* bp = static_cast<const __nv_bfloat16*>(a.B) + b * a.b_sb + g * a.b_sg +
                   s0 * a.b_ss;
  const auto* cp = static_cast<const __nv_bfloat16*>(a.C) + b * a.c_sb + g * a.c_sg +
                   s0 * a.c_ss;
  load_rows(s_b, bp, a.b_ss, Q, N, NN, ldb, a.vec_bc);
  load_rows(s_c, cp, a.c_ss, Q, N, NN, ldb, a.vec_bc);
  load_rows(s_x, xp + h0 * a.x_sh, a.x_ss, Q, P, PP, ldx, a.vec_x);
  cp_async_commit();

  // dt of the block's heads; then per head one warp's scan: the cumsum
  // (q / 32 values per lane in order, a shuffle scan over the lanes'
  // totals) and w = dt * exp(dA_cs[q-1] - dA_cs)
  const float* dtp = a.dt + b * a.dt_sb + s0 * a.dt_ss + h0 * a.dt_sh;
  for (int i = tid; i < nh * Q; i += kMmaThreads) {
    const int j = i / nh, hh = i - j * nh;
    sDt[hh * Q + j] = dtp[j * a.dt_ss + hh * a.dt_sh];
  }
  __syncthreads();
  for (int hh = warp; hh < nh; hh += kMmaWarps) {
    const float A = a.A[h0 + hh];
    const float* dt = sDt + hh * Q;
    const int per = Q / 32;
    float part_sum[4];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < per) {
        run += dt[lane * per + u] * A;
        part_sum[u] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float before = incl - run;
    const float cs_end = __shfl_sync(0xffffffffu, before + run, 31);   // dA_cs[q-1]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < per) {
        const int j = lane * per + u;
        const float cs = before + part_sum[u];
        sCs[hh * Q + j] = cs;
        sW[hh * Q + j] = dt[j] * expf(cs_end - cs);
      }
    }
  }
  cp_async_wait_all();                  // B, C and the first head's x
  __syncthreads();

  // Row warps own the 16 query rows of row tile rt; state warps rows
  // 16 mt .. 16 mt + 15 of p and the column pairs (of 16) [np0, np1) of n.
  const bool row_warp = warp < kRowWarps;
  const int rt = !row_warp ? 0 : warp < 4 ? warp : 11 - warp;
  const bool has_rows = row_warp && rt < QT;
  const int MT = PP / 16;
  const int sw = warp - kRowWarps;
  const int st_warps = max(1, kStateWarps / MT);
  const int n_pairs = NN / 16;
  const int per_warp = (n_pairs + st_warps - 1) / st_warps;
  const int mt = sw / st_warps;
  const int np0 = (sw % st_warps) * per_warp;
  const int np1 = min(n_pairs, np0 + per_warp);
  const bool has_state = !row_warp && mt < MT && np0 < np1;
  // this warp's C B^T tiles (rt, nt) in sCB, one float4 per lane
  float4* cb_tiles = sCB + rt * (rt + 1) * 32 + lane;

  if (has_rows) {
    // C B^T for the 16 query rows, column tiles up to the diagonal, once
    const int nt_end = 2 * (rt + 1);
    float cb[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) cb[nt][0] = cb[nt][1] = cb[nt][2] = cb[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (16 * kk < NN) {
        uint32_t cf[4];
        ldmatrix_x4(s_c + ((16 * rt + (lane & 15)) * ldb + 16 * kk + (lane >> 4) * 8) * 2, cf);
#pragma unroll
        for (int nt = 0; nt < 16; nt += 2) {
          if (nt < nt_end) {
            uint32_t bf[4];   // b-fragments of key tiles nt and nt + 1
            ldmatrix_x4(s_b + ((8 * nt + (lane & 7) + ((lane >> 4) << 3)) * ldb + 16 * kk +
                               ((lane >> 3) & 1) * 8) * 2, bf);
            mma_bf16(cb[nt], cf, bf[0], bf[1]);
            mma_bf16(cb[nt + 1], cf, bf[2], bf[3]);
          }
        }
      }
    }
    // kept in this thread's own slots: it alone reads them back
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      if (nt < nt_end) cb_tiles[nt * 32] = make_float4(cb[nt][0], cb[nt][1], cb[nt][2], cb[nt][3]);
  }

  const int i0 = 16 * rt + (lane >> 2);           // a row warp's rows i0, i0 + 8
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    if (hh > 0) {
      cp_async_wait_all();              // this head's x has landed
      __syncthreads();                  // and every warp is done with the last head
    }
    if (hh + 1 < nh)                    // the next head's x, into the last head's buffer
      load_rows(s_x + ((hh + 1) & 1) * Q * ldx * 2, xp + (h + 1) * a.x_sh, a.x_ss, Q, P, PP,
                ldx, a.vec_x);
    cp_async_commit();
    const uint32_t xb = s_x + (hh & 1) * Q * ldx * 2;

    // y_diag rows: S = C B^T * exp(seg) * dt_j, split, times x; 64
    // columns of p per pass
    for (int pd = 0; has_rows && pd < MT; pd += kPassTiles) {
      const float* cs = sCs + hh * Q;
      const float* dt = sDt + hh * Q;
      const float cs_i[2] = {cs[i0], cs[i0 + 8]};
      float y[2 * kPassTiles][4];
#pragma unroll
      for (int nt = 0; nt < 2 * kPassTiles; ++nt) y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk <= rt) {
          // keys 16 kk .. 16 kk + 15: the accumulators of column tiles
          // 2 kk and 2 kk + 1 are the A-fragment
          uint32_t sh[4], sl[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 cbv = cb_tiles[(2 * kk + half) * 32];
            const float cbe[4] = {cbv.x, cbv.y, cbv.z, cbv.w};
            const int j = 16 * kk + 8 * half + t2;
            const float2 csj = *reinterpret_cast<const float2*>(cs + j);
            const float2 dtj = *reinterpret_cast<const float2*>(dt + j);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = i0 + 8 * r;
              const float e0 = j <= i ? cs_i[r] - csj.x : kNeg;      // mask before exp
              const float e1 = j + 1 <= i ? cs_i[r] - csj.y : kNeg;
              pack_bf16_split(cbe[2 * r] * expf(e0) * dtj.x, cbe[2 * r + 1] * expf(e1) * dtj.y,
                              sh[2 * half + r], sl[2 * half + r]);
            }
          }
#pragma unroll
          for (int dp = 0; dp < kPassTiles; ++dp) {
            if (pd + dp < MT) {
              uint32_t xf[4];   // b-fragments of column tiles 2 dp and 2 dp + 1
              ldmatrix_x4_trans(xb + ((16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldx +
                                      16 * (pd + dp) + (lane >> 4) * 8) * 2, xf);
              mma_bf16(y[2 * dp], sh, xf[0], xf[1]);
              mma_bf16(y[2 * dp], sl, xf[0], xf[1]);
              mma_bf16(y[2 * dp + 1], sh, xf[2], xf[3]);
              mma_bf16(y[2 * dp + 1], sl, xf[2], xf[3]);
            }
          }
        }
      }
      // a quad's four 8-byte stores fill one 32-byte sector
      float* y0 = a.y + ((static_cast<long long>(b) * a.nc * Q + s0 + i0) * a.H + h) *
                            static_cast<long long>(P);
      float* y1 = y0 + 8LL * a.H * P;
#pragma unroll
      for (int nt = 0; nt < 2 * kPassTiles; ++nt) {
        const int d = 16 * pd + 8 * nt + t2;
        if (d < P) {
          *reinterpret_cast<float2*>(y0 + d) = make_float2(y[nt][0], y[nt][1]);
          *reinterpret_cast<float2*>(y1 + d) = make_float2(y[nt][2], y[nt][3]);
        }
      }
    }

    // states[d][n] = sum_j (x[j][d] w[j]) B[j][n], x * w split; column
    // pairs [p0, p0 + kPassTiles) of [np0, np1) per pass
    for (int p0 = np0; has_state && p0 < np1; p0 += kPassTiles) {
      const float* w = sW + hh * Q;
      float st[2 * kPassTiles][4];
#pragma unroll
      for (int e = 0; e < 2 * kPassTiles; ++e) st[e][0] = st[e][1] = st[e][2] = st[e][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < QT) {
          uint32_t xf[4];   // A-fragment of x^T: rows d, keys j
          ldmatrix_x4_trans(xb + ((16 * kk + (lane & 7) + ((lane >> 4) << 3)) * ldx +
                                  16 * mt + ((lane >> 3) & 1) * 8) * 2, xf);
          // keys of xf[0], xf[1]: 16 kk + t2 (+1); of xf[2], xf[3]: 8 more
          const float2 w0 = *reinterpret_cast<const float2*>(w + 16 * kk + t2);
          const float2 w1 = *reinterpret_cast<const float2*>(w + 16 * kk + 8 + t2);
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = unpack_bf16(xf[e]);
            const float2 we = e < 2 ? w0 : w1;
            pack_bf16_split(v.x * we.x, v.y * we.y, ah[e], al[e]);
          }
#pragma unroll
          for (int pr = 0; pr < kPassTiles; ++pr) {
            if (p0 + pr < np1) {
              uint32_t bf[4];   // b-fragments of state column tiles 2 (p0 + pr) (+1)
              ldmatrix_x4_trans(s_b + ((16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                                       16 * (p0 + pr) + (lane >> 4) * 8) * 2, bf);
              mma_bf16(st[2 * pr], ah, bf[0], bf[1]);
              mma_bf16(st[2 * pr], al, bf[0], bf[1]);
              mma_bf16(st[2 * pr + 1], ah, bf[2], bf[3]);
              mma_bf16(st[2 * pr + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
      float* sp = a.st + ((static_cast<long long>(b) * a.nc + c) * a.H + h) *
                             static_cast<long long>(P) * N;
      const int d0 = 16 * mt + (lane >> 2);
#pragma unroll
      for (int e = 0; e < 2 * kPassTiles; ++e) {
        const int n = 16 * p0 + 8 * e + t2;
        if (p0 + e / 2 < np1 && n < N) {
          if (d0 < P)
            *reinterpret_cast<float2*>(sp + static_cast<long long>(d0) * N + n) =
                make_float2(st[e][0], st[e][1]);
          if (d0 + 8 < P)
            *reinterpret_cast<float2*>(sp + static_cast<long long>(d0 + 8) * N + n) =
                make_float2(st[e][2], st[e][3]);
        }
      }
    }
  }
}

int launch_mma(const SsdArgs& a, int batch, size_t smem, cudaStream_t stream) {
  // above 48 KB the dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = static_cast<long long>(batch) * a.nc * a.G * a.parts;
  if (blocks > 0x7fffffffLL) return kRefused;
  ssd_chunk_mma_kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(a);
  return launch_status();
}

// Blocks per (b, chunk, group) whose waves take the least time: a
// block's time counts its heads plus one for C B^T and its first copies;
// one block per SM (its 512 threads hold all the registers); runs of at
// most `max_heads` heads.
int pick_parts(int units, int rep, int max_heads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best = rep;
  long long best_cost = LLONG_MAX;
  for (int parts = (rep + max_heads - 1) / max_heads; parts <= rep; ++parts) {
    const long long waves = (static_cast<long long>(units) * parts + sms - 1) / sms;
    const long long cost = waves * ((rep + parts - 1) / parts + 1);
    if (cost < best_cost) {
      best_cost = cost;
      best = parts;
    }
  }
  return best;
}

// cp.async of `vec` values needs the base and every stride that is used
// (an axis of extent 1 is never stepped) aligned to it, and whole copies
// per row
bool step_ok(long long stride, int extent, int vec) {
  return extent == 1 || stride % vec == 0;
}
int copy_vec(const void* p, long long sb, int nb, long long ss, long long sh, int nh, int cols) {
  const bool v8 = reinterpret_cast<uintptr_t>(p) % 16 == 0 && step_ok(sb, nb, 8) &&
                  step_ok(ss, 2, 8) && step_ok(sh, nh, 8) && cols % 8 == 0;
  return v8 ? 8 : 4;
}

int launch_bf16(SsdArgs a, int batch, int heads_per_block, cudaStream_t stream) {
  const int rep = a.H / a.G;
  // the heads whose dt, cumsum and w fit beside the tiles
  const long long room = kMaxSmem - static_cast<long long>(mma_smem_bytes(a.Q, a.P, a.N, 0));
  const int max_heads = static_cast<int>(std::min<long long>(kMaxHeads, room / (12LL * a.Q)));
  if (max_heads < 1 || heads_per_block < 0 || heads_per_block > max_heads) return kRefused;
  a.parts = heads_per_block > 0 ? (rep + heads_per_block - 1) / heads_per_block
                                : pick_parts(batch * a.nc * a.G, rep, max_heads);
  a.vec_x = copy_vec(a.x, a.x_sb, batch, a.x_ss, a.x_sh, a.H, a.P);
  a.vec_bc = std::min(copy_vec(a.B, a.b_sb, batch, a.b_ss, a.b_sg, a.G, a.N),
                      copy_vec(a.C, a.c_sb, batch, a.c_ss, a.c_sg, a.G, a.N));
  return launch_mma(a, batch, mma_smem_bytes(a.Q, a.P, a.N, (rep + a.parts - 1) / a.parts),
                    stream);
}

bool aligned4(const void* p, size_t elem, long long s0, long long s1, long long s2) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  return addr % (4 * elem) == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
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
    int heads_per_block, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return kRefused;
  if (Q < 32 || Q > 32 * kMaxCols || Q % 32 != 0 || S % Q != 0) return kRefused;
  if (P < 4 || P > 32 * kMaxCols || P % 4 != 0) return kRefused;
  if (N < 4 || N > 32 * kMaxCols || N % 4 != 0) return kRefused;
  if (dtype != kF32 && dtype != kBF16) return kRefused;
  const size_t elem = dtype == kF32 ? 4 : 2;
  if (!aligned4(x, elem, x_sb, x_ss, x_sh) || !aligned4(B, elem, b_sb, b_ss, b_sg) ||
      !aligned4(C, elem, c_sb, c_ss, c_sg))
    return kRefused;
  SsdArgs a{x, dt, A, B, C, y, st, S / Q, H, G, P, N, Q,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, 1, 4, 4};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_bf16(a, batch, heads_per_block, s);
  if (heads_per_block != 0) return kRefused;   // one block per head
  return launch_f32(a, batch, s);
}
