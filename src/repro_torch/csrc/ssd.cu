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
// Bound on this card: bytes.  At the mamba2-2.7b prefill (b 4, s 1024,
// h 80, p 64, g 1, n 128, q 128) one call moves 213 MB with bf16 inputs
// and 257 MB with f32 ones (x, dt, B, C read once, y_diag and states
// written once in f32, 168 MB of it): 0.0636 and 0.0768 ms at 3.35 TB/s.
// It needs 8.14 GFLOP: C B^T once per (b, chunk, group) and the scores
// times x once per head, each over the causal half (j <= i), and
// x^T (B w) once per head: 8.2 us at the 989 TFLOP/s bf16 peak, and
// 0.0493 ms for f32 inputs at 495 / 3 TFLOP/s (three TF32 products an f32
// product; on the CUDA cores, at 67 TFLOP/s, it was 0.1215 ms).  So both
// are bound by bytes, above all by the f32 stores (chip_smoke.ssd_bound_ms
// counts both).
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
// f32 inputs: ssd_chunk_tf32x3_kernel, on the tensor cores at f32
// accuracy.  The grid, the warp roles, C B^T once per block, the scans
// and the x prefetch are the bf16 kernel's; what differs:
//   * Every product is three TF32 mma.sync m16n8k8 (mma_tf32x3 of
//     mma.cuh: lo * hi + hi * lo + hi * hi from hi + lo splits made in
//     registers, about 2^-21 of each term).  C and B are f32 too, so C B^T
//     is split as well.  One TF32 product alone errs about 4e-4 of the
//     largest output, above the 1e-4 the kernel is held to; three keep
//     about 4e-7 (tests/test_torch_ssm.py emulates both).
//   * No ldmatrix (it moves 16-bit values).  Fragments come from 8-byte
//     and 4-byte shared loads, with the k axis of every product permuted
//     as flash's f32 kernel permutes it: k-slot t stands for element 2t of
//     the 8-wide step and slot t + 4 for 2t + 1.  Then C B^T's
//     accumulators (c0, c1 at columns 2t, 2t + 1) are S's A-fragment as
//     they stand, the B-fragments of x (y_diag) and of B (states) are rows
//     2t and 2t + 1 of the step, and one 8-byte load a row feeds two
//     neighbouring 8-column tiles (column g of the first is element 2g of
//     a 16-wide pair, of the second 2g + 1).  A thread then owns four
//     neighbouring outputs of a row, stored as one float4.
//   * Staged rows of x hold round8(p) + 4 floats and of B round16(n) + 4,
//     both 4 mod 8: the 8-byte loads at (row 2t, column 2g) and the 4-byte
//     loads of x^T at (row 2t, column g) hit distinct banks.  C is read
//     once per block, so the row warps take their C fragments straight
//     from global memory and C needs no shared memory.  At the shape above
//     a block holds 204,800 bytes (B 67,584, C B^T 36,864, dt, cumsum and
//     w of 20 heads 30,720, two x buffers 69,632).  Where two x buffers do
//     not fit beside one head's scans (q = n = 128, p 116-128) the block
//     keeps one and loads each head's x after the last head is done.
//   * Columns of x past p are never zero-filled: a garbage column of a
//     B-fragment reaches only its own output column, a garbage row of an
//     A-fragment only its own output row, and neither is stored.  B's
//     columns past n are zero-filled (they are C B^T's k axis).
//   * exp(seg) as ex2.approx of a cumsum kept times log2(e).
//   * Every pass runs 4 tiles of 16 columns with no guard (a tile past p
//     or past a warp's tiles of n is computed and not stored); guards on
//     the tiles cost 7-12%.
//   What the card showed (H100 80GB HBM3, 700 W; tools/flash_report.py
//   --baseline --variants f32): 0.1985 ms at the shape above (the
//   CUDA-core kernel before it 0.976-0.983), 39% of its bound;
//   hymba-1.5b's (4 x 2048, 32 heads, p 100, n 16) 0.2124-0.2128
//   (0.560).  Fed unsplit, B or x (no split instructions) saves under
//   1.5%, so operands split once into hi and lo planes, which cost the x
//   double buffer or half the heads a block (+21%, +11%), cannot pay.  One
//   TF32 product in place of three saves 27%, dropping y_diag or the
//   states 27-30%: the two roles share each scheduler's tensor pipe, and
//   neither alone is the limit.  expf in place
//   of ex2.approx +3%; the small terms in an accumulator of their own
//   +12%.
//
// Limits: q in {32, 64, 96, 128}, p and n multiples of 4 up to 128,
// h % g == 0, 4-element aligned x, B and C, and the shared memory a
// block can have; anything else is refused.  All offsets are 64-bit.

#include <algorithm>
#include <climits>

#include "mma.cuh"

namespace {

constexpr int kMaxSmem = 232448;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxQ = 128;              // chunk, head dim and state, at most

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
  int parts;           // blocks per (b, chunk, group)
  int vec_x, vec_bc;   // bf16: values per cp.async of x, of B and C (4 or 8)
  int xbufs;           // f32: x buffers (2: the next head's x loads during this one)
};

constexpr int kRowWarps = 8;            // y_diag: 16 query rows each
constexpr int kStateWarps = 8;          // the chunk states
constexpr int kMmaWarps = kRowWarps + kStateWarps;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxHeads = 32;           // heads of one block, at most
constexpr int kPassTiles = 4;           // 16-column tiles of p (y) or n (states) per pass

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }

// dt of the block's heads [h0, h0 + nh); then per head one warp's scan:
// the cumsum of dt * A (q / 32 values per lane in order, a shuffle scan
// over the lanes' totals), kept times `cs_scale`, and w = dt *
// exp(dA_cs[q-1] - dA_cs)
__device__ __forceinline__ void head_scans(const SsdArgs& a, int b, long long s0, int h0, int nh,
                                           float* sDt, float* sCs, float* sW, float cs_scale) {
  const int Q = a.Q, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
        sCs[hh * Q + j] = cs * cs_scale;
        sW[hh * Q + j] = dt[j] * expf(cs_end - cs);
      }
    }
  }
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

// The block's (b, chunk, group) and its run of heads [h0, h0 + nh) of the
// group; heads_max is the longest run of the launch.
struct BlockHeads {
  int b, c, g, h0, nh, heads_max;
};
__device__ __forceinline__ BlockHeads block_heads(const SsdArgs& a) {
  int blk = blockIdx.x;
  const int part = blk % a.parts;
  blk /= a.parts;
  const int g = blk % a.G;
  blk /= a.G;
  const int c = blk % a.nc, b = blk / a.nc;
  const int rep = a.H / a.G;
  const int h0 = g * rep + part * rep / a.parts;
  const int nh = g * rep + (part + 1) * rep / a.parts - h0;
  return {b, c, g, h0, nh, (rep + a.parts - 1) / a.parts};
}

int launch_blocks(const void* kernel, const SsdArgs& a, int batch, size_t smem,
                  cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * a.nc * a.G * a.parts;
  if (blocks > 0x7fffffffLL) return kRefused;
  void* args[] = {const_cast<SsdArgs*>(&a)};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                           dim3(kMmaThreads), args, smem, stream);
  return err != cudaSuccess ? static_cast<int>(err) : launch_status();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

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
  const BlockHeads blk = block_heads(a);
  const int b = blk.b, c = blk.c, g = blk.g, h0 = blk.h0, nh = blk.nh;
  const int heads_max = blk.heads_max;

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

  head_scans(a, b, s0, h0, nh, sDt, sCs, sW, 1.f);
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
  // above 48 KB the dynamic shared memory has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_blocks(reinterpret_cast<const void*>(ssd_chunk_mma_kernel), a, batch,
                       mma_smem_bytes(a.Q, a.P, a.N, (rep + a.parts - 1) / a.parts), stream);
}

// ---------------------------------------------------------------------------
// f32: tensor cores at f32 accuracy (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

// Staged rows, in floats: x round8(p) + 4, B round16(n) + 4 (4 mod 8).
__host__ __device__ constexpr int tf_ldx(int P) { return round8(P) + 4; }
__host__ __device__ constexpr int tf_ldb(int N) { return round16(N) + 4; }

// Shared memory of a block: `xbufs` x buffers (first: a fragment read
// past a buffer's last row lands in the next region), B, the causal
// tiles of C B^T (16 x 8 each, in the accumulator layout), then dt, the
// cumsum and w of `heads` heads.
size_t tf_smem_bytes(int Q, int P, int N, int heads, int xbufs) {
  const size_t q = Q, qt = Q / 16;
  return 4 * (xbufs * q * tf_ldx(P) + q * tf_ldb(N) + qt * (qt + 1) * 128 + 3 * heads * q);
}

// `rows` rows of `cols` floats from `src` (row stride `ld`) into shared
// rows of `ld_s` floats, 16 bytes a cp.async (f32 views are 4-element
// aligned); copies past `cols`, up to `cols_pad`, are zero-filled.
__device__ __forceinline__ void load_f32_rows(uint32_t dst, const float* src, long long ld,
                                              int rows, int cols, int cols_pad, int ld_s) {
  const int per_row = cols_pad / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kMmaThreads) {
    const int r = i / per_row, col = (i - r * per_row) * 4;
    const bool ok = col < cols;
    cp_async_16(dst + (r * ld_s + col) * 4, ok ? src + r * ld + col : src, ok);
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_chunk_tf32x3_kernel(const SsdArgs a) {
  static_assert(kRowWarps == 8 && kMmaWarps % 4 == 0,
                "row tiles r and 7 - r share a scheduler");
  extern __shared__ __align__(128) float tf_smem[];

  const int Q = a.Q, P = a.P, N = a.N;
  const int ldx = tf_ldx(P), ldb = tf_ldb(N);
  const int QT = Q / 16;
  const int PT = (P + 15) / 16;         // 16-wide tiles of p
  const int NT = round16(N) / 16;       // 16-wide tiles of n
  const BlockHeads blk = block_heads(a);
  const int b = blk.b, c = blk.c, g = blk.g, h0 = blk.h0, nh = blk.nh;
  const int heads_max = blk.heads_max;

  float* sX = tf_smem;                                      // a.xbufs buffers of Q * ldx
  float* sB = sX + a.xbufs * Q * ldx;                       // Q * ldb
  float4* sCB = reinterpret_cast<float4*>(sB + Q * ldb);    // QT (QT + 1) tiles
  float* sDt = reinterpret_cast<float*>(sCB + QT * (QT + 1) * 32);
  float* sCs = sDt + heads_max * Q;                         // times log2(e)
  float* sW = sCs + heads_max * Q;
  const uint32_t s_x = smem_u32(sX), s_b = smem_u32(sB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;     // fragment row (group) and column pair
  const long long s0 = static_cast<long long>(c) * Q;

  const float* xp = static_cast<const float*>(a.x) + b * a.x_sb + s0 * a.x_ss;
  const float* bp = static_cast<const float*>(a.B) + b * a.b_sb + g * a.b_sg + s0 * a.b_ss;
  const float* cp = static_cast<const float*>(a.C) + b * a.c_sb + g * a.c_sg + s0 * a.c_ss;
  load_f32_rows(s_b, bp, a.b_ss, Q, N, round16(N), ldb);
  load_f32_rows(s_x, xp + h0 * a.x_sh, a.x_ss, Q, P, P, ldx);
  cp_async_commit();
  head_scans(a, b, s0, h0, nh, sDt, sCs, sW, kLog2e);
  cp_async_wait_all();                  // B and the first head's x
  __syncthreads();

  // Row warps own the 16 query rows of row tile rt; state warps rows
  // 16 mt .. 16 mt + 15 of p and the 16-column tiles [np0, np1) of n.
  const bool row_warp = warp < kRowWarps;
  const int rt = !row_warp ? 0 : warp < 4 ? warp : 11 - warp;
  const bool has_rows = row_warp && rt < QT;
  const int sw = warp - kRowWarps;
  const int st_warps = max(1, kStateWarps / PT);
  const int per_warp = (NT + st_warps - 1) / st_warps;
  const int mt = sw / st_warps;
  const int np0 = (sw % st_warps) * per_warp;
  const int np1 = min(NT, np0 + per_warp);
  const bool has_state = !row_warp && mt < PT && np0 < np1;
  // this warp's C B^T tiles (rt, kb) in sCB, one float4 per lane
  float4* cb_tiles = sCB + rt * (rt + 1) * 32 + lane;
  const int i0 = 16 * rt + gr;          // a row warp's rows i0, i0 + 8

  if (has_rows) {
    // C B^T for the 16 query rows, key tiles (8 wide) up to the diagonal,
    // once.  k (n) permuted: slot t is dim 2t, slot t + 4 dim 2t + 1 of
    // the step, so C's A-fragment is one 8-byte load a row from global
    // memory (zero past n) and B's B-fragment one from row 8 kb + gr.
    const int kb_end = 2 * (rt + 1);
    float cb[16][4];
#pragma unroll
    for (int kb = 0; kb < 16; ++kb) cb[kb][0] = cb[kb][1] = cb[kb][2] = cb[kb][3] = 0.f;
    const float* c0 = cp + i0 * a.c_ss;
    const float* c1 = c0 + 8 * a.c_ss;
#pragma unroll 2
    for (int k = 2 * t; k < round8(N); k += 8) {
      const float2 ca = k < N ? *reinterpret_cast<const float2*>(c0 + k) : make_float2(0.f, 0.f);
      const float2 cc = k < N ? *reinterpret_cast<const float2*>(c1 + k) : make_float2(0.f, 0.f);
      uint32_t ch[4], cl[4];
      split_tf32(ca.x, ch[0], cl[0]);
      split_tf32(cc.x, ch[1], cl[1]);
      split_tf32(ca.y, ch[2], cl[2]);
      split_tf32(cc.y, ch[3], cl[3]);
#pragma unroll
      for (int kb = 0; kb < 16; ++kb) {
        if (kb < kb_end) {
          const float2 bv = *reinterpret_cast<const float2*>(sB + (8 * kb + gr) * ldb + k);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bv.x, bh0, bl0);
          split_tf32(bv.y, bh1, bl1);
          mma_tf32x3(cb[kb], ch, cl, bh0, bh1, bl0, bl1);
        }
      }
    }
    // kept in this thread's own slots: it alone reads them back as C B^T
    // (state warps may read them as garbage columns past B, see the passes)
#pragma unroll
    for (int kb = 0; kb < 16; ++kb)
      if (kb < kb_end) cb_tiles[kb * 32] = make_float4(cb[kb][0], cb[kb][1], cb[kb][2], cb[kb][3]);
  }

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    if (hh > 0) {
      if (a.xbufs == 1) {               // every warp is done with the last head's x
        __syncthreads();
        load_f32_rows(s_x, xp + h * a.x_sh, a.x_ss, Q, P, P, ldx);
        cp_async_commit();
      }
      cp_async_wait_all();              // this head's x has landed
      __syncthreads();                  // and every warp is done with the last head
    }
    if (a.xbufs == 2 && hh + 1 < nh)    // the next head's x, into the last head's buffer
      load_f32_rows(s_x + ((hh + 1) & 1) * Q * ldx * 4, xp + (h + 1) * a.x_sh, a.x_ss, Q, P, P,
                    ldx);
    cp_async_commit();
    const float* xb = sX + (a.xbufs == 2 ? hh & 1 : 0) * Q * ldx;

    // Every pass computes kPassTiles 16-column tiles, with no guard: a
    // tile past p, or past this warp's tiles of n, reads other rows of
    // shared memory (at most 116 floats past a region, into the next: the
    // x buffer cp.async is filling, B, or C B^T tiles the row warps are
    // still writing) and is never stored.  Guards on the tiles kept ptxas
    // from interleaving their products (12% slower at mamba2-2.7b's
    // shape), and a tile count as a template constant spilled.
    // Invariant this rests on: an output element takes only its own row
    // of the A operand, its own column of the B operand and the k axis
    // (keys j < Q, or C B^T's n, zero-filled past n), so a garbage row or
    // column reaches only outputs that are not stored.  Nothing may
    // combine a pass's accumulators across rows or columns (a shuffle, a
    // row sum) before the guarded stores; compute-sanitizer's initcheck
    // and racecheck flag these reads by design.

    // y_diag rows: S = C B^T * 2^(cs_i - cs_j) * dt_j, split, times x; 64
    // columns of p per pass
    for (int pd = 0; has_rows && pd < PT; pd += kPassTiles) {
      const float* cs = sCs + hh * Q;
      const float* dt = sDt + hh * Q;
      const float cs_i[2] = {cs[i0], cs[i0 + 8]};
      float y[2 * kPassTiles][4];
#pragma unroll
      for (int e = 0; e < 2 * kPassTiles; ++e) y[e][0] = y[e][1] = y[e][2] = y[e][3] = 0.f;
#pragma unroll 2
      for (int kb = 0; kb < 2 * (rt + 1); ++kb) {
        // keys j, j + 1 of key tile kb: the accumulators (c0, c1 row i0;
        // c2, c3 row i0 + 8) are the A-fragment a0..a3 = c0, c2, c1, c3
        const float4 cbv = cb_tiles[kb * 32];
        const int j = 8 * kb + 2 * t;
        const float2 csj = *reinterpret_cast<const float2*>(cs + j);
        const float2 dtj = *reinterpret_cast<const float2*>(dt + j);
        const float e0 = j <= i0 ? cs_i[0] - csj.x : kNeg;        // mask before exp
        const float e1 = j + 1 <= i0 ? cs_i[0] - csj.y : kNeg;
        const float e2 = j <= i0 + 8 ? cs_i[1] - csj.x : kNeg;
        const float e3 = j + 1 <= i0 + 8 ? cs_i[1] - csj.y : kNeg;
        uint32_t sh[4], sl[4];
        split_tf32(cbv.x * exp2_approx(e0) * dtj.x, sh[0], sl[0]);
        split_tf32(cbv.z * exp2_approx(e2) * dtj.x, sh[1], sl[1]);
        split_tf32(cbv.y * exp2_approx(e1) * dtj.y, sh[2], sl[2]);
        split_tf32(cbv.w * exp2_approx(e3) * dtj.y, sh[3], sl[3]);
        const float* xr = xb + j * ldx + 16 * pd + 2 * gr;   // rows j and j + 1
#pragma unroll
        for (int dp = 0; dp < kPassTiles; ++dp) {
          const float2 x0 = *reinterpret_cast<const float2*>(xr + 16 * dp);
          const float2 x1 = *reinterpret_cast<const float2*>(xr + ldx + 16 * dp);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(x0.x, bh0, bl0);
          split_tf32(x1.x, bh1, bl1);
          mma_tf32x3(y[2 * dp], sh, sl, bh0, bh1, bl0, bl1);
          split_tf32(x0.y, bh0, bl0);
          split_tf32(x1.y, bh1, bl1);
          mma_tf32x3(y[2 * dp + 1], sh, sl, bh0, bh1, bl0, bl1);
        }
      }
      // rows i0, i0 + 8, dims 16 (pd + dp) + 4t .. + 3 from tiles 2 dp and 2 dp + 1;
      // only dims < P are stored (columns past p hold garbage, see above)
      float* y0 = a.y + ((static_cast<long long>(b) * a.nc * Q + s0 + i0) * a.H + h) *
                            static_cast<long long>(P);
      float* y1 = y0 + 8LL * a.H * P;
#pragma unroll
      for (int dp = 0; dp < kPassTiles; ++dp) {
        const int d = 16 * (pd + dp) + 4 * t;
        if (d < P) {
          *reinterpret_cast<float4*>(y0 + d) =
              make_float4(y[2 * dp][0], y[2 * dp + 1][0], y[2 * dp][1], y[2 * dp + 1][1]);
          *reinterpret_cast<float4*>(y1 + d) =
              make_float4(y[2 * dp][2], y[2 * dp + 1][2], y[2 * dp][3], y[2 * dp + 1][3]);
        }
      }
    }

    // states[d][n] = sum_j (x[j][d] w[j]) B[j][n], x * w split; column
    // tiles [p0, p0 + kPassTiles) of [np0, np1) per pass (the key loop
    // rolled: unrolled by 2 it spilled)
    for (int p0 = np0; has_state && p0 < np1; p0 += kPassTiles) {
      const float* w = sW + hh * Q;
      float st[2 * kPassTiles][4];
#pragma unroll
      for (int e = 0; e < 2 * kPassTiles; ++e) st[e][0] = st[e][1] = st[e][2] = st[e][3] = 0.f;
      const float* xa = xb + 16 * mt + gr;     // x^T rows d, d + 8
#pragma unroll 1
      for (int j = 2 * t; j < Q; j += 8) {    // keys j (slot t) and j + 1 (slot t + 4)
        const float2 wj = *reinterpret_cast<const float2*>(w + j);
        uint32_t ah[4], al[4];
        split_tf32(xa[j * ldx] * wj.x, ah[0], al[0]);
        split_tf32(xa[j * ldx + 8] * wj.x, ah[1], al[1]);
        split_tf32(xa[(j + 1) * ldx] * wj.y, ah[2], al[2]);
        split_tf32(xa[(j + 1) * ldx + 8] * wj.y, ah[3], al[3]);
        const float* br = sB + j * ldb + 16 * p0 + 2 * gr;   // rows j and j + 1
#pragma unroll
        for (int pr = 0; pr < kPassTiles; ++pr) {
          const float2 b0 = *reinterpret_cast<const float2*>(br + 16 * pr);
          const float2 b1 = *reinterpret_cast<const float2*>(br + ldb + 16 * pr);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0.x, bh0, bl0);
          split_tf32(b1.x, bh1, bl1);
          mma_tf32x3(st[2 * pr], ah, al, bh0, bh1, bl0, bl1);
          split_tf32(b0.y, bh0, bl0);
          split_tf32(b1.y, bh1, bl1);
          mma_tf32x3(st[2 * pr + 1], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      // rows d0, d0 + 8, columns 16 (p0 + pr) + 4t .. + 3; only this warp's
      // tiles, rows < P and columns < N are stored (the rest hold garbage)
      float* sp = a.st + ((static_cast<long long>(b) * a.nc + c) * a.H + h) *
                             static_cast<long long>(P) * N;
      const int d0 = 16 * mt + gr;
#pragma unroll
      for (int pr = 0; pr < kPassTiles; ++pr) {
        const int n = 16 * (p0 + pr) + 4 * t;
        if (p0 + pr < np1 && n < N) {
          if (d0 < P)
            *reinterpret_cast<float4*>(sp + static_cast<long long>(d0) * N + n) = make_float4(
                st[2 * pr][0], st[2 * pr + 1][0], st[2 * pr][1], st[2 * pr + 1][1]);
          if (d0 + 8 < P)
            *reinterpret_cast<float4*>(sp + static_cast<long long>(d0 + 8) * N + n) = make_float4(
                st[2 * pr][2], st[2 * pr + 1][2], st[2 * pr][3], st[2 * pr + 1][3]);
        }
      }
    }
  }
}

int launch_tf32x3(SsdArgs a, int batch, cudaStream_t stream) {
  const int rep = a.H / a.G;
  // two x buffers where they fit beside one head's scans, else one
  a.xbufs = tf_smem_bytes(a.Q, a.P, a.N, 1, 2) <= static_cast<size_t>(kMaxSmem) ? 2 : 1;
  const long long room =
      kMaxSmem - static_cast<long long>(tf_smem_bytes(a.Q, a.P, a.N, 0, a.xbufs));
  const int max_heads = static_cast<int>(std::min<long long>(kMaxHeads, room / (12LL * a.Q)));
  if (max_heads < 1) return kRefused;
  a.parts = pick_parts(batch * a.nc * a.G, rep, max_heads);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_blocks(reinterpret_cast<const void*>(ssd_chunk_tf32x3_kernel), a, batch,
                       tf_smem_bytes(a.Q, a.P, a.N, (rep + a.parts - 1) / a.parts, a.xbufs),
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
  if (Q < 32 || Q > kMaxQ || Q % 32 != 0 || S % Q != 0) return kRefused;
  if (P < 4 || P > kMaxQ || P % 4 != 0) return kRefused;
  if (N < 4 || N > kMaxQ || N % 4 != 0) return kRefused;
  if (dtype != kF32 && dtype != kBF16) return kRefused;
  const size_t elem = dtype == kF32 ? 4 : 2;
  if (!aligned4(x, elem, x_sb, x_ss, x_sh) || !aligned4(B, elem, b_sb, b_ss, b_sg) ||
      !aligned4(C, elem, c_sb, c_ss, c_sg))
    return kRefused;
  SsdArgs a{x, dt, A, B, C, y, st, S / Q, H, G, P, N, Q,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, 1, 4, 4, 2};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_bf16(a, batch, heads_per_block, s);
  if (heads_per_block != 0) return kRefused;   // the launcher picks the runs
  return launch_tf32x3(a, batch, s);
}
