// Tensor-core building blocks shared by the sm_80-style kernels (flash
// attention's bf16 mma and f32 tf32x3 kernels, the SSD chunk's bf16 and
// f32 kernels): cp.async copies into shared memory, ldmatrix fragment
// loads, the mma.sync m16n8k16 bf16 product and the m16n8k8 tf32
// product, both with f32 accumulators, the hi + lo splits that keep f32
// accuracy through them, and ex2.approx.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared (cp.async.cg takes only 16), for rows only
// 4-byte aligned; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

// 8 bytes global -> shared, for rows only 8-byte aligned; src_bytes 0
// writes zeros
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every group has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// wait until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one register of two bf16 -> two floats, the low half first
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two floats as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi), so
// hi + lo keeps v to about 2^-17 of its magnitude (one bf16 rounding
// alone keeps 2^-9).  A product with an exact bf16 operand then takes two
// mma_bf16 into one accumulator, one with hi and one with lo.
__device__ __forceinline__ void pack_bf16_split(float v0, float v1, uint32_t& hi,
                                                uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.  Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d as m16n8k16's.
// The tensor core reads a tf32 operand's top 19 bits.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as tf32 hi + lo: hi = tf32(x) rounded to nearest with ties away, as
// cvt.rna.tf32.f32 rounds it, by adding half of the 13 dropped bits' unit
// to the bit pattern and clearing them (the carry rounds up; cvt.rna in
// its place made flash's f32 kernel 1.39x slower on an H100 80GB HBM3 at
// 700 W, tools/flash_report.py --variants f32); lo = x - hi, exact in
// f32, which the tensor core reads to its top 19 bits.  hi + lo keeps x
// to about 2^-21 of its magnitude; one tf32 rounding alone keeps 2^-11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b at f32 accuracy from split operands (3xTF32): the small
// terms lo * hi and hi * lo first, then hi * hi; lo * lo (about 2^-22 of
// the product) is dropped.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// 2^x by the MUFU's ex2.approx, subnormal results flushed to 0: one
// instruction where exp2f wraps it in range handling.  Its relative
// error (about 2^-22) is far below a bf16 rounding, and level with the
// 3xTF32 products of the f32 kernels.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
