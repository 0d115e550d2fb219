// Tensor-core building blocks of the bf16 flash kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu): 16-byte cp.async copies of bf16 tiles into padded
// shared rows, ldmatrix fragment loads, the m16n8k16 bf16 mma.sync, and
// the split of an f32 accumulator into a bf16 hi + lo A operand.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..),
//     a3 (g+8, 8+2t..);
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g);
//   C (16 x 8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..).
// So the accumulators of two neighbouring m16n8 tiles (columns 0-7 and
// 8-15) hold exactly the elements of one m16n8k16 A fragment: a score
// tile goes from C to A in registers (to_a_split), never through shared
// memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// Shared tiles hold 64 rows of D bf16 padded by 16 bytes (8 bf16): the
// eight 16-byte row pieces one ldmatrix phase reads then fall on eight
// distinct bank quads at every D in {32, 64, 128}, and each row stays
// 16-byte aligned for cp.async.
template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;        // row stride, bf16
  static constexpr int ELEMS = 64 * LD;   // one 64-row tile
  static constexpr int BYTES = ELEMS * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 writes 16 zero bytes and reads
// nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero when !valid (the lse and delta rows,
// whose offsets bh * Tq + q0 need not be 16-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a contiguous (n, D) bf16 matrix into a padded
// shared tile, rows at or past n zero-filled. 16-byte copies; all NT
// threads of the CTA take part; the caller commits the group.
template <int D, int NT>
__device__ __forceinline__ void cp_async_tile(bf16* dst,
                                              const bf16* __restrict__ src,
                                              int r0, int n) {
  constexpr int CPR = D / 8;  // 16-byte pieces per row
  static_assert(64 * CPR % NT == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < 64 * CPR / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * MmaTile<D>::LD + c * 8,
               src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows [m0, m0 + 16), columns [k0, k0 + 16) of a padded
// row-major tile.
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int m0, int k0, int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 15)) * MmaTile<D>::LD + k0 +
                 (lane >> 4) * 8);
}

// B fragments of two n8 tiles, rows [n0, n0 + 16) of a tile stored n by
// k (the K of Q K^T): r0, r1 = b0, b1 of rows n0..n0+7; r2, r3 of the
// next eight.
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * MmaTile<D>::LD +
                 k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles, columns [n0, n0 + 16), from a tile stored
// k by n, whose reduction runs along its rows (the K of dS K):
// ldmatrix.trans. Rows [k0, k0 + 16).
template <int D>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16* tile,
                                        int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          MmaTile<D>::LD +
                   n0 + (lane >> 4) * 8);
}

// c += a b, m16n8k16, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as the bf16 pair hi = bf16(x) and lo = bf16(x - hi): x - hi is
// exact in f32, so hi + lo holds x to about 2^-16 relative, and two
// MMAs into one f32 accumulator carry an f32 operand nearly whole.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragment (16 x 16) held by the accumulators c (columns 0-7) and
// d (columns 8-15), split into its hi and lo bf16 parts.
__device__ __forceinline__ void to_a_split(const float (&c)[4],
                                           const float (&d)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(c[0], c[1], hi[0], lo[0]);
  split2(c[2], c[3], hi[1], lo[1]);
  split2(d[0], d[1], hi[2], lo[2]);
  split2(d[2], d[3], hi[3], lo[3]);
}

// Two neighbouring bf16 outputs, 4-byte aligned
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace
