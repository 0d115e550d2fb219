// Tensor-core building blocks of the bf16 flash kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the padded 64-row bf16 tiles, their
// 16-byte cp.async loader, the ldmatrix fragment loads of A and B from
// them, and the split of an f32 accumulator into a bf16 hi + lo A
// operand. The generic PTX wrappers (cp.async, ldmatrix, mma.sync, the
// hi + lo split of a pair) are in mma_common.cuh, with the fragment
// layouts; from those, the accumulators of two neighbouring m16n8 tiles
// (columns 0-7 and 8-15) hold exactly the elements of one m16n8k16 A
// fragment: a score tile goes from C to A in registers (to_a_split),
// never through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_common.cuh"

namespace {

// Shared tiles hold 64 rows of D bf16 padded by 16 bytes (8 bf16): the
// eight 16-byte row pieces one ldmatrix phase reads then fall on eight
// distinct bank quads at every D in {32, 64, 128, 192}, and each row
// stays 16-byte aligned for cp.async.
template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;        // row stride, bf16
  static constexpr int ELEMS = 64 * LD;   // one 64-row tile
  static constexpr int BYTES = ELEMS * 2;
};

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

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace
