// What the two bf16 conv_bn kernels on the tensor cores (conv_bn_1x1.cu's
// conv_bn_1x1_bf16_kernel and conv_bn_kxk.cu's conv_bn_kxk_bf16_kernel)
// share: the tiles, one k-step's MMAs over a pipeline stage, the runs of
// MMAs added into the f32 sum, and the epilogue that stores y and writes
// the CTA's statistics partial column.
//
// The GEMM is M = O output channels by N = N*Ho*Wo output pixels,
// flattened across samples so that small late-stage images (7x7) fill
// whole tiles. A CTA of four warps owns a TM-channel by TN-pixel tile;
// warp (wm, wn) multiplies its WM x WN sub-tile by m16n8k16 mma.sync. A
// stage holds TK entries of K: A as TM rows of TK (row stride LDS, the
// weights' rows contiguous in K), B either as TN pixel rows of TK (the
// kxk kernel's NHWC rows, stride LDS) or as TK channel rows of TN pixels
// (the 1x1 kernel's NCHW rows, stride LDB, read by ldmatrix.trans). Rows
// are padded by 16 bytes, so ldmatrix meets no bank conflicts.
//
// The epilogue rounds y to bf16 once, stages it through shared memory and
// stores it as NCHW rows of consecutive pixels, 16 bytes a store where the
// image's pixel count allows it; the statistics come from
// the f32 accumulators: each row's centred sums over the thread's
// columns, across its quad by two fixed shuffles, then across the warps
// that share the row in fixed order through shared memory, into the CTA's
// column of part (2, O, gridDim.x). No atomics and no split of K: y and
// the sums are bit-equal run to run.

#pragma once

#include "mma_common.cuh"

namespace {

// TN is CONV_MMA_TILE_P in ops/_cuda.py
constexpr int TM = 64;   // output channels per CTA
constexpr int TN = 128;  // flattened output pixels per CTA
constexpr int TK = 64;   // entries of K (input channels) per k-step
constexpr int WM = 64;   // output channels per warp
constexpr int WN = 32;   // pixels per warp
constexpr int STAGES = 3;
// k-steps whose MMAs accumulate into a fresh fragment before it is added
// into the running f32 sum. The tensor cores do not round their f32
// accumulation to nearest: a long chain of MMAs into one fragment drifts
// toward zero, some 1e-5 relative over ResNet-50's K = 4608, a bias the
// statistics' sums of squares keep.
constexpr int CHAIN = 2;
constexpr int WARPS_N = TN / WN;
constexpr int MMA_THREADS = 32 * (TM / WM) * WARPS_N;
constexpr int MI = WM / 16;     // m16 tiles per warp
constexpr int NI = WN / 8;      // n8 tiles per warp
constexpr int PIECES = TK / 8;  // 16-byte pieces per K row and k-step
constexpr int LDS = TK + 8;     // padded K row, bf16
constexpr int LDB = TN + 8;     // padded pixel row of a [k][pixel] B tile
constexpr int LDY = TN + 8;     // padded row of the staged y tile, bf16
constexpr int A_COPIES = TM * PIECES / MMA_THREADS;  // per thread
// the epilogue's shared memory: the staged y tile and the warps' sums
constexpr int EPILOGUE_BYTES = TM * LDY * 2 + WARPS_N * TM * 2 * 4;
static_assert(TM * PIECES % MMA_THREADS == 0 && A_COPIES >= 1,
              "whole rounds of A copies");
static_assert(MMA_THREADS >= 2 * TM && MMA_THREADS % TN == 0 &&
                  LDY % 8 == 0,
              "the epilogue's thread roles and 16-byte staged rows");

// The A copies of one k-step: the thread moves 16-byte piece q (entries
// 8q..8q+7 of the k-step) of A rows ar + RA i, RA = MMA_THREADS / PIECES.
struct ARows {
  bool ok[A_COPIES];
  const bf16* row[A_COPIES];
};

// w's rows o0 + ar + RA i, each `k` entries long (the k-step's entries
// start `k_off` further along the row)
__device__ __forceinline__ ARows a_rows(const bf16* w, int o0, int o, int k,
                                        int ar) {
  constexpr int RA = MMA_THREADS / PIECES;
  ARows a;
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int oo = o0 + ar + RA * i;
    a.ok[i] = oo < o;
    a.row[i] = w + (size_t)(a.ok[i] ? oo : 0) * k;
  }
  return a;
}

// entries k_off + 8q .. of each row into as; a piece past K (!k_ok) or
// past O is zero-filled, never read
__device__ __forceinline__ void load_a(bf16* as, const ARows& a, const bf16* w,
                                       int ar, int q, int k_off, bool k_ok) {
  constexpr int RA = MMA_THREADS / PIECES;
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const bool ok = a.ok[i] && k_ok;
    cp_async16(as + (ar + RA * i) * LDS + 8 * q, ok ? a.row[i] + k_off : w,
               ok);
  }
}

__device__ __forceinline__ void zero(float (&f)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[mi][j][e] = 0.f;
}

// acc += chain by ordinary f32 adds; chain = 0
__device__ __forceinline__ void fold_chain(float (&acc)[MI][NI][4],
                                           float (&chain)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][j][e] += chain[mi][j][e];
        chain[mi][j][e] = 0.f;
      }
}

// One stage's MMAs into chain: A rows from as; B from bs as pixel rows of
// K (B_K_ROWS false, stride LDS) or as K rows of pixels (B_K_ROWS true,
// stride LDB, transposed on the way into registers).
template <bool B_K_ROWS>
__device__ __forceinline__ void mma_stage(const bf16* as, const bf16* bs,
                                          int wm, int wn, int lane,
                                          float (&chain)[MI][NI][4]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], as + (WM * wm + 16 * mi + (lane & 15)) * LDS + 16 * kk +
                         (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj) {
      // two n8 tiles of the warp's pixels: b[0], b[1] and b[2], b[3]
      uint32_t b[4];
      if (B_K_ROWS)
        ldsm_x4_t(b, bs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LDB +
                         WN * wn + 16 * nj + (lane >> 4) * 8);
      else
        ldsm_x4(b, bs + (WN * wn + 16 * nj + (lane & 7) + (lane >> 4) * 8) *
                            LDS +
                       16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16(chain[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(chain[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The epilogue of the CTA at grid (pixel tile, channel tile), after the
// pipeline's shared memory is free (cp_async_wait<0> and __syncthreads):
// y (N, O, hw) with npix = N * hw valid pixels, and the CTA's column of
// part (2, O, gridDim.x).
__device__ __forceinline__ void store_y_and_stats(
    const float (&acc)[MI][NI][4], unsigned char* smem_raw,
    const float* __restrict__ shift, bf16* __restrict__ y,
    float* __restrict__ part, int o, int npix, int hw) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int p0 = blockIdx.x * TN;
  const int o0 = blockIdx.y * TM;
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);             // (TM, LDY)
  float* red = reinterpret_cast<float*>(ys + TM * LDY);     // (WARPS_N, TM, 2)
  const bool full = p0 + TN <= npix;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = WM * wm + 16 * mi + gr + 8 * r;
      const int oo = o0 + row;
      const float sh = oo < o ? shift[oo] : 0.f;
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = WN * wn + 8 * j + 2 * tc;
        const float v0 = acc[mi][j][2 * r], v1 = acc[mi][j][2 * r + 1];
        store2(ys + row * LDY + col, v0, v1);
        if (full || p0 + col < npix) {
          const float d = v0 - sh;
          p1 += d;
          p2 = fmaf(d, d, p2);
        }
        if (full || p0 + col + 1 < npix) {
          const float d = v1 - sh;
          p1 += d;
          p2 = fmaf(d, d, p2);
        }
      }
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p2 += __shfl_xor_sync(0xffffffffu, p2, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      p2 += __shfl_xor_sync(0xffffffffu, p2, 2);
      if (tc == 0) {
        red[(wn * TM + row) * 2] = p1;
        red[(wn * TM + row) * 2 + 1] = p2;
      }
    }
  }
  __syncthreads();

  // the CTA's partial column: the warps' column slices in fixed order
  const int ncols = gridDim.x;
  if (tid < 2 * TM && o0 + (tid >> 1) < o) {
    const int row = tid >> 1, which = tid & 1;  // which: s1 or s2
    float sum = red[row * 2 + which];
#pragma unroll
    for (int qn = 1; qn < WARPS_N; ++qn)
      sum += red[(qn * TM + row) * 2 + which];
    part[((size_t)which * o + o0 + row) * ncols + blockIdx.x] = sum;
  }
  // y as NCHW rows of the tile's pixels. Where a sample's pixel count is
  // a multiple of 8 and y 16-byte aligned, 8 pixels never cross a sample
  // and thread tid stores pixels 8 (tid % 16) .. + 7 of rows tid / 16,
  // tid / 16 + MMA_THREADS / 16, .. as one 16-byte store each; otherwise
  // pixel p0 + tid % TN of rows tid / TN, tid / TN + MMA_THREADS / TN, ..
  const int rows = min(TM, o - o0);
  if (hw % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    constexpr int PIECES_Y = TN / 8;  // 16-byte pieces of a row
    const int col = tid % PIECES_Y * 8;
    const int p = p0 + col;
    if (p < npix) {
      const int n = p / hw, r = p - n * hw;
      bf16* yp = y + ((size_t)n * o + o0) * hw + r;
      for (int row = tid / PIECES_Y; row < rows;
           row += MMA_THREADS / PIECES_Y)
        *reinterpret_cast<uint4*>(yp + (size_t)row * hw) =
            *reinterpret_cast<const uint4*>(ys + row * LDY + col);
    }
  } else {
    const int col = tid % TN;
    const int p = p0 + col;
    if (p < npix) {
      const int n = p / hw, r = p - n * hw;
      bf16* yp = y + ((size_t)n * o + o0) * hw + r;
      for (int row = tid / TN; row < rows; row += MMA_THREADS / TN)
        yp[(size_t)row * hw] = ys[row * LDY + col];
    }
  }
}

}  // namespace
