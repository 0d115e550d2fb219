// What the two conv_bn kernels (conv_bn_1x1.cu, conv_bn_kxk.cu) share:
// the tile sizes, the 4x4 register-tile FMA step over one shared-memory
// k-slice, the epilogue that stores y and writes each CTA's statistics
// partials, and the fixed-order second pass over those partials.
//
// The race the TPU never had: the TPU grid adds s1/s2 in order across its
// (n, hw) steps. Here CTAs run in parallel, so each CTA writes its per-
// channel partial sums to its own column of a scratch buffer (reduced over
// the CTA in a fixed shuffle order), and a second, tiny kernel sums each
// channel's columns in a fixed order. No float atomics: the sums are
// bit-identical run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output channels per CTA
constexpr int BN = 64;        // output pixels per CTA (CONV_BN_TILE_P)
constexpr int BK = 16;        // reduction entries per main-loop step
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 tile each
constexpr int LDA = BM + 4;   // padded row of the weight tile
constexpr int RED_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One k-slice of the 64x64 tile: the thread at (ty, tx) adds
// as[kk][ty*4 + i] * bs[kk][tx*4 + j] into acc[i][j], two 16-byte shared
// loads per 16 FMAs.
__device__ __forceinline__ void fma_tile(float (*as)[LDA], float (*bs)[BN],
                                         int ty, int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Epilogue of the CTA at grid (pixel tile, channel tile, n): store y[n]
// (O, npix) from the f32 accumulator, then each row's centred sums
// (acc - shift) and (acc - shift)^2 over this CTA's valid pixels. The 16
// threads of one channel group are the 16 lanes of a half-warp
// (tx = lane & 15), reduced with a fixed xor pattern into column
// n * gridDim.x + blockIdx.x of part (2, O, N * gridDim.x).
template <typename T>
__device__ __forceinline__ void store_and_stats(const float (&acc)[4][4],
                                                T* __restrict__ y,
                                                const float* __restrict__ shift,
                                                float* __restrict__ part,
                                                int o, int npix, int ty,
                                                int tx) {
  const int p0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int n = blockIdx.z;
  T* yn = y + (size_t)n * o * npix;
  const int col = n * gridDim.x + blockIdx.x;
  const int ncols = gridDim.z * gridDim.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oo = o0 + ty * 4 + i;
    const bool row_in = oo < o;
    const float sh = row_in ? shift[oo] : 0.f;
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (row_in && pp < npix) {
        store(yn + (size_t)oo * npix + pp, acc[i][j]);
        const float d = acc[i][j] - sh;
        p1 += d;
        p2 = fmaf(d, d, p2);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      p1 += __shfl_xor_sync(FULL, p1, off);
      p2 += __shfl_xor_sync(FULL, p2, off);
    }
    if (tx == 0 && row_in) {
      part[(size_t)oo * ncols + col] = p1;
      part[((size_t)o + oo) * ncols + col] = p2;
    }
  }
}

// grid (O, 2): block (ch, which) sums row `which*O + ch` of part (ncols
// values) in a fixed order: strided per-thread sums, then a shared-memory
// tree.
__global__ void __launch_bounds__(RED_THREADS)
stats_reduce_kernel(const float* __restrict__ part, int o, int ncols,
                    float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float red[RED_THREADS];
  const int ch = blockIdx.x;
  const int which = blockIdx.y;
  const float* row = part + ((size_t)which * o + ch) * ncols;
  float acc = 0.f;
  for (int i = threadIdx.x; i < ncols; i += RED_THREADS) acc += row[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = RED_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) (which ? s2 : s1)[ch] = red[0];
}

// After the main kernel's launch on `stream` with `grid`: check it, then
// launch the second pass over its grid.x * grid.z partial columns.
inline cudaError_t reduce_stats(dim3 grid, const float* part, int o,
                                float* s1, float* s2, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<dim3(o, 2), RED_THREADS, 0, stream>>>(
      part, o, (int)(grid.x * grid.z), s1, s2);
  return cudaGetLastError();
}

}  // namespace
