// What the three flash kernels (flash_fwd.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu) share: the 64-row q and key tiles, the conversions
// between the storage dtype and f32, the loader of padded f32 tiles into
// shared memory, and the backward kernels' thread layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [r0, r0 + ROWS) of two contiguous (n, D) matrices a and b into
// shared f32 tiles with rows padded to D + 1 floats, a's values times
// `mul_a`; rows at or past n are 0. One loop for both, so their global
// loads are in flight together. All NT threads of the CTA take part.
template <int ROWS, int D, int NT, typename T>
__device__ __forceinline__ void load_tile_pair(const T* __restrict__ a,
                                               const T* __restrict__ b,
                                               float* __restrict__ da,
                                               float* __restrict__ db,
                                               int r0, int n, float mul_a) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D;
    float x = 0.f, y = 0.f;
    if (r0 + r < n) {
      const size_t off = (size_t)(r0 + r) * D + c;
      x = to_f32(a[off]) * mul_a;
      y = to_f32(b[off]);
    }
    da[r * (D + 1) + c] = x;
    db[r * (D + 1) + c] = y;
  }
}

// The backward kernels' thread layout: TPR threads share one row of the
// CTA's 64-row tile; each computes 64 / TPR of the row's 64 scores
// (columns TPR * j + sub) and accumulates D / TPR of its head dims
// (dims TPR * i + sub, so a row's threads read neighbouring banks). Four
// threads a row at D = 128 keep the f32 accumulators of dkv (2 x 32 a
// thread) and the score registers well under the 255-register cap.
template <int D>
struct BwdLayout {
  static constexpr int TPR = D >= 128 ? 4 : 2;
  static constexpr int THREADS = 64 * TPR;
  static constexpr int SC = 64 / TPR;  // score columns per thread
  static constexpr int DH = D / TPR;   // accumulated head dims per thread
  static constexpr int LD = D + 1;     // padded row of the shared tiles
};

}  // namespace
