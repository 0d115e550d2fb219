// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by _flash_forward). It computes O = softmax(scale * Q K^T) V
// with an online softmax, and optionally the per-row logsumexp in
// scaled-score units for a later blockwise backward.
//
// Shapes: q (BH, Tq, D), k/v (BH, Tk, D), o like q, lse (BH, Tq) f32;
// all contiguous. Any Tq and Tk (ragged tiles are masked), D in
// {32, 64, 128}, f32 or bf16 inputs, f32 accumulation. Causal masking
// keeps kpos <= qpos (query offset 0).
//
// What bounds it on the H100: at the prefill shapes (T <= 512, D = 64)
// each CTA reads its Q tile once and the K/V tiles up to the causal
// diagonal; the work is 4*D FLOPs per (q, k) pair against 2*D*itemsize
// bytes per key, so the algorithm is bound by operations. This first
// version does those operations on the CUDA cores in f32 (67 TFLOP/s
// peak) rather than on the tensor cores, and is limited further by
// shared-memory loads (one load per FMA in the score loop).
//
// Design: one CTA of 128 threads per (bh, 64-row q tile). The TPU grid's
// sequential kv axis becomes a loop inside the CTA over 64-row K/V tiles,
// up to the causal diagonal only. Q (pre-scaled), K and V tiles sit in
// shared memory as f32 with rows padded to D+1 floats, so neither the
// row-per-thread reads nor the column reads conflict on banks. Two
// threads share a q row: each computes 32 interleaved score columns and
// accumulates half of the head dims; the row max and row sum are
// combined with one shuffle. The (m, l, acc) state stays in registers.
// Fully masked rows keep a shift of 0 and the denominator is clamped at
// 1e-30, as in the JAX reference. wgmma/TMA come in a later version.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int THREADS = 128;  // two threads per q row

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 float scale) {
  constexpr int LD = D + 1;  // padded row stride of the shared tiles
  constexpr int HALF = D / 2;
  constexpr int SC = BK / 2;  // score columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int qpos = q0 + row;
  const size_t q_base = (size_t)bh * tq * D;
  const size_t kv_base = (size_t)bh * tk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < tq) x = to_f32(q[q_base + (size_t)(q0 + r) * D + c]) * scale;
    qs[r * LD + c] = x;
  }

  float m = -INFINITY, l = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, tq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    load_tile_pair<BK, D, THREADS>(k + kv_base, v + kv_base, ks, vs, k0, tk,
                                   1.f);
    __syncthreads();

    // scores of this thread's columns 2j + half
    float s[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = 0.f;
    const float* qrow = qs + row * LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < SC; ++j)
        s[j] = fmaf(qd, ks[(2 * j + half) * LD + d], s[j]);
    }

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int kpos = k0 + 2 * j + half;
      const bool keep = kpos < tk && (!causal || kpos <= qpos);
      s[j] = keep ? s[j] : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    // a row with nothing unmasked yet keeps m = -inf: shift by 0
    const float shift = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - shift);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      s[j] = expf(s[j] - shift);
      rsum += s[j];
    }
    rsum += __shfl_xor_sync(FULL, rsum, 1);
    l = l * alpha + rsum;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= alpha;

    // P V over this thread's head dims [half*D/2, half*D/2 + D/2)
    // (fully unrolled: s[] and acc[] must stay in registers)
    const int d0 = half * HALF;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const float p_mine = s[j];
      const float p_other = __shfl_xor_sync(FULL, s[j], 1);
      const float* v_mine = vs + (2 * j + half) * LD + d0;
      const float* v_other = vs + (2 * j + 1 - half) * LD + d0;
#pragma unroll
      for (int i = 0; i < HALF; ++i)
        acc[i] = fmaf(p_mine, v_mine[i], fmaf(p_other, v_other[i], acc[i]));
    }
    m = m_new;
  }

  if (qpos < tq) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + q_base + (size_t)qpos * D + half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) store(orow + i, acc[i] / lc);
    if (lse != nullptr && half == 0) lse[(size_t)bh * tq + qpos] = m + logf(lc);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = 3 * BQ * (D + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int tq, int tk, int d, int causal,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int tq, int tk,
                               int d, int causal, float scale, int dtype,
                               void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, o, lse_f, bh, tq, tk, d, causal, scale, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse_f, bh, tq, tk, d, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
