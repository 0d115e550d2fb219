// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/attention.py::_flash_bwd_dq_kernel
// (launched by _flash_backward). From the forward's per-row logsumexp
// (lse, scaled-score units) and delta = rowsum(dO * O) it rebuilds each
// score tile and computes
//   P = exp(scale * Q K^T - lse),  dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,
// so no (Tq, Tk) array is ever stored.
//
// Shapes: q/g/dq (BH, Tq, D), k/v (BH, Tk, D), lse/delta (BH, Tq) f32; all
// contiguous. Any Tq and Tk, D in {32, 64, 128}, f32 or bf16 inputs and
// dq (the dtype of q), f32 accumulation. Causal keeps kpos <= qpos (query
// offset 0).
//
// What bounds it on the H100: each CTA reads its Q and dO tiles once and
// the K/V tiles up to the causal diagonal; the work is 6*D FLOPs per
// (q, k) pair, so the algorithm is bound by operations. This first
// version does them on the CUDA cores in f32 (67 TFLOP/s peak), one
// shared-memory load per FMA in the score loops.
//
// Design: one CTA per (bh, 64-row q tile); the TPU grid's sequential kv
// axis becomes a loop over 64-row K/V tiles inside the CTA, up to the
// causal diagonal only (_diag_kblocks). Q (pre-scaled), dO, K and V sit in
// shared memory as f32 with rows padded to D+1 floats (no bank conflicts
// on row or column reads); lse and delta of the thread's row and its dQ
// accumulator stay in registers. TPR threads share a q row (BwdLayout):
// each computes the scores and dP of its interleaved key columns, and the
// dS values reach the row's other threads by shuffles for the dS K
// product over each thread's interleaved head dims (TPR * i + sub, so the
// row's threads read neighbouring banks). A q row at or past Tq or
// a key at or past Tk contributes exactly 0 (masked, never exp of an
// unloaded lse). No atomics: every sum runs in a fixed order, so dQ is
// bit-equal run to run. wgmma/TMA come in a later version.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(BwdLayout<D>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD, TPR = L::TPR, SC = L::SC, DH = L::DH;
  constexpr int NT = L::THREADS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + BQ * LD;
  float* ks = gs + BQ * LD;
  float* vs = ks + BK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int lane0 = (threadIdx.x & 31) & ~(TPR - 1);  // the row's first lane
  const int qpos = q0 + row;
  const bool row_ok = qpos < tq;
  const size_t q_base = (size_t)bh * tq * D;
  const size_t kv_base = (size_t)bh * tk * D;

  load_tile_pair<BQ, D, NT>(q + q_base, g + q_base, qs, gs, q0, tq, scale);
  const float row_lse = row_ok ? lse[(size_t)bh * tq + qpos] : 0.f;
  const float row_dl = row_ok ? delta[(size_t)bh * tq + qpos] : 0.f;

  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, tq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }
  const float* qrow = qs + row * LD;
  const float* grow = gs + row * LD;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed (and Q, dO loaded)
    load_tile_pair<BK, D, NT>(k + kv_base, v + kv_base, ks, vs, k0, tk, 1.f);
    __syncthreads();

    // scores and dP of this thread's key columns TPR * j + sub
    float s[SC], dp[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], gd = grow[d];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = TPR * j + sub;
        s[j] = fmaf(qd, ks[c * LD + d], s[j]);
        dp[j] = fmaf(gd, vs[c * LD + d], dp[j]);
      }
    }
    // s becomes dS = P * (dP - delta), 0 where masked
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int kpos = k0 + TPR * j + sub;
      const bool keep = row_ok && kpos < tk && (!causal || kpos <= qpos);
      s[j] = keep ? expf(s[j] - row_lse) * (dp[j] - row_dl) : 0.f;
    }
    // dQ[row, TPR * i + sub] += sum over the tile's 64 keys of dS * K, in
    // key order (fully unrolled: s[] and acc[] must stay in registers)
#pragma unroll
    for (int j = 0; j < SC; ++j) {
#pragma unroll
      for (int l = 0; l < TPR; ++l) {
        const float ds = __shfl_sync(FULL, s[j], lane0 + l);
        const float* krow = ks + (TPR * j + l) * LD + sub;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc[i] = fmaf(ds, krow[TPR * i], acc[i]);
      }
    }
  }

  if (row_ok) {
    T* out = dq + q_base + (size_t)qpos * D + sub;
#pragma unroll
    for (int i = 0; i < DH; ++i) store(out + TPR * i, acc[i] * scale);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* delta,
                   void* dq, int bh, int tq, int tk, int causal, float scale,
                   cudaStream_t stream) {
  const int smem = 2 * (BQ + BK) * (D + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<D, T><<<grid, BwdLayout<D>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dq, int bh, int tq, int tk, int d, int causal,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(q, k, v, g, lse, delta, dq, bh, tq, tk, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, g, lse, delta, dq, bh, tq, tk, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, g, lse, delta, dq, bh, tq, tk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g and dq share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* g,
                                  const void* lse, const void* delta,
                                  void* dq, int bh, int tq, int tk, int d,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, g, l, dl, dq, bh, tq, tk, d, causal, scale, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(q, k, v, g, l, dl, dq, bh, tq, tk, d, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
