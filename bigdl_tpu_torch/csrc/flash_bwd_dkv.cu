// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/attention.py::_flash_bwd_dkv_kernel
// (launched by _flash_backward). For one tile of keys it streams the q
// tiles that reach it, rebuilds P = exp(scale * Q K^T - lse) from the
// forward's logsumexp, and accumulates
//   dV += P^T dO,  dS = P * (dO V^T - delta),  dK += dS^T (scale * Q),
// so no (Tq, Tk) array is ever stored.
//
// Shapes: q/g (BH, Tq, D), k/v/dk/dv (BH, Tk, D), lse/delta (BH, Tq) f32;
// all contiguous. Any Tq and Tk, D in {32, 64, 128}, f32 or bf16 inputs,
// dk/dv in that dtype, f32 accumulation. Causal keeps kpos <= qpos (query
// offset 0).
//
// What bounds it on the H100: each CTA reads its K/V tile once and the
// Q/dO tiles from the causal diagonal on; the work is 8*D FLOPs per
// (q, k) pair, so the algorithm is bound by operations. This first
// version does them on the CUDA cores in f32 (67 TFLOP/s peak), one
// shared-memory load per FMA in the score loops.
//
// Design: one CTA per (bh, 64-row key tile); the TPU grid's sequential q
// axis becomes a loop over 64-row Q/dO tiles inside the CTA, from the
// first tile whose rows reach the key tile (q0 = floor(k0 / BQ) when
// causal). K, V, Q (pre-scaled) and dO sit in shared memory as f32 with
// rows padded to D+1 floats, lse and delta of the q tile beside them.
// TPR threads share a key row (BwdLayout): each computes P and dS for its
// interleaved q columns, and the values reach the row's other threads by
// shuffles for the P^T dO and dS^T Q products over each thread's
// interleaved head dims. The dK and dV accumulators (2 x D / TPR floats a
// thread) stay in registers; four threads a row at D = 128 keep them
// under the register cap. A q row at or past Tq, or a key at or past Tk,
// contributes exactly 0 (masked, never exp of an unloaded lse). No
// atomics: dQ is another kernel (flash_bwd_dq.cu, JAX's two-kernel
// split), and every sum here runs in a fixed order, so dK and dV are
// bit-equal run to run. wgmma/TMA come in a later version.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(BwdLayout<D>::THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int causal,
                     float scale) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD, TPR = L::TPR, SC = L::SC, DH = L::DH;
  constexpr int NT = L::THREADS;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* gs = qs + BQ * LD;
  float* lse_s = gs + BQ * LD;
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int row = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int lane0 = (threadIdx.x & 31) & ~(TPR - 1);  // the row's first lane
  const int kpos = k0 + row;
  const bool row_ok = kpos < tk;
  const size_t q_base = (size_t)bh * tq * D;
  const size_t kv_base = (size_t)bh * tk * D;

  load_tile_pair<BK, D, NT>(k + kv_base, v + kv_base, ks, vs, k0, tk, 1.f);

  float acc_dk[DH], acc_dv[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  const int n_qt = (tq + BQ - 1) / BQ;
  const int qt_lo = causal ? k0 / BQ : 0;
  const float* krow = ks + row * LD;
  const float* vrow = vs + row * LD;

  for (int qt = qt_lo; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous q tile is consumed (and K, V loaded)
    load_tile_pair<BQ, D, NT>(q + q_base, g + q_base, qs, gs, q0, tq, scale);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool ok = q0 + i < tq;
      lse_s[i] = ok ? lse[(size_t)bh * tq + q0 + i] : 0.f;
      dl_s[i] = ok ? delta[(size_t)bh * tq + q0 + i] : 0.f;
    }
    __syncthreads();

    // scores and dP of this thread's q columns TPR * j + sub
    float s[SC], dp[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = TPR * j + sub;
        s[j] = fmaf(qs[c * LD + d], kd, s[j]);
        dp[j] = fmaf(gs[c * LD + d], vd, dp[j]);
      }
    }
    // s becomes P and dp becomes dS = P * (dP - delta), 0 where masked
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = TPR * j + sub;
      const int qpos = q0 + c;
      const bool keep = row_ok && qpos < tq && (!causal || kpos <= qpos);
      const float p = keep ? expf(s[j] - lse_s[c]) : 0.f;
      s[j] = p;
      dp[j] = keep ? p * (dp[j] - dl_s[c]) : 0.f;
    }
    // dV[row, TPR * i + sub] += sum over the tile's 64 q rows of P * dO,
    // dK[row, TPR * i + sub] += the same of dS * (scale * Q), in q order
    // (fully unrolled: the arrays must stay in registers)
#pragma unroll
    for (int j = 0; j < SC; ++j) {
#pragma unroll
      for (int l = 0; l < TPR; ++l) {
        const float p = __shfl_sync(FULL, s[j], lane0 + l);
        const float ds = __shfl_sync(FULL, dp[j], lane0 + l);
        const int c = TPR * j + l;
        const float* grow = gs + c * LD + sub;
        const float* qrow = qs + c * LD + sub;
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          acc_dv[i] = fmaf(p, grow[TPR * i], acc_dv[i]);
          acc_dk[i] = fmaf(ds, qrow[TPR * i], acc_dk[i]);
        }
      }
    }
  }

  if (row_ok) {
    const size_t off = kv_base + (size_t)kpos * D + sub;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      store(dk + off + TPR * i, acc_dk[i]);
      store(dv + off + TPR * i, acc_dv[i]);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* delta,
                   void* dk, void* dv, int bh, int tq, int tk, int causal,
                   float scale, cudaStream_t stream) {
  const int smem =
      (2 * (BQ + BK) * (D + 1) + 2 * BQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tk + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<D, T><<<grid, BwdLayout<D>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int d,
                       int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32, T>(q, k, v, g, lse, delta, dk, dv, bh, tq, tk, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, g, lse, delta, dk, dv, bh, tq, tk, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, g, lse, delta, dk, dv, bh, tq, tk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dk and dv share it).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int bh, int tq,
                                   int tk, int d, int causal, float scale,
                                   int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(q, k, v, g, l, dl, dk, dv, bh, tq, tk, d, causal, scale, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(q, k, v, g, l, dl, dk, dv, bh, tq, tk, d, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
