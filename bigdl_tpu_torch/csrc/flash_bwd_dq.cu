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
// Shapes: q/dq (BH, Tq, Dqk), k (BH, Tk, Dqk), v (BH, Tk, Dv), g (BH, Tq,
// Dv), lse/delta (BH, Tq) f32; all contiguous, and for bf16 q, k, v and g
// 16-byte aligned. Any Tq and Tk; (Dqk, Dv) one of (32, 32), (64, 64),
// (128, 128) in f32 or bf16, or (192, 128) in bf16; inputs and dq in one
// dtype, f32 accumulation. Causal keeps kpos <= seq_offset + qpos (query
// row i at absolute position seq_offset + i, as in the forward). One CTA per
// (bh, 64-row q tile); the TPU grid's sequential kv axis becomes a loop
// over 64-row K/V tiles inside the CTA, up to the causal diagonal only
// (_diag_kblocks, the offset included). A q row at or past Tq or a key
// at or past Tk contributes exactly 0 (masked, never exp of an unloaded
// lse). No atomics: every sum runs in a fixed order, so dQ is bit-equal
// run to run.
//
// What bounds it on the H100: each CTA reads its Q and dO tiles once and
// the K/V tiles up to the causal diagonal; the function's work is 6*D
// FLOPs per (q, k) pair. In bf16 on the tensor cores that is less time
// than moving its bytes once at the training shape (B=16, H=8, T=512,
// D=64), so the function is bound by bytes; what holds a kernel back is
// getting the products onto the tensor cores at all, then feeding them
// from shared memory.
//
// bf16 (flash_bwd_dq_bf16_kernel): one warpgroup per CTA, warp w owning
// rows 16w..16w+15 of the q tile. The tiles stay bf16 in shared memory,
// rows padded by 16 bytes so ldmatrix reads are free of bank conflicts.
// Q and dO are loaded once (their A fragments held in registers at
// D <= 64); K/V tiles are double-buffered, the next one's 16-byte
// cp.async copies in flight while the current one's products run. S =
// Q K^T and dP = dO V^T are m16n8k16 mma.sync products with K and V as B
// fragments (ldmatrix); P and dS are formed in the accumulators (exp2f,
// log2 e folded into scale and lse); dS goes to A fragments in registers
// and dQ += dS K takes K by ldmatrix.trans. The JAX kernel carries dS in
// f32, so dS enters that product as a bf16 hi + lo pair (two MMAs into
// one f32 accumulator): one rounding of dS to bf16 would compute another
// function. dQ * scale is rounded to bf16 once, at the store. The causal
// tiles run heaviest first (the last q tile walks the most K/V tiles).
// The kernel is a template over (DQK, DV): Q, K and dQ are DQK wide, dO
// and V DV wide. At DQK = DV a tile takes one pass, the body written for
// D (its registers unchanged); at (192, 128) dQ's accumulator takes 96
// registers a thread, so S and dP are formed for 32 keys of the tile at
// a time (as dkv does at D = 128), which keeps their 64 registers at 32.
//
// f32 (flash_bwd_dq_f32_kernel): the CUDA cores. Q (pre-scaled), dO, K
// and V sit in shared memory as f32 with rows padded to D+1 floats; lse
// and delta of the thread's row and its dQ accumulator stay in
// registers. TPR threads share a q row (BwdLayout): each computes the
// scores and dP of its interleaved key columns, and the dS values reach
// the row's other threads by shuffles for the dS K product over each
// thread's interleaved head dims (TPR * i + sub, so the row's threads
// read neighbouring banks). One shared-memory load per FMA bounds it.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(BwdLayout<D>::THREADS)
flash_bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, int causal, int off, float scale) {
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
    const int last_q = off + min(q0 + BQ, tq) - 1;
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
      const bool keep =
          row_ok && kpos < tk && (!causal || kpos <= off + qpos);
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

constexpr int MMA_THREADS = 128;  // one warpgroup: 4 warps of 16 q rows

// lim = causal ? seq_offset : -1: key j attends query row i iff lim < 0 or
// j <= lim + i. One kernel parameter (read from the constant bank) in
// place of causal and the offset keeps the register count of the kernel
// before the offset, with no spills at D = 128.

// three CTAs an SM at D <= 64 (at most 168 registers, no spills); at
// D = 128 that cap would spill, so the compiler takes what it needs
template <int DQK, int DV>
__global__ void __launch_bounds__(MMA_THREADS, DQK <= 64 ? 3 : 1)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int tq, int tk, int lim,
                         float scale) {
  using MQ = MmaTile<DQK>;
  using MV = MmaTile<DV>;
  constexpr int NT = MMA_THREADS;
  constexpr int KD = DQK / 16;            // k-steps of Q K^T
  constexpr int KV = DV / 16;             // k-steps of dO V^T
  constexpr int KM = KD > KV ? KD : KV;
  constexpr bool HOLD = DQK <= 64;        // Q and dO A fragments in registers
  constexpr int NC = DQK <= 128 ? BK : 32;  // keys a score pass forms
  // D_qk != D_v takes the pass loop below, which reads Q and dO from
  // shared memory
  static_assert(DQK == DV || !HOLD, "unequal widths hold no fragments");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + MQ::ELEMS;
  bf16* ks = gs + MV::ELEMS;      // two buffers
  bf16* vs = ks + 2 * MQ::ELEMS;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
  const int m0 = 16 * warp;                 // the warp's first tile row
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const size_t q_base = (size_t)bh * tq * DQK;
  const size_t g_base = (size_t)bh * tq * DV;
  const size_t k_base = (size_t)bh * tk * DQK;
  const size_t v_base = (size_t)bh * tk * DV;

  int n_tiles = (tk + BK - 1) / BK;
  if (lim >= 0) n_tiles = min(n_tiles, (lim + min(q0 + BQ, tq) - 1) / BK + 1);

  cp_async_tile<DQK, NT>(qs, q + q_base, q0, tq);
  cp_async_tile<DV, NT>(gs, g + g_base, q0, tq);
  cp_async_commit();
  cp_async_tile<DQK, NT>(ks, k + k_base, 0, tk);
  cp_async_tile<DV, NT>(vs, v + v_base, 0, tk);
  cp_async_commit();

  // the thread's two q rows, m0 + gr and m0 + gr + 8: lse in log2 units
  int qpos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + m0 + gr + 8 * r;
    const bool ok = qpos[r] < tq;
    lse2[r] = ok ? lse[(size_t)bh * tq + qpos[r]] * LOG2E : 0.f;
    dl[r] = ok ? delta[(size_t)bh * tq + qpos[r]] : 0.f;
  }
  const float sl2 = scale * LOG2E;

  uint32_t qf[HOLD ? KD : 1][4], gf[HOLD ? KV : 1][4];
  if constexpr (HOLD) {
    cp_async_wait<1>();  // Q and dO are in
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < KM; ++kd) {
      if (kd < KD) ldsm_a<DQK>(qf[kd], qs, m0, 16 * kd, lane);
      if (kd < KV) ldsm_a<DV>(gf[kd], gs, m0, 16 * kd, lane);
    }
  }

  // dQ of rows m0 + gr (+ 8), columns 8 j + 2 tc (+ 1)
  float acc[DQK / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const bf16* kb = ks + (kt & 1) * MQ::ELEMS;
    const bf16* vb = vs + (kt & 1) * MV::ELEMS;
    if (kt + 1 < n_tiles) {  // into the buffer the last tile left
      cp_async_tile<DQK, NT>(ks + ((kt + 1) & 1) * MQ::ELEMS, k + k_base,
                             k0 + BK, tk);
      cp_async_tile<DV, NT>(vs + ((kt + 1) & 1) * MV::ELEMS, v + v_base,
                            k0 + BK, tk);
    }
    cp_async_commit();  // empty on the last tile, so the count stays even
    cp_async_wait<1>();
    __syncthreads();

    if constexpr (DQK == DV) {
      // S = Q K^T and dP = dO V^T: the warp's 16 rows by the tile's 64 keys
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t aq[4], ag[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int i = 0; i < 4; ++i) aq[i] = qf[kd][i], ag[i] = gf[kd][i];
        } else {
          ldsm_a<DQK>(aq, qs, m0, 16 * kd, lane);
          ldsm_a<DQK>(ag, gs, m0, 16 * kd, lane);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b[4];
          ldsm_b<DQK>(b, kb, 16 * n, 16 * kd, lane);
          mma_bf16(s[2 * n], aq, b[0], b[1]);
          mma_bf16(s[2 * n + 1], aq, b[2], b[3]);
          ldsm_b<DQK>(b, vb, 16 * n, 16 * kd, lane);
          mma_bf16(dp[2 * n], ag, b[0], b[1]);
          mma_bf16(dp[2 * n + 1], ag, b[2], b[3]);
        }
      }

      // s becomes dS = P * (dP - delta), exactly 0 where masked; a warp
      // whose 16 rows see all 64 keys unmasked skips the tests
      const bool full = q0 + m0 + 16 <= tq && k0 + BK <= tk &&
                        (lim < 0 || k0 + BK - 1 <= lim + q0 + m0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpos = k0 + 8 * j + 2 * tc + (e & 1);
          const bool keep = full || (qpos[r] < tq && kpos < tk &&
                                     (lim < 0 || kpos <= lim + qpos[r]));
          const float p = exp2f(fmaf(s[j][e], sl2, -lse2[r]));
          s[j][e] = keep ? p * (dp[j][e] - dl[r]) : 0.f;
        }
      }

      // dQ += dS K over the tile's keys, 16 at a time, dS as hi + lo
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], lo[4];
        to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
        for (int n = 0; n < DQK / 16; ++n) {
          uint32_t b[4];
          ldsm_bt<DQK>(b, kb, 16 * kk, 16 * n, lane);
          mma_bf16(acc[2 * n], hi, b[0], b[1]);
          mma_bf16(acc[2 * n], lo, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * n + 1], lo, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int c0 = 0; c0 < BK; c0 += NC) {
        // S = Q K^T and dP = dO V^T: the warp's 16 rows by NC of the
        // tile's keys
        float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KM; ++kd) {
          uint32_t aq[4], ag[4];
          if (kd < KD) ldsm_a<DQK>(aq, qs, m0, 16 * kd, lane);
          if (kd < KV) ldsm_a<DV>(ag, gs, m0, 16 * kd, lane);
#pragma unroll
          for (int n = 0; n < NC / 16; ++n) {
            uint32_t b[4];
            if (kd < KD) {
              ldsm_b<DQK>(b, kb, c0 + 16 * n, 16 * kd, lane);
              mma_bf16(s[2 * n], aq, b[0], b[1]);
              mma_bf16(s[2 * n + 1], aq, b[2], b[3]);
            }
            if (kd < KV) {
              ldsm_b<DV>(b, vb, c0 + 16 * n, 16 * kd, lane);
              mma_bf16(dp[2 * n], ag, b[0], b[1]);
              mma_bf16(dp[2 * n + 1], ag, b[2], b[3]);
            }
          }
        }

        // s becomes dS = P * (dP - delta), exactly 0 where masked; a warp
        // whose 16 rows see all 64 keys unmasked skips the tests
        const bool full = q0 + m0 + 16 <= tq && k0 + BK <= tk &&
                          (lim < 0 || k0 + BK - 1 <= lim + q0 + m0);
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kpos = k0 + c0 + 8 * j + 2 * tc + (e & 1);
            const bool keep = full || (qpos[r] < tq && kpos < tk &&
                                       (lim < 0 || kpos <= lim + qpos[r]));
            const float p = exp2f(fmaf(s[j][e], sl2, -lse2[r]));
            s[j][e] = keep ? p * (dp[j][e] - dl[r]) : 0.f;
          }
        }

        // dQ += dS K over the pass's keys, 16 at a time, dS as hi + lo
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk) {
          uint32_t hi[4], lo[4];
          to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
          for (int n = 0; n < DQK / 16; ++n) {
            uint32_t b[4];
            ldsm_bt<DQK>(b, kb, c0 + 16 * kk, 16 * n, lane);
            mma_bf16(acc[2 * n], hi, b[0], b[1]);
            mma_bf16(acc[2 * n], lo, b[0], b[1]);
            mma_bf16(acc[2 * n + 1], hi, b[2], b[3]);
            mma_bf16(acc[2 * n + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= tq) continue;
    bf16* out = dq + q_base + (size_t)qpos[r] * DQK + 2 * tc;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      store2(out + 8 * j, acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// dtype 0: f32 inputs, the CUDA-core kernel (DQK = DV only); 1: bf16,
// the tensor cores.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* delta,
                   void* dq, int bh, int tq, int tk, int causal, int off,
                   float scale, int dtype, cudaStream_t stream) {
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  cudaError_t err;
  if (dtype == 0) {
    if constexpr (DQK != DV) {
      return cudaErrorInvalidValue;
    } else {
      constexpr int D = DQK;
      const int smem = 2 * (BQ + BK) * (D + 1) * (int)sizeof(float);
      err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D, float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_f32_kernel<D, float>
          <<<grid, BwdLayout<D>::THREADS, smem, stream>>>(
              static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(g),
              lse, delta, static_cast<float*>(dq), tq, tk, causal, off,
              scale);
    }
  } else {
    // Q, dO; K, V twice
    const int smem = 3 * MmaTile<DQK>::BYTES + 3 * MmaTile<DV>::BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<DQK, DV><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
        static_cast<bf16*>(dq), tq, tk, causal ? off : -1, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g and dq share it). d is the
// width of q, k and dq, dv that of v and g. seq_offset (>= 0) is the
// absolute position of query row 0 under causal masking. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* g,
                                  const void* lse, const void* delta,
                                  void* dq, int bh, int tq, int tk, int d,
                                  int dv, int causal, int seq_offset,
                                  float scale, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || seq_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 192 && dv == 128)
    return (int)launch<192, 128>(q, k, v, g, l, dl, dq, bh, tq, tk, causal, seq_offset, scale, dtype, s);
  if (d != dv) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return (int)launch<32, 32>(q, k, v, g, l, dl, dq, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    case 64: return (int)launch<64, 64>(q, k, v, g, l, dl, dq, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    case 128: return (int)launch<128, 128>(q, k, v, g, l, dl, dq, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
