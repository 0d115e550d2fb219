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
// Shapes: q (BH, Tq, Dqk), g (BH, Tq, Dv), k/dk (BH, Tk, Dqk), v/dv (BH,
// Tk, Dv), lse/delta (BH, Tq) f32; all contiguous, and for bf16 q, k, v
// and g 16-byte aligned. Any Tq and Tk; (Dqk, Dv) one of (32, 32),
// (64, 64), (128, 128) in f32 or bf16, or (192, 128) in bf16; dk/dv in
// the inputs' dtype, f32 accumulation. Causal keeps kpos <= seq_offset
// + qpos (query row i at absolute position seq_offset + i, as in the
// forward). One CTA per
// (bh, 64-row key tile); the TPU grid's sequential q axis becomes a loop
// over 64-row Q/dO tiles inside the CTA, from the first tile whose rows
// reach the key tile (q0 = floor(max(k0 - seq_offset, 0) / BQ) when
// causal); a key tile that no query reaches writes zeros. A q row at or
// past Tq, or a key at or past Tk, contributes exactly 0 (masked, never
// exp of an unloaded lse). No atomics: dQ is another kernel
// (flash_bwd_dq.cu, JAX's two-kernel split), and every sum here runs in a
// fixed order, so dK and dV are bit-equal run to run.
//
// What bounds it on the H100: each CTA reads its K/V tile once and the
// Q/dO tiles from the causal diagonal on; the function's work is 8*D
// FLOPs per (q, k) pair. In bf16 on the tensor cores that is less time
// than moving its bytes once at the training shape (B=16, H=8, T=512,
// D=64), so the function is bound by bytes; what holds a kernel back is
// getting the products onto the tensor cores at all, then feeding them
// from shared memory and keeping two f32 accumulators in registers.
//
// bf16 (flash_bwd_dkv_bf16_kernel): one warpgroup per CTA, warp w owning
// keys 16w..16w+15 of the key tile. The tiles stay bf16 in shared memory,
// rows padded by 16 bytes so ldmatrix reads are free of bank conflicts.
// K and V are loaded once (their A fragments held in registers at
// D <= 64); Q/dO tiles with their lse and delta slices are
// double-buffered, the next one's cp.async copies in flight while the
// current one's products run (16-byte copies for the tiles, 4-byte ones
// for lse and delta, whose rows need not be 16-byte aligned). S^T = K Q^T
// and dP^T = V dO^T are m16n8k16 mma.sync products with Q and dO as B
// fragments (ldmatrix), lse and delta taken by column; P^T and dS^T go to
// A fragments in registers, and dV += P^T dO, dK += dS^T Q take dO and Q
// by ldmatrix.trans. The JAX kernel carries P and dS in f32, so each
// enters its product as a bf16 hi + lo pair (two MMAs into one f32
// accumulator): one rounding to bf16 would compute another function. dK
// is scaled by `scale` at the store (JAX pre-scales q: the same value up
// to f32 rounding) and both are rounded to bf16 once. At D = 128 the two
// accumulators take 128 registers a thread, so K and V stay in shared
// memory and the q tile's scores are formed 32 columns at a time: no
// spills at any D. The kernel is a template over (DQK, DV): Q, K and dK
// are DQK wide, dO, V and dV DV wide. At (192, 128) one warp's 16 keys
// would hold 160 accumulator registers a thread (96 of dK, 64 of dV), so
// the CTA is two warpgroups: warp w owns keys 16 (w mod 4) onwards, forms
// their S^T and dP^T as at D = 128, and accumulates half of dK's and of
// dV's columns (the warpgroup w / 4's), 80 registers. The score products
// are computed twice, once in each warpgroup: a third more tensor-core
// work than one warp holding both halves, and no exchange through
// shared memory.
//
// f32 (flash_bwd_dkv_f32_kernel): the CUDA cores. K, V, Q (pre-scaled)
// and dO sit in shared memory as f32 with rows padded to D+1 floats, lse
// and delta of the q tile beside them. TPR threads share a key row
// (BwdLayout): each computes P and dS for its interleaved q columns, and
// the values reach the row's other threads by shuffles for the P^T dO
// and dS^T Q products over each thread's interleaved head dims. The dK
// and dV accumulators (2 x D / TPR floats a thread) stay in registers;
// four threads a row at D = 128 keep them under the register cap. One
// shared-memory load per FMA bounds it.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(BwdLayout<D>::THREADS)
flash_bwd_dkv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int tk, int causal,
                         int qoff, float scale) {
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
  const int qt_lo = causal ? max(k0 - qoff, 0) / BQ : 0;
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
      const bool keep =
          row_ok && qpos < tq && (!causal || kpos <= qoff + qpos);
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

constexpr int MMA_THREADS = 128;  // one warpgroup: 4 warps of 16 keys

// lim = causal ? seq_offset : -1: key j attends query row i iff lim < 0 or
// j <= lim + i. One kernel parameter (read from the constant bank) in
// place of causal and the offset keeps the register count of the kernel
// before the offset, with no spills at D = 128.

template <int DQK, int DV>
__global__ void __launch_bounds__(MMA_THREADS * (DQK == DV ? 1 : 2))
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int tq, int tk, int lim, float scale) {
  using MQ = MmaTile<DQK>;
  using MV = MmaTile<DV>;
  constexpr int SPLIT = DQK == DV ? 1 : 2;  // warpgroups; column halves
  constexpr int NT = MMA_THREADS * SPLIT;
  constexpr int KD = DQK / 16;           // k-steps of K Q^T
  constexpr int KV = DV / 16;            // k-steps of V dO^T
  constexpr int KM = KD > KV ? KD : KV;
  constexpr int DKH = DQK / SPLIT;       // dK columns a warp accumulates
  constexpr int DVH = DV / SPLIT;        // dV columns a warp accumulates
  constexpr int NM = DKH > DVH ? DKH / 16 : DVH / 16;
  constexpr bool HOLD = DQK <= 64;       // K and V A fragments in registers
  constexpr int NC = DQK <= 64 ? BQ : 32;  // q columns a score pass forms
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + MQ::ELEMS;
  bf16* qs = vs + MV::ELEMS;      // two buffers
  bf16* gs = qs + 2 * MQ::ELEMS;  // two buffers
  float* lse_s = reinterpret_cast<float*>(gs + 2 * MV::ELEMS);  // two
  float* dl_s = lse_s + 2 * BQ;                                 // two

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
  const int m0 = 16 * (SPLIT == 1 ? warp : warp & 3);  // the warp's first key
  const int dk0 = SPLIT == 1 ? 0 : (warp >> 2) * DKH;  // its dK columns
  const int dv0 = SPLIT == 1 ? 0 : (warp >> 2) * DVH;  // its dV columns
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;  // the low key tiles, heaviest, first
  const size_t q_base = (size_t)bh * tq * DQK;
  const size_t g_base = (size_t)bh * tq * DV;
  const size_t k_base = (size_t)bh * tk * DQK;
  const size_t v_base = (size_t)bh * tk * DV;
  const int n_qt = (tq + BQ - 1) / BQ;
  const int qt_lo = lim >= 0 ? max(k0 - lim, 0) / BQ : 0;

  // Q/dO tile qt and its lse and delta into buffer buf (threads 0-63
  // copy lse, 64-127 delta); the caller commits
  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    cp_async_tile<DQK, NT>(qs + buf * MQ::ELEMS, q + q_base, q0, tq);
    cp_async_tile<DV, NT>(gs + buf * MV::ELEMS, g + g_base, q0, tq);
    if (SPLIT == 1 || threadIdx.x < 2 * BQ) {
      const int i = threadIdx.x & (BQ - 1);
      const bool ok = q0 + i < tq;
      const float* src = threadIdx.x < BQ ? lse : delta;
      cp_async4((threadIdx.x < BQ ? lse_s : dl_s) + buf * BQ + i,
                src + (size_t)bh * tq + (ok ? q0 + i : 0), ok);
    }
  };

  cp_async_tile<DQK, NT>(ks, k + k_base, k0, tk);
  cp_async_tile<DV, NT>(vs, v + v_base, k0, tk);
  cp_async_commit();
  if (qt_lo < n_qt) load_q(qt_lo, 0);
  cp_async_commit();

  int kpos[2];  // the thread's two keys, m0 + gr and m0 + gr + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + m0 + gr + 8 * r;
  const float sl2 = scale * LOG2E;

  uint32_t kf[HOLD ? KD : 1][4], vf[HOLD ? KV : 1][4];
  if constexpr (HOLD) {
    cp_async_wait<1>();  // K and V are in
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < KM; ++kd) {
      if (kd < KD) ldsm_a<DQK>(kf[kd], ks, m0, 16 * kd, lane);
      if (kd < KV) ldsm_a<DV>(vf[kd], vs, m0, 16 * kd, lane);
    }
  }

  // dK and dV of keys m0 + gr (+ 8), the warp's columns 8 j + 2 tc (+ 1)
  float acc_dk[DKH / 8][4], acc_dv[DVH / 8][4];
#pragma unroll
  for (int j = 0; j < DKH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DVH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[j][e] = 0.f;

  for (int qt = qt_lo; qt < n_qt; ++qt) {
    const int buf = (qt - qt_lo) & 1;
    const int q0 = qt * BQ;
    if (qt + 1 < n_qt) load_q(qt + 1, buf ^ 1);  // the buffer last left
    cp_async_commit();  // empty on the last tile, so the count stays even
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qb = qs + buf * MQ::ELEMS;
    const bf16* gb = gs + buf * MV::ELEMS;
    const float* lb = lse_s + buf * BQ;
    const float* db = dl_s + buf * BQ;
    // a warp whose 16 keys see all 64 q rows unmasked skips the tests
    const bool full = k0 + m0 + 16 <= tk && q0 + BQ <= tq &&
                      (lim < 0 || k0 + m0 + 15 <= lim + q0);

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += NC) {
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by NC q rows
      float st[NC / 8][4], dpt[NC / 8][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KM; ++kd) {
        uint32_t ak[4], av[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (kd < KD) ak[i] = kf[kd][i];
            if (kd < KV) av[i] = vf[kd][i];
          }
        } else {
          if (kd < KD) ldsm_a<DQK>(ak, ks, m0, 16 * kd, lane);
          if (kd < KV) ldsm_a<DV>(av, vs, m0, 16 * kd, lane);
        }
#pragma unroll
        for (int n = 0; n < NC / 16; ++n) {
          uint32_t b[4];
          if (kd < KD) {
            ldsm_b<DQK>(b, qb, c0 + 16 * n, 16 * kd, lane);
            mma_bf16(st[2 * n], ak, b[0], b[1]);
            mma_bf16(st[2 * n + 1], ak, b[2], b[3]);
          }
          if (kd < KV) {
            ldsm_b<DV>(b, gb, c0 + 16 * n, 16 * kd, lane);
            mma_bf16(dpt[2 * n], av, b[0], b[1]);
            mma_bf16(dpt[2 * n + 1], av, b[2], b[3]);
          }
        }
      }

      // st becomes P^T and dpt dS^T = P^T * (dP^T - delta), exactly 0
      // where masked; lse and delta by column
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = c0 + 8 * j + 2 * tc;
        const float2 l2 = *reinterpret_cast<const float2*>(lb + col);
        const float2 d2 = *reinterpret_cast<const float2*>(db + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qpos = q0 + col + (e & 1);
          const bool keep = full || (qpos < tq && kpos[r] < tk &&
                                     (lim < 0 || kpos[r] <= lim + qpos));
          const float lc = (e & 1) ? l2.y : l2.x;
          const float dc = (e & 1) ? d2.y : d2.x;
          const float p = exp2f(fmaf(st[j][e], sl2, -lc * LOG2E));
          dpt[j][e] = keep ? p * (dpt[j][e] - dc) : 0.f;
          st[j][e] = keep ? p : 0.f;
        }
      }

      // dV += P^T dO and dK += dS^T Q over the pass's q rows, 16 at a
      // time, P^T and dS^T as hi + lo, into the warp's columns
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        to_a_split(st[2 * kk], st[2 * kk + 1], ph, pl);
        to_a_split(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
        for (int n = 0; n < NM; ++n) {
          uint32_t b[4];
          if (n < DVH / 16) {
            ldsm_bt<DV>(b, gb, c0 + 16 * kk, dv0 + 16 * n, lane);
            mma_bf16(acc_dv[2 * n], ph, b[0], b[1]);
            mma_bf16(acc_dv[2 * n], pl, b[0], b[1]);
            mma_bf16(acc_dv[2 * n + 1], ph, b[2], b[3]);
            mma_bf16(acc_dv[2 * n + 1], pl, b[2], b[3]);
          }
          if (n < DKH / 16) {
            ldsm_bt<DQK>(b, qb, c0 + 16 * kk, dk0 + 16 * n, lane);
            mma_bf16(acc_dk[2 * n], sh, b[0], b[1]);
            mma_bf16(acc_dk[2 * n], sl, b[0], b[1]);
            mma_bf16(acc_dk[2 * n + 1], sh, b[2], b[3]);
            mma_bf16(acc_dk[2 * n + 1], sl, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= tk) continue;
    const size_t kofs = k_base + (size_t)kpos[r] * DQK + dk0 + 2 * tc;
    const size_t vofs = v_base + (size_t)kpos[r] * DV + dv0 + 2 * tc;
#pragma unroll
    for (int j = 0; j < NM * 2; ++j) {
      if (j < DKH / 8)
        store2(dk + kofs + 8 * j, acc_dk[j][2 * r] * scale,
               acc_dk[j][2 * r + 1] * scale);
      if (j < DVH / 8)
        store2(dv + vofs + 8 * j, acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
    }
  }
}

// dtype 0: f32 inputs, the CUDA-core kernel (DQK = DV only); 1: bf16,
// the tensor cores.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const float* lse, const float* delta,
                   void* dk, void* dv, int bh, int tq, int tk, int causal,
                   int qoff, float scale, int dtype, cudaStream_t stream) {
  const dim3 grid((tk + BK - 1) / BK, bh);
  cudaError_t err;
  if (dtype == 0) {
    if constexpr (DQK != DV) {
      return cudaErrorInvalidValue;
    } else {
      constexpr int D = DQK;
      const int smem =
          (2 * (BQ + BK) * (D + 1) + 2 * BQ) * (int)sizeof(float);
      err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D, float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_f32_kernel<D, float>
          <<<grid, BwdLayout<D>::THREADS, smem, stream>>>(
              static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(g),
              lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
              tq, tk, causal, qoff, scale);
    }
  } else {
    // K, V; Q, dO twice; lse, delta twice
    const int smem = 3 * MmaTile<DQK>::BYTES + 3 * MmaTile<DV>::BYTES +
                     4 * BQ * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<DQK, DV>
        <<<grid, MMA_THREADS * (DQK == DV ? 1 : 2), smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse,
            delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk,
            causal ? qoff : -1, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dk and dv share it). d
// is the width of q, k and dk, dv that of v, g and dv. seq_offset (>= 0)
// is the absolute position of query row 0 under causal masking. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int bh, int tq,
                                   int tk, int d, int dvw, int causal,
                                   int seq_offset, float scale, int dtype,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || seq_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 192 && dvw == 128)
    return (int)launch<192, 128>(q, k, v, g, l, dl, dk, dv, bh, tq, tk, causal, seq_offset, scale, dtype, s);
  if (d != dvw) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return (int)launch<32, 32>(q, k, v, g, l, dl, dk, dv, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    case 64: return (int)launch<64, 64>(q, k, v, g, l, dl, dk, dv, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    case 128: return (int)launch<128, 128>(q, k, v, g, l, dl, dk, dv, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
