// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by _flash_forward). It computes O = softmax(scale * Q K^T) V
// with an online softmax, and optionally the per-row logsumexp in
// scaled-score units for a later blockwise backward.
//
// Shapes: q (BH, Tq, Dqk), k (BH, Tk, Dqk), v (BH, Tk, Dv), o (BH, Tq,
// Dv), lse (BH, Tq) f32; all contiguous, and for bf16 q, k and v 16-byte
// aligned. Any Tq and Tk (ragged tiles are masked); (Dqk, Dv) one of
// (32, 32), (64, 64), (128, 128) in f32 or bf16, or (192, 128) in bf16
// (latent attention: 128 + 64 rotary dims of q.k, values of 128); f32
// accumulation. Causal masking keeps kpos <= seq_offset + qpos: query
// row i sits at absolute position seq_offset + i of the kv sequence
// (chunked causal attention; JAX's _mask_causal). One CTA per (bh,
// 64-row q tile); the TPU grid's sequential kv axis becomes a loop inside
// the CTA over 64-row K/V tiles, up to the causal diagonal only
// (_diag_kblocks: ceil((seq_offset + last row + 1) / 64) tiles, clamped
// to Tk's). Fully masked rows keep a shift of 0 and the denominator is
// clamped at 1e-30, as in the JAX reference.
//
// What bounds it on the H100: each CTA reads its Q tile once and the K/V
// tiles up to the causal diagonal; the work is 4*D FLOPs per (q, k) pair
// against 2*D*itemsize bytes per key. At the training shape (B=16, H=8,
// T=512, D=64, bf16) the bytes take longer than the tensor cores' share
// of the operations, so the function is bound by bytes; at T=4096 by
// operations. What holds a kernel back is getting the products onto the
// tensor cores at all, then the softmax's exponentials between them.
//
// bf16 (flash_fwd_bf16_kernel): one warpgroup per CTA, warp w owning q
// rows 16w..16w+15. Q is loaded once by 16-byte cp.async and its A
// fragments are held in registers; K/V tiles are double-buffered, the
// next one's copies in flight while the current one's products run. S =
// Q K^T is an m16n8k16 mma.sync product with K as the B operand
// (ldmatrix); scale and log2 e multiply the f32 scores, and the online
// softmax runs on the accumulator fragments (row max and sum across each
// quad by two shuffles, exp2f). The JAX kernel multiplies P in f32 by V
// in f32, so P enters P V as a bf16 hi + lo pair (two MMAs into one f32
// accumulator, V by ldmatrix.trans): one rounding of P to bf16 would
// compute another function. O / l is rounded to bf16 once, at the store;
// lse = m + log(l) goes back to natural units. The causal tiles run
// heaviest first. The kernel is a template over (DQK, DV): the Q and K
// tiles are DQK wide, the V tile and O DV wide. Q's A fragments stay in
// registers up to DQK = 128; at DQK = 192 they would take 48 more
// registers beside O's 64, so they are read from shared memory again
// for each K tile.
//
// f32 (flash_fwd_f32_kernel): the CUDA cores. Q (pre-scaled), K and V
// tiles sit in shared memory as f32 with rows padded to D+1 floats, so
// neither the row-per-thread reads nor the column reads conflict on
// banks. Two threads share a q row: each computes 32 interleaved score
// columns and accumulates half of the head dims; the row max and row sum
// are combined with one shuffle. The (m, l, acc) state stays in
// registers. One shared-memory load per FMA bounds it.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int THREADS = 128;  // two threads per q row

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int causal,
                     int off, float scale) {
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
    const int last_q = off + min(q0 + BQ, tq) - 1;
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
      const bool keep = kpos < tk && (!causal || kpos <= off + qpos);
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

constexpr int MMA_THREADS = 128;  // one warpgroup: 4 warps of 16 q rows

// lim = causal ? seq_offset : -1: key j attends query row i iff lim < 0 or
// j <= lim + i. One kernel parameter (read from the constant bank) in
// place of causal and the offset, as in the backward kernels.

template <int DQK, int DV>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int lim,
                      float scale) {
  using MQ = MmaTile<DQK>;
  using MV = MmaTile<DV>;
  constexpr int NT = MMA_THREADS;
  constexpr int KD = DQK / 16;       // k-steps of Q K^T
  constexpr bool HOLD = DQK <= 128;  // Q's A fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + MQ::ELEMS;      // two buffers
  bf16* vs = ks + 2 * MQ::ELEMS;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row, column pair
  const int m0 = 16 * warp;                 // the warp's first tile row
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const size_t q_base = (size_t)bh * tq * DQK;
  const size_t k_base = (size_t)bh * tk * DQK;
  const size_t v_base = (size_t)bh * tk * DV;
  const size_t o_base = (size_t)bh * tq * DV;

  int n_tiles = (tk + BK - 1) / BK;
  if (lim >= 0) n_tiles = min(n_tiles, (lim + min(q0 + BQ, tq) - 1) / BK + 1);

  cp_async_tile<DQK, NT>(qs, q + q_base, q0, tq);
  cp_async_commit();
  cp_async_tile<DQK, NT>(ks, k + k_base, 0, tk);
  cp_async_tile<DV, NT>(vs, v + v_base, 0, tk);
  cp_async_commit();

  // the thread's two q rows, m0 + gr and m0 + gr + 8; (m, l) of each in
  // log2 units of the scaled scores
  int qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + m0 + gr + 8 * r;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const float sl2 = scale * LOG2E;

  // without HOLD, the first tile's wait below finds Q in as well
  uint32_t qf[HOLD ? KD : 1][4];
  if constexpr (HOLD) {
    cp_async_wait<1>();  // Q is in
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm_a<DQK>(qf[kd], qs, m0, 16 * kd, lane);
  }

  // O of rows m0 + gr (+ 8), columns 8 j + 2 tc (+ 1)
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
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

    // S = Q K^T: the warp's 16 rows by the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t fresh[4];
      if constexpr (!HOLD) ldsm_a<DQK>(fresh, qs, m0, 16 * kd, lane);
      const uint32_t(&aq)[4] = HOLD ? qf[kd] : fresh;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t b[4];
        ldsm_b<DQK>(b, kb, 16 * n, 16 * kd, lane);
        mma_bf16(s[2 * n], aq, b[0], b[1]);
        mma_bf16(s[2 * n + 1], aq, b[2], b[3]);
      }
    }

    // scaled scores in log2 units, -inf where masked; a warp whose 16
    // rows see all 64 keys unmasked skips the tests
    const bool full =
        k0 + BK <= tk && (lim < 0 || k0 + BK - 1 <= lim + q0 + m0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + 2 * tc + (e & 1);
        const bool keep =
            full || (kpos < tk && (lim < 0 || kpos <= lim + qpos[r]));
        s[j][e] = keep ? s[j][e] * sl2 : -INFINITY;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float shift[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with nothing unmasked yet keeps m = -inf: shift by 0
      shift[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = (m[r] == -INFINITY) ? 0.f : exp2f(m[r] - shift[r]);
      m[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - shift[e >> 1]);
        rsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(FULL, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(FULL, rsum[r], 2);
      l[r] = l[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V over the tile's keys, 16 at a time, P as hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        uint32_t b[4];
        ldsm_bt<DV>(b, vb, 16 * kk, 16 * n, lane);
        mma_bf16(acc[2 * n], hi, b[0], b[1]);
        mma_bf16(acc[2 * n], lo, b[0], b[1]);
        mma_bf16(acc[2 * n + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * n + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    bf16* out = o + o_base + (size_t)qpos[r] * DV + 2 * tc;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      store2(out + 8 * j, acc[j][2 * r] / lc, acc[j][2 * r + 1] / lc);
    if (lse != nullptr && tc == 0)
      lse[(size_t)bh * tq + qpos[r]] = m[r] / LOG2E + logf(lc);
  }
}

// dtype 0: f32 inputs, the CUDA-core kernel (DQK = DV only); 1: bf16,
// the tensor cores.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int tq, int tk, int causal, int off,
                   float scale, int dtype, cudaStream_t stream) {
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  cudaError_t err;
  if (dtype == 0) {
    if constexpr (DQK != DV) {
      return cudaErrorInvalidValue;
    } else {
      constexpr int D = DQK;
      const int smem = 3 * BQ * (D + 1) * (int)sizeof(float);
      err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      flash_fwd_f32_kernel<D, float><<<grid, THREADS, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse, tq, tk,
          causal, off, scale);
    }
  } else {
    // Q; K, V twice
    const int smem = 3 * MmaTile<DQK>::BYTES + 2 * MmaTile<DV>::BYTES;
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<DQK, DV><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, tq, tk,
        causal ? off : -1, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). d is the
// width of q and k, dv that of v and o. seq_offset (>= 0) is the absolute
// position of query row 0 under causal masking. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int tq, int tk,
                               int d, int dv, int causal, int seq_offset,
                               float scale, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || seq_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 192 && dv == 128)
    return (int)launch<192, 128>(q, k, v, o, l, bh, tq, tk, causal, seq_offset, scale, dtype, s);
  if (d != dv) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return (int)launch<32, 32>(q, k, v, o, l, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    case 64: return (int)launch<64, 64>(q, k, v, o, l, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    case 128: return (int)launch<128, 128>(q, k, v, o, l, bh, tq, tk, causal, seq_offset, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
