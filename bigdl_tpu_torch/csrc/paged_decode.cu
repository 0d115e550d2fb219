// Paged flash-decode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/decode_attention.py::_decode_kernel
// (launched by _pallas). One query token per slot attends over that
// slot's KV pages, read through the page table, with the mask
// pos <= length; the output is softmax(scale * q K^T) V.
//
// Shapes: q/out (B, H, Dh); kp/vp (num_pages, H, P, Dh) (one layer's
// pool); tables (B, maxp) int32; lengths (B,) int32. Dh in {32, 64, 128};
// q and the cache each f32 or bf16; f32 (m, l, acc); output in q's dtype.
//
// What bounds it on the H100: device-memory bytes. Each live K/V row is
// read once for 4*Dh FLOPs, about 1 FLOP per byte in f32, far below the
// card's ~20 FLOP/byte f32 balance point. The design reads nothing it
// does not need: no gathered copy of the pages (the dense path writes and
// re-reads one), and only the length // P + 1 live pages of each slot,
// so the trash page 0 and unallocated pages are never read.
//
// Design: one CTA of 4 warps per (slot, head). There is no scalar
// prefetch on Hopper, so the CTA reads its own page ids from the table.
// Each warp takes 32 consecutive positions at a time: every lane computes
// the score of one key row (vectorised 16-byte loads along Dh), the warp
// folds the 32 scores into its running (m, l) with two reductions, then
// accumulates the value rows, each lane owning Dh/32 dims so the row is
// read coalesced. The four warps' partial states are merged through
// shared memory at the end. With few slots, B*H CTAs do not fill the 132
// SMs; splitting the KV across CTAs (flash-decoding) is a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// four consecutive elements as floats (p is 4-element aligned)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int P, int maxp, float scale) {
  constexpr int PER_LANE = D / 32;
  __shared__ float qs[D];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ float wacc[WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qoff = ((size_t)b * H + h) * D;

  for (int i = tid; i < D; i += THREADS) qs[i] = to_f32(q[qoff + i]) * scale;
  __syncthreads();

  // positions 0..length attend; the table addresses at most maxp pages
  const int npos = max(0, min(lengths[b] + 1, maxp * P));
  const int* trow = tables + (size_t)b * maxp;

  float m = -INFINITY, l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  for (int c0 = warp * 32; c0 < npos; c0 += WARPS * 32) {
    const int pos = c0 + lane;
    float s = -INFINITY;
    unsigned long long row = 0;  // element offset of this lane's K/V row
    if (pos < npos) {
      const int page = trow[pos / P];
      row = (((unsigned long long)page * H + h) * P + (pos % P)) * D;
      const TKV* kr = kp + row;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float kx[4];
        load4(kr + d, kx);
        dot = fmaf(qs[d], kx[0], dot);
        dot = fmaf(qs[d + 1], kx[1], dot);
        dot = fmaf(qs[d + 2], kx[2], dot);
        dot = fmaf(qs[d + 3], kx[3], dot);
      }
      s = dot;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float shift = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - shift);
    const float p = expf(s - shift);  // 0 for masked lanes
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= alpha;
    const int n = min(32, npos - c0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
      const unsigned long long rj = __shfl_sync(FULL, row, j);
      const TKV* vr = vp + rj;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        acc[i] = fmaf(pj, to_f32(vr[lane + 32 * i]), acc[i]);
    }
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) wacc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  for (int d = tid; d < D; d += THREADS) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w]);
    const float shift = (mx == -INFINITY) ? 0.f : mx;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float sc = (wm[w] == -INFINITY) ? 0.f : expf(wm[w] - shift);
      lsum = fmaf(wl[w], sc, lsum);
      a = fmaf(wacc[w][d], sc, a);
    }
    store(out + qoff + d, a / fmaxf(lsum, 1e-30f));
  }
}

template <int D, typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lengths, void* out, int b,
                   int h, int page_size, int maxp, float scale,
                   cudaStream_t stream) {
  const dim3 grid(h, b);
  paged_decode_kernel<D, TQ, TKV><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), tables, lengths, static_cast<TQ*>(out), h,
      page_size, maxp, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* lengths, void* out,
                       int b, int h, int d, int page_size, int maxp,
                       float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, TQ, TKV>(q, kp, vp, tables, lengths, out, b, h, page_size, maxp, scale, s);
    case 64: return launch<64, TQ, TKV>(q, kp, vp, tables, lengths, out, b, h, page_size, maxp, scale, s);
    case 128: return launch<128, TQ, TKV>(q, kp, vp, tables, lengths, out, b, h, page_size, maxp, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bigdl_paged_decode(const void* q, const void* kp,
                                  const void* vp, const void* tables,
                                  const void* lengths, void* out, int b,
                                  int h, int d, int page_size, int maxp,
                                  float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || page_size <= 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)dispatch_d<float, float>(q, kp, vp, t, len, out, b, h, d, page_size, maxp, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)dispatch_d<float, __nv_bfloat16>(q, kp, vp, t, len, out, b, h, d, page_size, maxp, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)dispatch_d<__nv_bfloat16, float>(q, kp, vp, t, len, out, b, h, d, page_size, maxp, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, t, len, out, b, h, d, page_size, maxp, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
