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
// so the trash page 0 and unallocated pages are never read. At the
// serving batch (B = 8, H = 8) one CTA per (slot, head) would fill under
// half of the 132 SMs and walk its pages one after another, so the kernel
// is bound by latency unless the KV is split across CTAs.
//
// Design (flash-decoding): the grid is (H, B, S). Split s of a slot takes
// its live table columns [s * cps, min((s + 1) * cps, live)), cps =
// ceil(live / S); a split past them reads nothing and writes m = -inf,
// l = 0. There is no scalar prefetch on Hopper, so a CTA reads its own
// page ids from the table. A CTA's four warps take the split's pages in
// turn, in units of up to 16 rows of one page: each warp streams its
// units' K and V tiles (rows x Dh) into its own two shared-memory buffers
// by 16-byte cp.async, the next unit in flight while it works on this
// one. Lane l scores row l % 16 over half l / 16 of Dh (vector loads from
// shared memory, rows padded by 16 bytes: no bank conflicts), one shuffle
// joins the halves, the warp folds the 16 scores into its running
// (m, l) by two 4-step reductions, and takes P V from shared memory, each
// lane owning Dh / 32 dims. The CTA merges its warps' states in fixed
// order and writes its partial (acc[Dh], m, l) in f32 to scratch
// (B, H, S, Dh + 2); a second small kernel merges each (slot, head)'s S
// partials in fixed order and writes acc / max(l, 1e-30) in q's dtype.
// With S = 1 the first kernel writes that output itself. No atomics: the
// output is bit-equal run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;  // key rows of a unit: lane l scores row l % ROWS
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the 16 bytes at p as floats: 4 of f32, 8 of bf16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the sum and max over the 16 rows (lanes l and l ^ 16 hold one row)
__device__ __forceinline__ float rows_max(float x) {
#pragma unroll
  for (int o = 1; o < ROWS; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float rows_sum(float x) {
#pragma unroll
  for (int o = 1; o < ROWS; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// a K or V tile of ROWS rows of Dh elements of T
template <int D, typename T>
struct Tile {
  static constexpr int LD = D + 16 / (int)sizeof(T);  // padded by 16 bytes
  static constexpr int ELEMS = ROWS * LD;
  // dynamic shared memory: per warp two buffers of a K and a V tile
  static constexpr int SMEM_BYTES = WARPS * 2 * 2 * ELEMS * (int)sizeof(T);
};

// grid (H, B, S). part (B, H, S, D + 2) f32 when S > 1: split s's
// acc[D], m, l.
template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    float* __restrict__ part, int H, int P, int maxp,
                    float scale) {
  constexpr int LD = Tile<D, TKV>::LD;
  constexpr int TILE = Tile<D, TKV>::ELEMS;
  constexpr int PER_LANE = D / 32;        // dims of acc a lane owns
  constexpr int VW = 16 / sizeof(TKV);    // elements of a 16-byte piece
  constexpr int HALF = D / 2;             // dims a lane scores
  constexpr int ROW_PIECES = D / VW;      // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float qs[D];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ float wacc[WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qoff = ((size_t)b * H + h) * D;

  for (int i = tid; i < D; i += THREADS) qs[i] = to_f32(q[qoff + i]) * scale;

  // positions 0..length attend; the table addresses at most maxp pages
  const int npos = max(0, min(lengths[b] + 1, maxp * P));
  const int live = (npos + P - 1) / P;
  const int cps = (live + nsplit - 1) / nsplit;
  const int c0 = min(split * cps, live), c1 = min(c0 + cps, live);
  // units: up to ROWS rows of one page, in position order; those that
  // start before npos
  const int upp = (P + ROWS - 1) / ROWS;  // units per page
  const int pos_end = min(c1 * P, npos);
  int units = 0;
  if (c1 > c0)
    units = (c1 - 1 - c0) * upp + (pos_end - (c1 - 1) * P + ROWS - 1) / ROWS;
  const int* trow = tables + (size_t)b * maxp;

  TKV* kt = reinterpret_cast<TKV*>(smem_raw) + warp * 4 * TILE;
  // buffer j: K at kt + 2 j TILE, V after it

  // unit u of this CTA: column c0 + u / upp, rows r0 .. r0 + nrows - 1
  // of that page
  auto first_row = [&](int u) { return (u % upp) * ROWS; };
  auto live_rows = [&](int u) {
    const int r0 = first_row(u);
    return min(min(ROWS, P - r0), npos - (c0 + u / upp) * P - r0);
  };
  auto fetch = [&](int u, int buf) {
    const int r0 = first_row(u), nrows = live_rows(u);
    const size_t row = ((size_t)trow[c0 + u / upp] * H + h) * P + r0;
    const TKV* ksrc = kp + row * D;
    const TKV* vsrc = vp + row * D;
    TKV* kd = kt + 2 * buf * TILE;
    TKV* vd = kd + TILE;
    for (int i = lane; i < nrows * ROW_PIECES; i += 32) {
      const int r = i / ROW_PIECES, pc = i - r * ROW_PIECES;
      cp_async16(kd + r * LD + pc * VW, ksrc + r * D + pc * VW);
      cp_async16(vd + r * LD + pc * VW, vsrc + r * D + pc * VW);
    }
  };

  float m = -INFINITY, l = 0.f;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;
  __syncthreads();  // qs

  const int row = lane % ROWS, hf = lane / ROWS;
  int k = 0;
  if (warp < units) fetch(warp, 0);
  cp_async_commit();
  for (int u = warp; u < units; u += WARPS, ++k) {
    if (u + WARPS < units) fetch(u + WARPS, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // unit u has landed
    __syncwarp();
    const int nrows = live_rows(u);
    const TKV* kr = kt + 2 * (k & 1) * TILE;
    const TKV* vr = kr + TILE;

    float dot = 0.f;
    const TKV* kx = kr + row * LD + hf * HALF;
    const float* qx = qs + hf * HALF;
#pragma unroll
    for (int d = 0; d < HALF; d += VW) {
      float kv[VW];
      load16(kx + d, kv);
#pragma unroll
      for (int e = 0; e < VW; ++e) dot = fmaf(qx[d + e], kv[e], dot);
    }
    dot += __shfl_xor_sync(FULL, dot, ROWS);
    const bool valid = row < nrows;
    const float s = valid ? dot : -INFINITY;
    const float m_new = fmaxf(m, rows_max(s));
    const float shift = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - shift);
    const float p = valid ? expf(s - shift) : 0.f;
    l = l * alpha + rows_sum(p);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) acc[i] *= alpha;
    for (int j = 0; j < nrows; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
      const TKV* vj = vr + j * LD;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        acc[i] = fmaf(pj, to_f32(vj[lane + 32 * i]), acc[i]);
    }
    m = m_new;
    __syncwarp();  // this buffer is read before the next fetch reuses it
  }
  cp_async_wait<0>();

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) wacc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  // the warps' states in fixed order
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w]);
  const float shift = (mx == -INFINITY) ? 0.f : mx;
  float sc[WARPS], lsum = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    sc[w] = (wm[w] == -INFINITY) ? 0.f : expf(wm[w] - shift);
    lsum = fmaf(wl[w], sc[w], lsum);
  }
  float* pp = nsplit == 1 ? nullptr
                          : part + (((size_t)b * H + h) * nsplit + split) *
                                       (D + 2);
  for (int d = tid; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(wacc[w][d], sc[w], a);
    if (nsplit == 1)
      store(out + qoff + d, a / fmaxf(lsum, 1e-30f));
    else
      pp[d] = a;
  }
  if (nsplit > 1 && tid == 0) {
    pp[D] = mx;
    pp[D + 1] = lsum;
  }
}

// grid (H, B): the S partials of one (slot, head) in fixed order
template <int D, typename TQ>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                          int H, int S) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* pp = part + ((size_t)b * H + h) * S * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, pp[s * (D + 2) + D]);
  const float shift = (mx == -INFINITY) ? 0.f : mx;
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ms = pp[s * (D + 2) + D];
    const float sc = (ms == -INFINITY) ? 0.f : expf(ms - shift);
    lsum = fmaf(pp[s * (D + 2) + D + 1], sc, lsum);
    a = fmaf(pp[s * (D + 2) + d], sc, a);
  }
  store(out + ((size_t)b * H + h) * D + d, a / fmaxf(lsum, 1e-30f));
}

template <int D, typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lengths, void* out,
                   float* part, int b, int h, int page_size, int maxp,
                   int splits, float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<D, TQ, TKV>;
  constexpr int smem = Tile<D, TKV>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(h, b, splits), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), tables, lengths, static_cast<TQ*>(out),
      part, h, page_size, maxp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_decode_merge_kernel<D, TQ><<<dim3(h, b), D, 0, stream>>>(
      part, static_cast<TQ*>(out), h, splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* lengths, void* out,
                       float* part, int b, int h, int d, int page_size,
                       int maxp, int splits, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, TQ, TKV>(q, kp, vp, tables, lengths, out, part, b, h, page_size, maxp, splits, scale, s);
    case 64: return launch<64, TQ, TKV>(q, kp, vp, tables, lengths, out, part, b, h, page_size, maxp, splits, scale, s);
    case 128: return launch<128, TQ, TKV>(q, kp, vp, tables, lengths, out, part, b, h, page_size, maxp, splits, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16. part: (B, H, splits,
// d + 2) f32 scratch, unused when splits is 1. kp and vp 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int bigdl_paged_decode(const void* q, const void* kp,
                                  const void* vp, const void* tables,
                                  const void* lengths, void* out, void* part,
                                  int b, int h, int d, int page_size,
                                  int maxp, int splits, float scale,
                                  int q_dtype, int kv_dtype, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || page_size <= 0 || maxp <= 0 ||
      splits <= 0 || splits > 65535 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)dispatch_d<float, float>(q, kp, vp, t, len, out, pt, b, h, d, page_size, maxp, splits, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)dispatch_d<float, __nv_bfloat16>(q, kp, vp, t, len, out, pt, b, h, d, page_size, maxp, splits, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)dispatch_d<__nv_bfloat16, float>(q, kp, vp, t, len, out, pt, b, h, d, page_size, maxp, splits, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, t, len, out, pt, b, h, d, page_size, maxp, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
