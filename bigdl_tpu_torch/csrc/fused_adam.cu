// Multi-tensor fused Adam update for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel. The JAX package's update (Adam.step in
// bigdl_tpu/optim/optim_method.py, with the clipper and the non-finite
// guard of bigdl_tpu/optim/optimizer.py) is one jitted function, which
// XLA fuses. Run eagerly, a tensor at a time, the same update costs
// about 27 launches for each parameter tensor (10,527 a step over
// GPT-2-medium's 389) and some 50 passes over device memory. This source
// does it in two launches over every tensor at once.
//
// Pass 1 (statistics) reads each gradient, applies the constant clip if
// one is set, and forms partial sums of g*g and a non-finite flag for
// each block. The last block to finish (a ticket counter; no float
// atomics) sums the partials in a fixed order and writes the clip scale
// min(clip / (sqrt(sum) + 1e-12), 1) and ok (every clipped gradient and
// the loss finite) to the buffer's header.
// Pass 2 (apply) reads g, m, v and p once and, only where ok holds (or
// always, without the guard), writes m, v and p in place; a frozen
// tensor's m and v step and its p is neither read nor written.
//
// What bounds it on the H100: device-memory bytes. Pass 2 reads 16 B and
// writes 12 B an element, pass 1 reads 4 B: 32 B x 406.3M values =
// 13.0 GB for GPT-2-medium, 3.9 ms at 3.35 TB/s, with ~0.5 FLOP a byte.
// The design reads m, v and p once and g twice, with 16-byte loads and
// stores wherever all of a tensor's pointers are 16-byte aligned, over
// a grid of a few blocks on each SM that strides over 4096-element
// chunks of the concatenated tensors.
//
// Numerics: each element takes the operations of the per-tensor path
// (_GradClipper, then Adam.step) in their order, each rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction),
// with lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t read from the 0-d device
// tensors that the same torch ops made. Given the same clip scale, an
// element's m, v and p are bit-equal to the per-tensor path's. Only the
// norm's order of summation differs; it is fixed, so two runs on the
// same input give the same bits.
//
// The buffer (int64 words, filled by bigdl_tpu_torch/ops/fused_update.py
// and copied to the device before pass 1):
//   words [0, 8)             header: u32 ticket, f32 scale, u8 ok
//   words [8, 8 + 8n)        n entries: g, p, m, v, numel, first chunk,
//                            flags (1 frozen, 2 all four 16-B aligned)
//   then grid f32 partial sums and grid i32 non-finite flags (pass 1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long CHUNK = 4096;  // ops/fused_update.py CHUNK
constexpr unsigned FULL = 0xffffffffu;

// flags of the call (ops/fused_update.py keeps the same numbers)
constexpr int CONST_CLIP = 1;
constexpr int L2_CLIP = 2;
constexpr int GATE = 4;
// flags of an entry
constexpr long long FROZEN = 1;
constexpr long long ALIGNED = 2;

struct Header {
  unsigned int ticket;
  float scale;
  unsigned char ok;
  unsigned char pad[55];
};
static_assert(sizeof(Header) == 64, "the header is 8 words");

struct Entry {
  long long g, p, m, v, n, first, flags, pad;
};
static_assert(sizeof(Entry) == 64, "an entry is 8 words");

struct Coef {
  float scale, lr, bc1, bc2, b1, c1, b2, c2, eps, lo, hi;
  bool cclip, l2;
};

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// the entry that holds chunk c, scanning forward from entry t (a block's
// chunks only grow)
__device__ __forceinline__ int entry_of(const Entry* __restrict__ tab,
                                        int nt, int t, long long c) {
  while (t + 1 < nt && __ldg(&tab[t + 1].first) <= c) ++t;
  return t;
}

__device__ __forceinline__ void stat(float x, bool cclip, float lo,
                                     float hi, float& acc, int& bad) {
  if (cclip) x = clampf(x, lo, hi);
  bad |= !isfinite(x);
  acc = __fadd_rn(acc, __fmul_rn(x, x));
}

// sum over the block in a fixed order; the result in thread 0
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(FULL, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < WARPS ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(FULL, x, o));
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
    stats_kernel(const Entry* __restrict__ tab, int nt, long long nchunks,
                 float* part, int* bad_part, Header* hdr,
                 const float* __restrict__ loss, float clip, float lo,
                 float hi, int flags) {
  __shared__ float red[WARPS];
  __shared__ bool last;
  const bool cclip = flags & CONST_CLIP;
  float acc = 0.f;
  int bad = 0;
  int t = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    t = entry_of(tab, nt, t, c);
    const Entry e = tab[t];
    const long long base = (c - e.first) * CHUNK;
    const int len = (int)min(CHUNK, e.n - base);
    const float* g = reinterpret_cast<const float*>(e.g) + base;
    int i = threadIdx.x;
    if (e.flags & ALIGNED) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (; i < (len >> 2); i += THREADS) {
        const float4 x = g4[i];
        stat(x.x, cclip, lo, hi, acc, bad);
        stat(x.y, cclip, lo, hi, acc, bad);
        stat(x.z, cclip, lo, hi, acc, bad);
        stat(x.w, cclip, lo, hi, acc, bad);
      }
      i = ((len >> 2) << 2) + threadIdx.x;
    }
    for (; i < len; i += THREADS) stat(g[i], cclip, lo, hi, acc, bad);
  }
  acc = block_sum(acc, red);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc;
    bad_part[blockIdx.x] = bad;
    __threadfence();
    last = atomicAdd(&hdr->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every partial, in block order
  float s = 0.f;
  int b = 0;
  for (int j = threadIdx.x; j < gridDim.x; j += THREADS) {
    s = __fadd_rn(s, __ldcg(part + j));
    b |= __ldcg(bad_part + j);
  }
  s = block_sum(s, red);
  b = __syncthreads_or(b);
  if (threadIdx.x == 0) {
    hdr->ok = (!b && isfinite(*loss)) ? 1 : 0;
    float scale = 1.f;
    if (flags & L2_CLIP) {
      // clamp_max(clip / (sqrt(sq) + 1e-12), 1.0), where the torch
      // division of a number by a tensor is reciprocal(tensor) * number
      const float den = __fadd_rn(__fsqrt_rn(s), 1e-12f);
      scale = __fmul_rn(__fdiv_rn(1.f, den), clip);
      if (scale > 1.f) scale = 1.f;
    }
    hdr->scale = scale;
    hdr->ticket = 0;
  }
}

// one element of _GradClipper then Adam.step, op for op
__device__ __forceinline__ void adam(float g, float& m, float& v, float& p,
                                     bool frozen, const Coef& k) {
  if (k.cclip) g = clampf(g, k.lo, k.hi);
  if (k.l2) g = __fmul_rn(g, k.scale);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.c2, g), g));
  if (!frozen)
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(k.lr, __fdiv_rn(m, k.bc1)),
                               __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)),
                                         k.eps)));
}

__global__ void __launch_bounds__(THREADS)
    apply_kernel(const Entry* __restrict__ tab, int nt, long long nchunks,
                 const Header* __restrict__ hdr,
                 const float* __restrict__ lr, const float* __restrict__ bc1,
                 const float* __restrict__ bc2, float b1, float c1, float b2,
                 float c2, float eps, float lo, float hi, int flags) {
  if ((flags & GATE) && !hdr->ok) return;
  Coef k;
  k.cclip = flags & CONST_CLIP;
  k.l2 = flags & L2_CLIP;
  k.scale = k.l2 ? hdr->scale : 1.f;
  k.lr = *lr;
  k.bc1 = *bc1;
  k.bc2 = *bc2;
  k.b1 = b1;
  k.c1 = c1;
  k.b2 = b2;
  k.c2 = c2;
  k.eps = eps;
  k.lo = lo;
  k.hi = hi;
  int t = 0;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    t = entry_of(tab, nt, t, c);
    const Entry e = tab[t];
    const long long base = (c - e.first) * CHUNK;
    const int len = (int)min(CHUNK, e.n - base);
    const bool frozen = e.flags & FROZEN;
    const float* g = reinterpret_cast<const float*>(e.g) + base;
    float* p = reinterpret_cast<float*>(e.p) + base;
    float* m = reinterpret_cast<float*>(e.m) + base;
    float* v = reinterpret_cast<float*>(e.v) + base;
    int i = threadIdx.x;
    if (e.flags & ALIGNED) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (; i < (len >> 2); i += THREADS) {
        const float4 gg = g4[i];
        float4 mm = m4[i], vv = v4[i];
        float4 pp = frozen ? make_float4(0.f, 0.f, 0.f, 0.f) : p4[i];
        adam(gg.x, mm.x, vv.x, pp.x, frozen, k);
        adam(gg.y, mm.y, vv.y, pp.y, frozen, k);
        adam(gg.z, mm.z, vv.z, pp.z, frozen, k);
        adam(gg.w, mm.w, vv.w, pp.w, frozen, k);
        m4[i] = mm;
        v4[i] = vv;
        if (!frozen) p4[i] = pp;
      }
      i = ((len >> 2) << 2) + threadIdx.x;
    }
    for (; i < len; i += THREADS) {
      float mm = m[i], vv = v[i];
      float pp = frozen ? 0.f : p[i];
      adam(g[i], mm, vv, pp, frozen, k);
      m[i] = mm;
      v[i] = vv;
      if (!frozen) p[i] = pp;
    }
  }
}

}  // namespace

// pass 1 (statistics) or pass 2 (apply) over the buffer's n_tensors
// entries and n_chunks chunks, on `grid` blocks; the buffer's partials
// hold `grid` entries. Pass 1 reads loss, clip, lo and hi; pass 2 the
// rest.
extern "C" int bigdl_fused_adam(int pass, void* buf, int n_tensors,
                                long long n_chunks, int grid,
                                const void* loss, const void* lr,
                                const void* bc1, const void* bc2, float b1,
                                float c1, float b2, float c2, float eps,
                                float clip, float lo, float hi, int flags,
                                void* stream) {
  if (buf == nullptr || n_tensors <= 0 || n_chunks < 0 || grid <= 0 ||
      grid > 65535)
    return (int)cudaErrorInvalidValue;
  long long* words = static_cast<long long*>(buf);
  Header* hdr = reinterpret_cast<Header*>(words);
  const Entry* tab = reinterpret_cast<const Entry*>(words + 8);
  float* part = reinterpret_cast<float*>(words + 8 + 8LL * n_tensors);
  int* bad = reinterpret_cast<int*>(part + grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 1) {
    if (loss == nullptr) return (int)cudaErrorInvalidValue;
    stats_kernel<<<grid, THREADS, 0, s>>>(
        tab, n_tensors, n_chunks, part, bad, hdr,
        static_cast<const float*>(loss), clip, lo, hi, flags);
  } else if (pass == 2) {
    if (lr == nullptr || bc1 == nullptr || bc2 == nullptr)
      return (int)cudaErrorInvalidValue;
    apply_kernel<<<grid, THREADS, 0, s>>>(
        tab, n_tensors, n_chunks, hdr, static_cast<const float*>(lr),
        static_cast<const float*>(bc1), static_cast<const float*>(bc2), b1,
        c1, b2, c2, eps, lo, hi, flags);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
