// k x k convolution with BatchNorm statistics in the epilogue, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/conv_bn.py::_fwd_kernel_kxk
// (launched by _fwd_kxk), and with it the probe scripts/kxk_probe.py (a
// 3x3 stride-1 conv without statistics). It computes the conv
// y[n, o, ho, wo] = sum_{dy, dx, c} w[o, c, dy, dx] *
//                   x[n, c, ho*s - pad + dy, wo*s - pad + dx]
// with zero (torch-style symmetric) padding and f32 accumulation, writes y
// (N, O, Ho, Wo) in x's dtype, and sums (acc - shift[o]) and
// (acc - shift[o])^2 per channel over the N*Ho*Wo valid outputs, from the
// f32 accumulator, as _reference does. Any k, stride and pad with a
// non-empty output, stride 2 directly: the TPU kernel's space-to-depth
// rewrite (_s2d_rewrite) and its flattened, lane-shifted padded image
// were Mosaic workarounds and have no counterpart here.
//
// What bounds it on the H100: an implicit GEMM of M = O by N = N*Ho*Wo
// over K = k*k*C. For ResNet-50's 3x3 sites in bf16 at batch 32 that is
// 9x a 1x1's FLOPs on the same bytes, some 260-940 FLOPs per byte, at or
// above the tensor cores' ridge of ~295: bound by operations.
//
// bf16 (conv_bn_kxk_bf16_kernel): the tensor cores. A layout pass first
// (to_nhwc_kernel, the same call) writes x as NHWC (N, H, W, Cp) and w as
// (O, k, k, Cp) into scratch the caller allocates, Cp = C rounded up to a
// multiple of 8 and the extra channels zero (zeros add nothing): a tiled
// transpose through shared memory, the same layout JAX's pad-and-flatten
// builds outside its kernel (ops.conv_bn.kxk_operands states it in
// PyTorch). So K runs tap-major as JAX's im2col does
// (t * C + c, t = dy * k + dx) and every A row (one output channel) and B
// row (one output pixel at one tap) is contiguous in K. A CTA of four
// warps owns a 64-channel by 128-pixel output tile, the pixels flattened
// across samples so that the small late-stage images (7x7) fill whole
// tiles. Each k-step takes 64 channels of one tap: 16-byte cp.async
// copies into rows padded by 16 bytes (no ldmatrix bank conflicts), three
// stages in flight; an out-of-image tap, a channel past C or a pixel past
// the end is zero-filled by src-size 0, never gathered. Warp (wm, wn)
// multiplies its 64 x 32 sub-tile by m16n8k16 mma.sync, A and B by
// ldmatrix, each run of 8 MMAs into a fresh fragment that ordinary f32
// adds take into the running sum (the tensor cores' own accumulation
// does not round to nearest). The epilogue rounds y to bf16 once, stages
// it through shared memory and stores it as NCHW rows of consecutive
// pixels; the statistics come from the f32 accumulators: each row's
// centred sums over the thread's columns, across its quad by two fixed
// shuffles, then across the four warps that share the row in fixed order
// through shared memory, into the CTA's partial column. No split of K: y
// and the sums are bit-equal run to run.
//
// f32 (conv_bn_kxk_f32_kernel): the CUDA cores, on NCHW x and (O, C, k, k)
// w: 64x64 output tiles per sample, the im2col column tile gathered
// straight from x into shared memory as f32, a 4x4 register tile per
// thread (conv_bn_common.cuh's fma_tile and store_and_stats). Each thread
// decodes its pixel once; a k-step decodes (c, dy, dx) per loaded
// element.
//
// Both write per-CTA statistics partials that conv_bn_common.cuh's
// fixed-order second pass sums.

#include "conv_bn_common.cuh"
#include "conv_bn_mma.cuh"

namespace {

// grid (ceil(Ho*Wo/BN), ceil(O/BM), N); part is (2, O, ncols) with
// ncols = N * gridDim.x, one column per CTA along (n, pixel tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_bn_kxk_f32_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ shift, T* __restrict__ y,
                       float* __restrict__ part, int c, int h, int wd, int o,
                       int k, int stride, int pad, int ho, int wo) {
  __shared__ __align__(16) float as[BK][LDA];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // pixel group: columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // channel group: rows ty*4 .. ty*4+3
  const int npix = ho * wo;
  const int kk2 = k * k;
  const int kdim = c * kk2;  // reduction length
  const int p0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const T* xn = x + (size_t)blockIdx.z * c * h * wd;

  // B loader: this thread always loads pixel p0 + b_p (rows b_k + 4r of
  // each k-step), so its window origin is decoded once
  const int b_p = tid & (BN - 1), b_k = tid >> 6;
  const int pix = p0 + b_p;
  const bool b_in = pix < npix;
  const int hi0 = b_in ? (pix / wo) * stride - pad : 0;
  const int wi0 = b_in ? (pix % wo) * stride - pad : 0;
  // A loader: W[o0+m, k0+kk], consecutive threads on consecutive kk
  const int a_k = tid & (BK - 1), a_m = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = b_k + 4 * r;
      const int kg = k0 + kk;
      float v = 0.f;
      if (b_in && kg < kdim) {
        const int cc = kg / kk2;
        const int t = kg - cc * kk2;
        const int dy = t / k;
        const int hi = hi0 + dy;
        const int wi = wi0 + (t - dy * k);
        if (hi >= 0 && hi < h && wi >= 0 && wi < wd)
          v = to_f32(xn[((size_t)cc * h + hi) * wd + wi]);
      }
      bs[kk][b_p] = v;
      const int m = a_m + 16 * r;
      const int ka = k0 + a_k;
      as[a_k][m] = (o0 + m < o && ka < kdim)
                       ? to_f32(w[(size_t)(o0 + m) * kdim + ka]) : 0.f;
    }
    __syncthreads();
    fma_tile(as, bs, ty, tx, acc);
    __syncthreads();
  }
  store_and_stats(acc, y, shift, part, o, npix, ty, tx);
}

// x (N, C, HW) -> xh (N, HW, cp), channels C..cp-1 zero: x as NHWC with
// its channels padded, or w (O, C, k, k) as (O, k, k, cp). A CTA moves a
// 64-channel by 32-pixel tile of one image through shared memory: reads
// run along the pixels of a channel, writes along the channels of a
// pixel, two channels (4 bytes) a thread. grid (ceil(HW/32),
// ceil(cp/64), N), block (32, 8).
__global__ void __launch_bounds__(256)
to_nhwc_kernel(const bf16* __restrict__ x, bf16* __restrict__ xh, int c,
               int cp, int hw) {
  __shared__ bf16 tile[64][32 + 2];  // [channel][pixel], padded rows
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 64;
  const size_t n = blockIdx.z;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = c0 + ty + 8 * i, p = p0 + tx;
    tile[ty + 8 * i][tx] = ch < c && p < hw
                               ? x[(n * c + ch) * hw + p]
                               : __float2bfloat16(0.f);
  }
  __syncthreads();
  const int ch = c0 + 2 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pl = ty + 8 * i, p = p0 + pl;
    if (p < hw && ch < cp) {
      __nv_bfloat162 v;
      v.x = tile[2 * tx][pl];
      v.y = tile[2 * tx + 1][pl];
      *reinterpret_cast<__nv_bfloat162*>(xh + (n * hw + p) * cp + ch) = v;
    }
  }
}

inline void to_nhwc(const bf16* x, bf16* xh, int n, int c, int cp, int hw,
                    cudaStream_t stream) {
  const dim3 grid((hw + 31) / 32, (cp + 63) / 64, n);
  to_nhwc_kernel<<<grid, dim3(32, 8), 0, stream>>>(x, xh, c, cp, hw);
}

// The bf16 kernel's B stage: TN pixel rows of TK channels of one tap
constexpr int B_COPIES = TN * PIECES / MMA_THREADS;  // per thread
constexpr int STAGE_ELEMS = (TM + TN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
static_assert(TN * PIECES % MMA_THREADS == 0, "whole rounds of copies");
static_assert(EPILOGUE_BYTES <= SMEM_BYTES,
              "the epilogue reuses the pipeline's shared memory");
// an image row so far out of range that no tap brings it back in: the
// mark of a pixel past the end
constexpr int OUT_OF_IMAGE = -(1 << 28);

// grid (ceil(N*Ho*Wo / TN), ceil(O / TM)); part is (2, O, gridDim.x), one
// column per pixel tile. x (N, H, W, c) and w (O, k, k, c) with c a
// multiple of 8, both 16-byte aligned (to_nhwc's output).
__global__ void __launch_bounds__(MMA_THREADS)
conv_bn_kxk_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ shift, bf16* __restrict__ y,
                        float* __restrict__ part, int n_img, int c, int h,
                        int wd, int o, int k, int stride, int pad, int ho,
                        int wo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the warp's rows WM * wm.., columns WN * wn..
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int hw = ho * wo;
  const int npix = n_img * hw;
  const int p0 = blockIdx.x * TN;
  const int o0 = blockIdx.y * TM;
  const int kk2 = k * k;
  const int nchunk = (c + TK - 1) / TK;
  const int nsteps = kk2 * nchunk;

  // copy roles: the thread moves 16-byte piece q (channels 8q..8q+7 of
  // the k-step) of A rows ar + RA i and of B rows ar + RA i
  constexpr int RA = MMA_THREADS / PIECES;  // rows a round of copies covers
  const int q = tid % PIECES, ar = tid / PIECES;
  const ARows a_row = a_rows(w, o0, o, kk2 * c, ar);
  // each B row's window origin, decoded once: (n * H, top row, left col)
  int b_nh[B_COPIES], b_hi[B_COPIES], b_wi[B_COPIES];
#pragma unroll
  for (int i = 0; i < B_COPIES; ++i) {
    const int p = p0 + ar + RA * i;
    const int n = p / hw, r = p - n * hw;
    const int oy = r / wo;
    b_nh[i] = n * h;
    b_hi[i] = p < npix ? oy * stride - pad : OUT_OF_IMAGE;
    b_wi[i] = (r - oy * wo) * stride - pad;
  }

  // k-step s: tap t = s / nchunk, channels TK (s % nchunk) + 8 q ..
  auto load = [&](int stage, int s) {
    bf16* as = smem + stage * STAGE_ELEMS;
    bf16* bs = as + TM * LDS;
    const int t = s / nchunk;
    const int cc = (s - t * nchunk) * TK + 8 * q;
    const int dy = t / k, dx = t - dy * k;
    const bool c_ok = cc < c;
    load_a(as, a_row, w, ar, q, t * c + cc, c_ok);
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) {
      const int hi = b_hi[i] + dy, wi = b_wi[i] + dx;
      const bool ok = c_ok && (unsigned)hi < (unsigned)h &&
                      (unsigned)wi < (unsigned)wd;
      cp_async16(bs + (ar + RA * i) * LDS + 8 * q,
                 ok ? x + ((size_t)(b_nh[i] + hi) * wd + wi) * c + cc : x,
                 ok);
    }
  };

  // the MMAs of CHAIN k-steps accumulate into `chain` from zero, and it is
  // added into `acc` by ordinary f32 adds (conv_bn_mma.cuh)
  float acc[MI][NI][4], chain[MI][NI][4];
  zero(acc);
  zero(chain);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  for (int ks = 0; ks < nsteps; ++ks) {
    cp_async_wait<STAGES - 2>();  // step ks has landed
    __syncthreads();              // ... for every thread; ks - 1 is consumed
    if (ks + STAGES - 1 < nsteps)
      load((ks + STAGES - 1) % STAGES, ks + STAGES - 1);
    cp_async_commit();

    const bf16* as = smem + (ks % STAGES) * STAGE_ELEMS;
    mma_stage<false>(as, as + TM * LDS, wm, wn, lane, chain);
    if (ks % CHAIN == CHAIN - 1 || ks + 1 == nsteps) fold_chain(acc, chain);
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory is free
  store_y_and_stats(acc, smem_raw, shift, y, part, o, npix, hw);
}

template <typename T>
cudaError_t launch_f32(const void* x, const void* w, const float* shift,
                       void* y, float* part, float* s1, float* s2, int n,
                       int c, int h, int wd, int o, int k, int stride,
                       int pad, int ho, int wo, cudaStream_t stream) {
  const dim3 grid((ho * wo + BN - 1) / BN, (o + BM - 1) / BM, n);
  conv_bn_kxk_f32_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), shift,
      static_cast<T*>(y), part, c, h, wd, o, k, stride, pad, ho, wo);
  return reduce_stats(grid, part, o, s1, s2, stream);
}

cudaError_t launch_bf16(const void* x, const void* w, const float* shift,
                        void* y, float* part, float* s1, float* s2, void* xh,
                        void* wh, int n, int c, int h, int wd, int o, int k,
                        int stride, int pad, int ho, int wo,
                        cudaStream_t stream) {
  const long long npix = (long long)n * ho * wo;  // int pixel indices
  if (npix > (1LL << 30) || n > 65535 || o > 65535)
    return cudaErrorInvalidValue;
  const int cp = (c + 7) / 8 * 8;
  auto xt = static_cast<bf16*>(xh);
  auto wt = static_cast<bf16*>(wh);
  to_nhwc(static_cast<const bf16*>(x), xt, n, c, cp, h * wd, stream);
  to_nhwc(static_cast<const bf16*>(w), wt, o, c, cp, k * k, stream);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bn_kxk_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((npix + TN - 1) / TN), (o + TM - 1) / TM);
  conv_bn_kxk_bf16_kernel<<<grid, MMA_THREADS, SMEM_BYTES, stream>>>(
      xt, wt, shift, static_cast<bf16*>(y), part, n, cp, h, wd, o, k, stride,
      pad, ho, wo);
  return reduce_stats(grid, part, o, s1, s2, stream);
}

}  // namespace

extern "C" {

// x (N, C, H, W) and w (O, C, k, k) of one dtype. dtype 0: f32, the
// CUDA-core kernel, xh and wh unused; dtype 1: bf16, the tensor cores,
// with scratch xh (N, H, W, Cp) and wh (O, k, k, Cp) bf16, Cp = C rounded
// up to a multiple of 8, each 16-byte aligned. Returns a cudaError_t (0 on
// success).
int bigdl_conv_bn_kxk(const void* x, const void* w, const void* shift,
                      void* y, void* part, void* s1, void* s2, void* xh,
                      void* wh, int n, int c, int h, int wd, int o, int k,
                      int stride, int pad, int ho, int wo, int dtype,
                      void* stream) {
  if (n <= 0 || c <= 0 || o <= 0 || k <= 0 || stride <= 0 || pad < 0 ||
      ho <= 0 || wo <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sh = static_cast<const float*>(shift);
  auto pt = static_cast<float*>(part);
  auto a = static_cast<float*>(s1);
  auto b = static_cast<float*>(s2);
  if (dtype == 0)
    return (int)launch_f32<float>(x, w, sh, y, pt, a, b, n, c, h, wd, o, k,
                                  stride, pad, ho, wo, st);
  if (dtype == 1)
    return (int)launch_bf16(x, w, sh, y, pt, a, b, xh, wh, n, c, h, wd, o, k,
                            stride, pad, ho, wo, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
