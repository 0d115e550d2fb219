// k x k convolution with BatchNorm statistics in the epilogue, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/conv_bn.py::_fwd_kernel_kxk
// (launched by _fwd_kxk), and with it the probe scripts/kxk_probe.py (a
// 3x3 stride-1 conv without statistics). It computes the NCHW conv
// y[n, o, ho, wo] = sum_{c, dy, dx} w[o, c, dy, dx] *
//                   x[n, c, ho*s - pad + dy, wo*s - pad + dx]
// with zero (torch-style symmetric) padding and f32 accumulation, writes y
// in x's dtype, and sums (acc - shift[o]) and (acc - shift[o])^2 per
// channel over the N*Ho*Wo valid outputs, from the f32 accumulator, as
// _reference does. Any k, stride and pad with a non-empty output, stride 2
// directly: the TPU kernel's space-to-depth rewrite (_s2d_rewrite) and its
// flattened, lane-shifted padded image were Mosaic workarounds and have no
// counterpart here.
//
// Shapes: x (N, C, H, W), w (O, C, k, k), shift (O,) f32, y (N, O, Ho, Wo);
// all contiguous; f32 or bf16 x and w.
//
// What bounds it on the H100: an implicit GEMM of (O, C*k*k) by
// (C*k*k, Ho*Wo) per sample. For ResNet-50's 3x3 sites in bf16 at batch
// 32 that is 9x a 1x1's FLOPs on the same bytes, some 260-940 FLOPs per
// byte, at or above the tensor cores' ridge of ~295: bound by operations.
// This first version does them on the CUDA cores in f32 (67 TFLOP/s
// peak): 64x64 output tiles, the im2col column tile gathered straight
// from x into shared memory (out-of-image taps read as 0, never
// materialised), a 4x4 register tile per thread. Each thread decodes its
// pixel once; a k-step decodes (c, dy, dx) per loaded element.
// mma.sync/wgmma come later.
//
// The tiles, the FMA step, the statistics epilogue and its deterministic
// second pass are shared with conv_bn_1x1.cu, in conv_bn_common.cuh.

#include "conv_bn_common.cuh"

namespace {

// grid (ceil(Ho*Wo/BN), ceil(O/BM), N); part is (2, O, ncols) with
// ncols = N * gridDim.x, one column per CTA along (n, pixel tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
convkxk_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* shift, void* y,
                   float* part, float* s1, float* s2, int n, int c, int h,
                   int wd, int o, int k, int stride, int pad, int ho, int wo,
                   cudaStream_t stream) {
  const dim3 grid((ho * wo + BN - 1) / BN, (o + BM - 1) / BM, n);
  convkxk_stats_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), shift,
      static_cast<T*>(y), part, c, h, wd, o, k, stride, pad, ho, wo);
  return reduce_stats(grid, part, o, s1, s2, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16. Returns a cudaError_t (0 on success).
int bigdl_conv_bn_kxk(const void* x, const void* w, const void* shift,
                      void* y, void* part, void* s1, void* s2, int n, int c,
                      int h, int wd, int o, int k, int stride, int pad,
                      int ho, int wo, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || o <= 0 || k <= 0 || stride <= 0 || pad < 0 ||
      ho <= 0 || wo <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sh = static_cast<const float*>(shift);
  auto pt = static_cast<float*>(part);
  auto a = static_cast<float*>(s1);
  auto b = static_cast<float*>(s2);
  if (dtype == 0)
    return (int)launch<float>(x, w, sh, y, pt, a, b, n, c, h, wd, o, k,
                              stride, pad, ho, wo, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, sh, y, pt, a, b, n, c, h, wd, o,
                                      k, stride, pad, ho, wo, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
