// 1x1 convolution with BatchNorm statistics in the epilogue, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/conv_bn.py::_fwd_kernel_1x1
// (launched by _fwd_1x1). Per sample n it computes Y[n] = W . X[n], a
// (O, C) by (C, HW) product with f32 accumulation, writes Y in X's dtype,
// and sums (acc - shift[o]) and (acc - shift[o])^2 per output channel over
// all N*HW outputs, from the f32 accumulator (not the rounded Y), as the
// JAX kernel does. A strided 1x1 site reaches this kernel with X already
// subsampled by the caller.
//
// Shapes: x (N, C, HW), w (O, C), shift (O,) f32, y (N, O, HW); all
// contiguous; f32 or bf16 x and w. HW need not be a multiple of the tile
// (ResNet-50 has 3136, 784, 196 and 49): the ragged edge is bounds-checked,
// never padded.
//
// What bounds it on the H100: 2*O*C*HW FLOPs per sample against
// (C*HW + O*HW) elements per sample plus O*C once. At ResNet-50's 1x1
// sites in bf16 at batch 32 that is some 30-330 FLOPs per byte, mostly
// under the tensor cores' ridge of ~295, so the card's bound is mostly the
// bytes. This first version does the products on the CUDA cores in f32
// (67 TFLOP/s peak, a ridge near 20 FLOP/byte), so it is bound by those
// operations: 64x64 tiles in shared memory, a 4x4 register tile per
// thread, two 16-byte shared loads per 16 FMAs. mma.sync/wgmma on the
// tensor cores come in a later version.
//
// The tiles, the FMA step, the statistics epilogue and its deterministic
// second pass are shared with conv_bn_kxk.cu, in conv_bn_common.cuh.

#include "conv_bn_common.cuh"

namespace {

// grid (ceil(HW/BN), ceil(O/BM), N); part is (2, O, ncols) with
// ncols = N * gridDim.x, one column per CTA along (n, pixel tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1x1_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ shift, T* __restrict__ y,
                     float* __restrict__ part, int c, int hw, int o) {
  __shared__ __align__(16) float as[BK][LDA];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // pixel group: columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // channel group: rows ty*4 .. ty*4+3
  const int p0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const T* xn = x + (size_t)blockIdx.z * c * hw;

  // loaders: B element (kk, p) = X[n, k0+kk, p0+p], consecutive threads on
  // consecutive pixels; A element (kk, m) = W[o0+m, k0+kk], consecutive
  // threads on consecutive input channels
  const int b_p = tid & (BN - 1), b_k = tid >> 6;
  const int a_k = tid & (BK - 1), a_m = tid >> 4;
  const bool b_in = p0 + b_p < hw;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = b_k + 4 * r;
      const int cc = k0 + kk;
      bs[kk][b_p] = (b_in && cc < c)
                        ? to_f32(xn[(size_t)cc * hw + p0 + b_p]) : 0.f;
      const int m = a_m + 16 * r;
      const int ca = k0 + a_k;
      as[a_k][m] = (o0 + m < o && ca < c)
                       ? to_f32(w[(size_t)(o0 + m) * c + ca]) : 0.f;
    }
    __syncthreads();
    fma_tile(as, bs, ty, tx, acc);
    __syncthreads();
  }
  store_and_stats(acc, y, shift, part, o, hw, ty, tx);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* shift, void* y,
                   float* part, float* s1, float* s2, int n, int c, int hw,
                   int o, cudaStream_t stream) {
  const dim3 grid((hw + BN - 1) / BN, (o + BM - 1) / BM, n);
  conv1x1_stats_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), shift,
      static_cast<T*>(y), part, c, hw, o);
  return reduce_stats(grid, part, o, s1, s2, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16. Returns a cudaError_t (0 on success).
int bigdl_conv_bn_1x1(const void* x, const void* w, const void* shift,
                      void* y, void* part, void* s1, void* s2, int n, int c,
                      int hw, int o, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || o <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sh = static_cast<const float*>(shift);
  auto pt = static_cast<float*>(part);
  auto a = static_cast<float*>(s1);
  auto b = static_cast<float*>(s2);
  if (dtype == 0)
    return (int)launch<float>(x, w, sh, y, pt, a, b, n, c, hw, o, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, sh, y, pt, a, b, n, c, hw, o, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
