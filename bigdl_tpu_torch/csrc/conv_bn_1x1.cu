// 1x1 convolution with BatchNorm statistics in the epilogue, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel bigdl_tpu/ops/conv_bn.py::_fwd_kernel_1x1
// (launched by _fwd_1x1). Per sample n it computes Y[n] = W . X[n], a
// (O, C) by (C, Ho*Wo) product with f32 accumulation, writes Y in X's
// dtype, and sums (acc - shift[o]) and (acc - shift[o])^2 per output
// channel over all N*Ho*Wo outputs, from the f32 accumulator (not the
// rounded Y), as the JAX kernel does. A strided site reads
// x[n, c, s*ho, s*wo] directly: no subsampled copy of x.
//
// Shapes: x (N, C, H, W), w (O, C), shift (O,) f32, y (N, O, Ho, Wo) with
// Ho = (H - 1) / s + 1; all contiguous; f32 or bf16 x and w. Ho*Wo need
// not be a multiple of a tile (ResNet-50 has 3136, 784, 196 and 49): the
// ragged edge is bounds-checked, never padded.
//
// What bounds it on the H100: 2*O*C*HW FLOPs per sample against
// (C*HW + O*HW) elements per sample plus O*C once. At ResNet-50's 1x1
// sites in bf16 at batch 32 that is some 30-330 FLOPs per byte, mostly
// under the tensor cores' ridge of ~295: bound by the bytes, so x and y
// have to stream near the memory rate and the products must not be the
// limit.
//
// bf16 (conv_bn_1x1_bf16_kernel): the tensor cores, the bf16 kxk kernel's
// GEMM with one tap (conv_bn_mma.cuh). W (O, C) is the A operand as it
// lies (rows contiguous in K = C, C a multiple of 8). x is read in NCHW
// with no layout pass: the k-step's TK channel rows of the tile's TN
// pixels (flattened across samples) land as [channel][pixel] rows in
// shared memory, and ldmatrix.trans turns them into B fragments. How a
// row piece is copied depends on Ho*Wo, chosen per launch as the template
// parameter VEC, never per element: pieces of 8, 4 or 2 pixels by one
// cp.async of 16, 8 or 4 bytes when HW = Ho*Wo (and x's address) is a
// multiple of VEC, so that no piece crosses a sample or a misaligned
// address (3136 and 784: 16 bytes; 196: 8 bytes); otherwise (HW = 49, or
// a strided site) pairs of pixels gathered element by element into
// registers, fetched before a k-step's MMAs and stored to shared memory
// after them, so the loads' latency hides behind the products. A piece
// past C or past N*HW is zero-filled, never read. Three stages in flight;
// runs of CHAIN k-steps into a fresh fragment, added by f32 adds; the
// epilogue and its statistics partials are conv_bn_mma.cuh's.
//
// f32 (conv_bn_1x1_f32_kernel): the CUDA cores, 64x64 output tiles per
// sample in shared memory, a 4x4 register tile per thread (the tiles, the
// FMA step and the epilogue are conv_bn_common.cuh's, shared with the f32
// kxk kernel). f32 products run at 67 TFLOP/s peak, so this path is
// bound by its operations.
//
// Both write per-CTA statistics partials that conv_bn_common.cuh's
// fixed-order second pass sums.

#include "conv_bn_common.cuh"
#include "conv_bn_mma.cuh"

namespace {

// grid (ceil(Ho*Wo/BN), ceil(O/BM), N); part is (2, O, ncols) with
// ncols = N * gridDim.x, one column per CTA along (n, pixel tile).
__global__ void __launch_bounds__(THREADS)
conv_bn_1x1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ shift, float* __restrict__ y,
                       float* __restrict__ part, int c, int h, int wd, int o,
                       int stride, int wo, int hw) {
  __shared__ __align__(16) float as[BK][LDA];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // pixel group: columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // channel group: rows ty*4 .. ty*4+3
  const int p0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int hw_in = h * wd;
  const float* xn = x + (size_t)blockIdx.z * c * hw_in;

  // loaders: B element (kk, p) = x[n, k0+kk, s*oy, s*ox] for output pixel
  // p0+p = (oy, ox), consecutive threads on consecutive pixels; A element
  // (kk, m) = W[o0+m, k0+kk], consecutive threads on consecutive input
  // channels
  const int b_p = tid & (BN - 1), b_k = tid >> 6;
  const int a_k = tid & (BK - 1), a_m = tid >> 4;
  const int pix = p0 + b_p;
  const bool b_in = pix < hw;
  const int b_off = b_in ? (pix / wo) * stride * wd + (pix % wo) * stride : 0;

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
      bs[kk][b_p] = (b_in && cc < c) ? xn[(size_t)cc * hw_in + b_off] : 0.f;
      const int m = a_m + 16 * r;
      const int ca = k0 + a_k;
      as[a_k][m] = (o0 + m < o && ca < c) ? w[(size_t)(o0 + m) * c + ca]
                                          : 0.f;
    }
    __syncthreads();
    fma_tile(as, bs, ty, tx, acc);
    __syncthreads();
  }
  store_and_stats(acc, y, shift, part, o, hw, ty, tx);
}

// The bf16 kernel's B stage: TK channel rows of TN pixels. A launch
// allocates only the stages its k-steps use (ResNet-50's C = 64 sites
// have one): the registers, not shared memory, then bound the CTAs an SM
// holds.
constexpr int STAGE_ELEMS = TM * LDS + TK * LDB;
constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
static_assert(EPILOGUE_BYTES <= STAGE_BYTES,
              "the epilogue reuses the pipeline's shared memory");

// two bf16 bit patterns as the pair (lo, hi) of one 32-bit word
__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// grid (ceil(N*Ho*Wo / TN), ceil(O / TM)); part is (2, O, gridDim.x), one
// column per pixel tile. x (N, C, H, W) NCHW with x + (any pixel offset
// that is a multiple of VEC) 2*VEC-byte aligned; w (O, c), c a multiple of
// 8, 16-byte aligned. VEC 8, 4, 2: stride 1 and Ho*Wo a multiple of VEC,
// B pieces of VEC pixels by cp.async; VEC 1: pairs of pixels gathered.
template <int VEC>
__global__ void __launch_bounds__(MMA_THREADS)
conv_bn_1x1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ shift, bf16* __restrict__ y,
                        float* __restrict__ part, int n_img, int c, int h,
                        int wd, int o, int stride, int ho, int wo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int hw = ho * wo;  // output pixels per sample
  const int hw_in = h * wd;
  const int npix = n_img * hw;
  const int p0 = blockIdx.x * TN;
  const int o0 = blockIdx.y * TM;
  const int nsteps = (c + TK - 1) / TK;

  const int q = tid % PIECES, ar = tid / PIECES;
  const ARows a_row = a_rows(w, o0, o, c, ar);

  // B copy roles: the thread moves piece bq (pixels p0 + G bq ..) of the
  // k-step's channel rows br + RB i
  constexpr int G = VEC > 1 ? VEC : 2;       // pixels per piece
  constexpr int PPR = TN / G;                // pieces per channel row
  constexpr int RB = MMA_THREADS / PPR;      // rows a round covers
  constexpr int B_COPIES = TK / RB;          // per thread
  static_assert(MMA_THREADS % PPR == 0 && TK % RB == 0, "B copy roles");
  const int bq = tid % PPR, br = tid / PPR;
  // each of the piece's pixels' offset in x at channel 0 (-1: past the
  // end); with VEC > 1 the piece's pixels are consecutive in x
  long long b_off[VEC > 1 ? 1 : 2];
#pragma unroll
  for (int j = 0; j < (VEC > 1 ? 1 : 2); ++j) {
    const int p = p0 + G * bq + j;
    const int n = p / hw, r = p - n * hw;
    const int oy = r / wo, ox = r - oy * wo;
    b_off[j] = p < npix ? (long long)n * c * hw_in +
                              (long long)oy * stride * wd + ox * stride
                        : -1;
  }
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  uint32_t staged[VEC > 1 ? 1 : B_COPIES];  // the gathered pairs

  // VEC 1: k-step s's pairs into registers
  auto fetch = [&](int s) {
    if constexpr (VEC == 1) {
#pragma unroll
      for (int i = 0; i < B_COPIES; ++i) {
        const int cc = s * TK + br + RB * i;
        const long long ch = (long long)cc * hw_in;
        const unsigned short v0 =
            cc < c && b_off[0] >= 0 ? __ldg(xs + b_off[0] + ch) : 0;
        const unsigned short v1 =
            cc < c && b_off[1] >= 0 ? __ldg(xs + b_off[1] + ch) : 0;
        staged[i] = pack2(v0, v1);
      }
    }
  };
  // VEC 1: the fetched pairs into the stage
  auto store = [&](int stage) {
    if constexpr (VEC == 1) {
      bf16* bs = smem + stage * STAGE_ELEMS + TM * LDS;
#pragma unroll
      for (int i = 0; i < B_COPIES; ++i)
        *reinterpret_cast<uint32_t*>(bs + (br + RB * i) * LDB + 2 * bq) =
            staged[i];
    }
  };
  // k-step s into a stage: A by cp.async; B by cp.async (VEC > 1) or from
  // the registers a fetch filled (VEC 1)
  auto load = [&](int stage, int s) {
    bf16* as = smem + stage * STAGE_ELEMS;
    const int cc = s * TK + 8 * q;
    load_a(as, a_row, w, ar, q, cc, cc < c);
    if constexpr (VEC > 1) {
      bf16* bs = as + TM * LDS;
#pragma unroll
      for (int i = 0; i < B_COPIES; ++i) {
        const int row = s * TK + br + RB * i;
        const bool ok = row < c && b_off[0] >= 0;
        bf16* dst = bs + (br + RB * i) * LDB + G * bq;
        const bf16* src = ok ? x + b_off[0] + (long long)row * hw_in : x;
        if constexpr (VEC == 8) cp_async16(dst, src, ok);
        if constexpr (VEC == 4) cp_async8(dst, src, ok);
        if constexpr (VEC == 2) cp_async4(dst, src, ok);
      }
    } else {
      store(stage);
    }
  };

  float acc[MI][NI][4], chain[MI][NI][4];
  zero(acc);
  zero(chain);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) {
      fetch(st);
      load(st, st);
    }
    cp_async_commit();
  }
  for (int ks = 0; ks < nsteps; ++ks) {
    cp_async_wait<STAGES - 2>();  // step ks has landed
    __syncthreads();              // ... for every thread; ks - 1 is consumed
    const int next = ks + STAGES - 1;
    const bool more = next < nsteps;
    if (VEC > 1) {
      if (more) load(next % STAGES, next);
      cp_async_commit();
    } else if (more) {
      fetch(next);  // the gather's loads go out before the MMAs ..
    }

    const bf16* as = smem + (ks % STAGES) * STAGE_ELEMS;
    mma_stage<true>(as, as + TM * LDS, wm, wn, lane, chain);
    if (ks % CHAIN == CHAIN - 1 || ks + 1 == nsteps) fold_chain(acc, chain);
    if (VEC == 1) {  // .. and land in shared memory after them
      if (more) load(next % STAGES, next);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory is free
  store_y_and_stats(acc, smem_raw, shift, y, part, o, npix, hw);
}

cudaError_t launch_f32(const float* x, const float* w, const float* shift,
                       float* y, float* part, float* s1, float* s2, int n,
                       int c, int h, int wd, int o, int stride,
                       cudaStream_t stream) {
  const int ho = (h - 1) / stride + 1, wo = (wd - 1) / stride + 1;
  const dim3 grid((ho * wo + BN - 1) / BN, (o + BM - 1) / BM, n);
  conv_bn_1x1_f32_kernel<<<grid, THREADS, 0, stream>>>(
      x, w, shift, y, part, c, h, wd, o, stride, wo, ho * wo);
  return reduce_stats(grid, part, o, s1, s2, stream);
}

template <int VEC>
cudaError_t launch_vec(const bf16* x, const bf16* w, const float* shift,
                       bf16* y, float* part, int n, int c, int h, int wd,
                       int o, int stride, int ho, int wo, dim3 grid,
                       cudaStream_t stream) {
  // stages ks % STAGES for ks < nsteps: the first min(nsteps, STAGES)
  const int nsteps = (c + TK - 1) / TK;
  const int smem = (nsteps < STAGES ? nsteps : STAGES) * STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      conv_bn_1x1_bf16_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, STAGES * STAGE_BYTES);
  if (err != cudaSuccess) return err;
  conv_bn_1x1_bf16_kernel<VEC><<<grid, MMA_THREADS, smem, stream>>>(
      x, w, shift, y, part, n, c, h, wd, o, stride, ho, wo);
  return cudaSuccess;
}

cudaError_t launch_bf16(const bf16* x, const bf16* w, const float* shift,
                        bf16* y, float* part, float* s1, float* s2, int n,
                        int c, int h, int wd, int o, int stride,
                        cudaStream_t stream) {
  const int ho = (h - 1) / stride + 1, wo = (wd - 1) / stride + 1;
  const long long npix = (long long)n * ho * wo;  // int pixel indices
  if (npix > (1LL << 30) || o > 65535 || c % 8 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  // the widest piece whose copies stay inside one sample's channel row
  // and aligned: HW and x's address both multiples of VEC elements
  const int hw = ho * wo;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int vec = stride == 1 ? 8 : 1;
  while (vec > 1 && (hw % vec || xa % (2 * vec))) vec /= 2;
  const dim3 grid((unsigned)((npix + TN - 1) / TN), (o + TM - 1) / TM);
  cudaError_t err;
  switch (vec) {
    case 8: err = launch_vec<8>(x, w, shift, y, part, n, c, h, wd, o, stride, ho, wo, grid, stream); break;
    case 4: err = launch_vec<4>(x, w, shift, y, part, n, c, h, wd, o, stride, ho, wo, grid, stream); break;
    case 2: err = launch_vec<2>(x, w, shift, y, part, n, c, h, wd, o, stride, ho, wo, grid, stream); break;
    default: err = launch_vec<1>(x, w, shift, y, part, n, c, h, wd, o, stride, ho, wo, grid, stream);
  }
  if (err != cudaSuccess) return err;
  return reduce_stats(grid, part, o, s1, s2, stream);
}

}  // namespace

extern "C" {

// x (N, C, H, W), w (O, C) of one dtype, y (N, O, Ho, Wo), Ho = (H - 1) /
// stride + 1. dtype 0: f32, the CUDA-core kernel, part (2, O, N *
// ceil(Ho*Wo / 64)); dtype 1: bf16, the tensor cores, C a multiple of 8
// and w 16-byte aligned, part (2, O, ceil(N*Ho*Wo / 128)). Returns a
// cudaError_t (0 on success).
int bigdl_conv_bn_1x1(const void* x, const void* w, const void* shift,
                      void* y, void* part, void* s1, void* s2, int n, int c,
                      int h, int wd, int o, int stride, int dtype,
                      void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || o <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sh = static_cast<const float*>(shift);
  auto pt = static_cast<float*>(part);
  auto a = static_cast<float*>(s1);
  auto b = static_cast<float*>(s2);
  if (dtype == 0)
    return (int)launch_f32(static_cast<const float*>(x),
                           static_cast<const float*>(w), sh,
                           static_cast<float*>(y), pt, a, b, n, c, h, wd, o,
                           stride, st);
  if (dtype == 1)
    return (int)launch_bf16(static_cast<const bf16*>(x),
                            static_cast<const bf16*>(w), sh,
                            static_cast<bf16*>(y), pt, a, b, n, c, h, wd, o,
                            stride, st);
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
