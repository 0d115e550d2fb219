// The port's host library: the input feed's data plane in C++.
//
// Counterpart of native/bigdl_tpu_native.cpp, the JAX package's: the
// same functions with the same plain C ABI (ctypes, no pybind11), so
// the two compute the same bits.  The card runs the model; these run on
// the host around it, where C++ beats Python by releasing the GIL and
// touching memory once: the fp16 wire codec, the minibatch row gather
// (multi-threaded) and uint8 gather+normalize, and the OpenCV-style
// image ops on CHW float32.  bigdl_tpu_torch/native/__init__.py builds
// this file with g++ at first use.  Every function is thread-safe and
// works on caller-owned buffers.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// fp16 codec — FP16CompressedTensor parity («bigdl»/parameters/
// FP16CompressedTensor.scala truncates to sign+exp+7 mantissa bits; we
// keep IEEE half with round-to-nearest-even, strictly more accurate on
// the same 16-bit budget)
// --------------------------------------------------------------------------

static inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t  exp  = (int32_t)((x >> 23) & 0xffu) - 127 + 15;
    uint32_t mant = x & 0x7fffffu;
    if (exp >= 0x1f) {                      // inf / nan / overflow
        uint16_t m = (((x >> 23) & 0xffu) == 0xffu && mant) ? 0x200u : 0u;
        return (uint16_t)(sign | 0x7c00u | m);
    }
    if (exp <= 0) {                         // subnormal / underflow
        if (exp < -10) return (uint16_t)sign;
        mant |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t half = mant >> shift;
        uint32_t rem  = mant & ((1u << shift) - 1u);
        uint32_t mid  = 1u << (shift - 1);
        if (rem > mid || (rem == mid && (half & 1u))) half++;
        return (uint16_t)(sign | half);
    }
    uint32_t half = ((uint32_t)exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1fffu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
    return (uint16_t)(sign | half);
}

static inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp  = (h >> 10) & 0x1fu;
    uint32_t mant = h & 0x3ffu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) { x = sign; }
        else {
            exp = 127 - 15 + 1;
            while (!(mant & 0x400u)) { mant <<= 1; exp--; }
            mant &= 0x3ffu;
            x = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 0x1f) {
        x = sign | 0x7f800000u | (mant << 13);
    } else {
        x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

void fp16_compress(const float* src, uint16_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) dst[i] = f32_to_f16(src[i]);
}

void fp16_decompress(const uint16_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) dst[i] = f16_to_f32(src[i]);
}

// --------------------------------------------------------------------------
// minibatch assembly — shuffled row gather (+ optional normalize) in one
// memory pass; the multi-threaded variant splits rows across threads
// with the GIL released on the Python side
// --------------------------------------------------------------------------

void gather_rows(const float* src, const int64_t* idx, float* dst,
                 int64_t n_rows, int64_t row_len) {
    for (int64_t i = 0; i < n_rows; i++)
        std::memcpy(dst + i * row_len, src + idx[i] * row_len,
                    (size_t)row_len * 4);
}

void gather_rows_mt(const float* src, const int64_t* idx, float* dst,
                    int64_t n_rows, int64_t row_len, int n_threads) {
    if (n_threads <= 1 || n_rows < 2 * n_threads) {
        gather_rows(src, idx, dst, n_rows, row_len);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo = t * chunk, hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back([=] {
            gather_rows(src + 0, idx + lo, dst + lo * row_len,
                        hi - lo, row_len);
        });
    }
    for (auto& th : pool) th.join();
}

// gather uint8 rows and convert to normalized float in one pass:
// dst = (u8 - mean[c]) / std[c], channel-major rows (C*H*W)
void gather_normalize_u8(const uint8_t* src, const int64_t* idx, float* dst,
                         int64_t n_rows, int64_t channels, int64_t hw,
                         const float* mean, const float* stdev) {
    int64_t row_len = channels * hw;
    for (int64_t i = 0; i < n_rows; i++) {
        const uint8_t* in = src + idx[i] * row_len;
        float* out = dst + i * row_len;
        for (int64_t c = 0; c < channels; c++) {
            float m = mean[c], inv = 1.0f / stdev[c];
            const uint8_t* ic = in + c * hw;
            float* oc = out + c * hw;
            for (int64_t p = 0; p < hw; p++)
                oc[p] = ((float)ic[p] - m) * inv;
        }
    }
}

// --------------------------------------------------------------------------
// image ops — the OpenCV-JNI replacements (CHW float32 images)
// --------------------------------------------------------------------------

// bilinear resize, CHW float32 (align_corners=false, OpenCV-compatible
// half-pixel centers)
void resize_bilinear_chw(const float* src, float* dst,
                         int64_t c, int64_t in_h, int64_t in_w,
                         int64_t out_h, int64_t out_w) {
    float sy = (float)in_h / (float)out_h;
    float sx = (float)in_w / (float)out_w;
    for (int64_t y = 0; y < out_h; y++) {
        float fy = ((float)y + 0.5f) * sy - 0.5f;
        int64_t y0 = (int64_t)std::floor(fy);
        float wy = fy - (float)y0;
        int64_t y0c = std::clamp(y0, (int64_t)0, in_h - 1);
        int64_t y1c = std::clamp(y0 + 1, (int64_t)0, in_h - 1);
        for (int64_t x = 0; x < out_w; x++) {
            float fx = ((float)x + 0.5f) * sx - 0.5f;
            int64_t x0 = (int64_t)std::floor(fx);
            float wx = fx - (float)x0;
            int64_t x0c = std::clamp(x0, (int64_t)0, in_w - 1);
            int64_t x1c = std::clamp(x0 + 1, (int64_t)0, in_w - 1);
            for (int64_t ch = 0; ch < c; ch++) {
                const float* p = src + ch * in_h * in_w;
                float v00 = p[y0c * in_w + x0c];
                float v01 = p[y0c * in_w + x1c];
                float v10 = p[y1c * in_w + x0c];
                float v11 = p[y1c * in_w + x1c];
                float top = v00 + (v01 - v00) * wx;
                float bot = v10 + (v11 - v10) * wx;
                dst[ch * out_h * out_w + y * out_w + x] =
                    top + (bot - top) * wy;
            }
        }
    }
}

// crop a (c, h, w) window starting at (y, x)
void crop_chw(const float* src, float* dst,
              int64_t c, int64_t in_h, int64_t in_w,
              int64_t y, int64_t x, int64_t out_h, int64_t out_w) {
    for (int64_t ch = 0; ch < c; ch++)
        for (int64_t r = 0; r < out_h; r++)
            std::memcpy(dst + (ch * out_h + r) * out_w,
                        src + (ch * in_h + (y + r)) * in_w + x,
                        (size_t)out_w * 4);
}

// horizontal flip in place-safe form (src != dst)
void hflip_chw(const float* src, float* dst,
               int64_t c, int64_t h, int64_t w) {
    for (int64_t ch = 0; ch < c; ch++)
        for (int64_t r = 0; r < h; r++) {
            const float* in = src + (ch * h + r) * w;
            float* out = dst + (ch * h + r) * w;
            for (int64_t x = 0; x < w; x++) out[x] = in[w - 1 - x];
        }
}

// per-channel normalize in place: data = (data - mean[c]) / std[c]
void normalize_chw(float* data, int64_t c, int64_t hw,
                   const float* mean, const float* stdev) {
    for (int64_t ch = 0; ch < c; ch++) {
        float m = mean[ch], inv = 1.0f / stdev[ch];
        float* p = data + ch * hw;
        for (int64_t i = 0; i < hw; i++) p[i] = (p[i] - m) * inv;
    }
}

int native_abi_version() { return 1; }

}  // extern "C"
