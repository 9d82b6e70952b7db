// Native pixel-gather kernels for the training batch pipeline: the port's
// copy of lab4d_tpu/native/src/sampler.cpp.
//
// The training step consumes a batch of frame pairs at sampled pixels of
// every modality. These kernels do the gathers - strided pixel reads from
// mmapped (T,H,W,C) tensors and bilinear feature sampling - in C++,
// exposed via a C ABI for ctypes (lab4d_tpu_torch/native/__init__.py,
// which also holds plain numpy versions that compute the same floats).
//
// Unlike lab4d_tpu/native/src/sampler.cpp, the loops run on the calling
// thread with no OpenMP team: a training batch gathers a few thousand
// pixels (128 pairs x 2 frames x 16 px), microseconds of work per call,
// and the loader already runs in worker threads. The values are the same.
//
// Replaces the role of torch DataLoader workers in the reference
// (lab4d/dataloader/vidloader.py:264-358).

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// half -> float conversion (IEEE 754 binary16), no F16C dependency
inline float half_to_float(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t f;
    if (exp == 0) {
        if (mant == 0) {
            f = sign;
        } else {
            // subnormal
            exp = 127 - 15 + 1;
            while ((mant & 0x400) == 0) {
                mant <<= 1;
                exp--;
            }
            mant &= 0x3FF;
            f = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        f = sign | 0x7F800000 | (mant << 13);
    } else {
        f = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &f, sizeof(out));
    return out;
}

template <typename T>
inline float load_as_float(const uint8_t* p);

template <>
inline float load_as_float<float>(const uint8_t* p) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
}

template <>
inline float load_as_float<uint16_t>(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return half_to_float(v);
}

template <>
inline float load_as_float<uint8_t>(const uint8_t* p) {
    return (float)(*p);
}

// dtype codes shared with the Python wrapper
enum DType { F32 = 0, F16 = 1, U8 = 2 };

inline size_t dtype_size(int dtype) {
    switch (dtype) {
        case F32: return 4;
        case F16: return 2;
        default: return 1;
    }
}

inline float load_any(const uint8_t* p, int dtype) {
    switch (dtype) {
        case F32: return load_as_float<float>(p);
        case F16: return load_as_float<uint16_t>(p);
        default: return load_as_float<uint8_t>(p);
    }
}

}  // namespace

extern "C" {

// Gather pixels from a (T, H, W, C) tensor.
//   fids: (n_frames,) frame indices
//   xys:  (n_frames, n_px, 2) pixel (x, y) int32
//   dst:  (n_frames, n_px, c_out) float32, c_out = c_end - c_begin
// Channel slice [c_begin, c_end) supports mask/vis2d splits.
void gather_pixels(const uint8_t* src, int64_t T, int64_t H, int64_t W,
                   int64_t C, int dtype, const int32_t* fids,
                   const int32_t* xys, int64_t n_frames, int64_t n_px,
                   int64_t c_begin, int64_t c_end, float* dst) {
    const size_t esz = dtype_size(dtype);
    const int64_t c_out = c_end - c_begin;
    (void)T;
    for (int64_t f = 0; f < n_frames; f++) {
        const uint8_t* frame = src + (size_t)fids[f] * H * W * C * esz;
        const int32_t* xy = xys + f * n_px * 2;
        float* out = dst + f * n_px * c_out;
        for (int64_t p = 0; p < n_px; p++) {
            int64_t x = xy[p * 2 + 0];
            int64_t y = xy[p * 2 + 1];
            const uint8_t* px = frame + ((size_t)y * W + x) * C * esz;
            for (int64_t c = 0; c < c_out; c++) {
                out[p * c_out + c] =
                    load_any(px + (c_begin + c) * esz, dtype);
            }
        }
    }
}

// Bilinear-sample a (T, Hf, Wf, C) feature tensor at fractional pixel
// coordinates derived from image-space xys scaled by `scale`.
//   dst: (n_frames, n_px, C) float32
void gather_features_bilinear(const uint8_t* src, int64_t T, int64_t Hf,
                              int64_t Wf, int64_t C, int dtype,
                              const int32_t* fids, const int32_t* xys,
                              int64_t n_frames, int64_t n_px, float scale,
                              float* dst) {
    const size_t esz = dtype_size(dtype);
    (void)T;
    for (int64_t f = 0; f < n_frames; f++) {
        const uint8_t* frame =
            src + (size_t)fids[f] * Hf * Wf * C * esz;
        const int32_t* xy = xys + f * n_px * 2;
        float* out = dst + f * n_px * C;
        for (int64_t p = 0; p < n_px; p++) {
            float fx = xy[p * 2 + 0] * scale;
            float fy = xy[p * 2 + 1] * scale;
            int64_t x0 = (int64_t)fx;
            int64_t y0 = (int64_t)fy;
            float ax = fx - x0;
            float ay = fy - y0;
            // clamp like the numpy reference (bilinear_interp)
            if (x0 < 0) x0 = 0;
            if (y0 < 0) y0 = 0;
            if (x0 > Wf - 2) x0 = Wf - 2;
            if (y0 > Hf - 2) y0 = Hf - 2;
            const uint8_t* q11 = frame + ((size_t)y0 * Wf + x0) * C * esz;
            const uint8_t* q12 = frame + ((size_t)y0 * Wf + x0 + 1) * C * esz;
            const uint8_t* q21 = frame + ((size_t)(y0 + 1) * Wf + x0) * C * esz;
            const uint8_t* q22 =
                frame + ((size_t)(y0 + 1) * Wf + x0 + 1) * C * esz;
            for (int64_t c = 0; c < C; c++) {
                float v11 = load_any(q11 + c * esz, dtype);
                float v12 = load_any(q12 + c * esz, dtype);
                float v21 = load_any(q21 + c * esz, dtype);
                float v22 = load_any(q22 + c * esz, dtype);
                out[p * C + c] = v11 * (1 - ax) * (1 - ay) +
                                 v21 * (1 - ax) * ay + v12 * ax * (1 - ay) +
                                 v22 * ax * ay;
            }
        }
    }
}

}  // extern "C"
