// Native render buffer: linear accumulation + tonemapped readout.
//
// Parity role: gui/src/render_buffer.cu (CudaRenderBuffer) — the
// reference viewer accumulates spp frames into a float surface and
// tonemaps (exposure scale + sRGB transfer) into the display buffer.
// Host-side C++ here: the web viewer / preview path accumulates
// multiple rasterized preview frames (progressive refinement of the
// point-cloud splat) and reads out uint8.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC render_buffer.cpp -o
//        librender_buffer.so  (done on demand by render_buffer.py)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// accum += frame (linear float RGB[A]); n_acc tracks the running count.
// frame: (H*W*C) float32, accum: same shape.
void rb_accumulate(float* accum, const float* frame, int64_t n) {
    for (int64_t i = 0; i < n; ++i) accum[i] += frame[i];
}

static inline float srgb(float x) {
    // IEC 61966-2-1 transfer (render_buffer.cu linear_to_srgb)
    if (x <= 0.0031308f) return 12.92f * x;
    return 1.055f * std::pow(x, 1.0f / 2.4f) - 0.055f;
}

// Tonemapped readout: out_u8 = srgb(clamp(accum / spp * 2^exposure)).
// srgb_transfer=0 emits linear (for EXR-style consumers).
void rb_readout(const float* accum, int64_t n, float spp, float exposure,
                int srgb_transfer, uint8_t* out_u8) {
    const float scale = std::pow(2.0f, exposure) / (spp > 0 ? spp : 1.0f);
    for (int64_t i = 0; i < n; ++i) {
        float v = accum[i] * scale;
        v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        if (srgb_transfer) v = srgb(v);
        float q = v * 255.0f + 0.5f;
        out_u8[i] = (uint8_t)(q > 255.0f ? 255.0f : q);
    }
}

}  // extern "C"
