// Native host-side preprocessing: the decode->model gap of the frame
// pipeline (resize / center-crop / normalize / layout), threaded across
// frames. This is the TPU-native counterpart of the native transform
// code the reference rides inside PIL/mmcv/torchvision (SURVEY.md §2
// component 3/14) — the host CPUs must keep 8 chips fed, and per-frame
// Python/PIL calls are the bottleneck (SURVEY.md §7 hard part #5).
//
// Resize follows PIL's convolution-based BILINEAR: triangle filter whose
// support scales with the downsampling ratio (antialiased), half-pixel
// centers, computed in float (PIL quantizes coefficients to 8-bit fixed
// point, so outputs match PIL within ~1/255 per pixel — the native path
// is an opt-in throughput mode, --host_preprocess native).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (see native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tap {
    int lo;          // first source index
    int n;           // number of taps
    int coeff_off;   // offset into the coefficient array
};

// filter kernels, PIL semantics: 0 = BILINEAR (triangle, support 1),
// 1 = BICUBIC (Keys a=-0.5, support 2)
double filter_weight(int filter, double x) {
    x = std::abs(x);
    if (filter == 1) {
        const double a = -0.5;
        if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
        if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
        return 0.0;
    }
    return x < 1.0 ? 1.0 - x : 0.0;
}

// PIL-style antialiased filter taps for size in -> out (support scales
// with the downsampling ratio, half-pixel centers).
void build_taps(int in_size, int out_size, int filter, std::vector<Tap>& taps,
                std::vector<float>& coeffs) {
    const double scale = static_cast<double>(in_size) / out_size;
    const double fscale = scale < 1.0 ? 1.0 : scale;
    const double support = (filter == 1 ? 2.0 : 1.0) * fscale;
    taps.resize(out_size);
    coeffs.clear();
    for (int i = 0; i < out_size; ++i) {
        const double center = (i + 0.5) * scale;
        int lo = static_cast<int>(std::floor(center - support + 0.5));
        int hi = static_cast<int>(std::floor(center + support + 0.5));
        lo = std::max(lo, 0);
        hi = std::min(hi, in_size);
        Tap t{lo, hi - lo, static_cast<int>(coeffs.size())};
        double total = 0.0;
        for (int j = lo; j < hi; ++j) {
            const double w = filter_weight(filter, (j + 0.5 - center) / fscale);
            coeffs.push_back(static_cast<float>(w));
            total += w;
        }
        if (total != 0.0) {
            for (int j = 0; j < t.n; ++j)
                coeffs[t.coeff_off + j] /= static_cast<float>(total);
        }
        taps[i] = t;
    }
}

// PIL rounds + clips to uint8 BETWEEN the separable passes and after the
// final one (ImagingResample's 8bpc path) — with bicubic's negative
// lobes the clipping is visible at hard edges, so parity requires
// quantizing exactly where PIL does.
inline float quant8(float v) {
    return std::min(255.0f, std::max(0.0f, std::nearbyint(v)));
}

// Resize one HWC uint8 frame to (oh, ow) float HWC via separable passes.
void resize_frame(const uint8_t* src, int h, int w, float* dst, int oh, int ow,
                  const std::vector<Tap>& ytaps, const std::vector<float>& ycoef,
                  const std::vector<Tap>& xtaps, const std::vector<float>& xcoef,
                  float* tmp /* h * ow * 3 */) {
    // horizontal pass: (h, w, 3) u8 -> (h, ow, 3) f32
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
        float* trow = tmp + static_cast<size_t>(y) * ow * 3;
        for (int x = 0; x < ow; ++x) {
            const Tap& t = xtaps[x];
            float acc[3] = {0.f, 0.f, 0.f};
            for (int k = 0; k < t.n; ++k) {
                const float c = xcoef[t.coeff_off + k];
                const uint8_t* p = row + static_cast<size_t>(t.lo + k) * 3;
                acc[0] += c * p[0];
                acc[1] += c * p[1];
                acc[2] += c * p[2];
            }
            float* o = trow + static_cast<size_t>(x) * 3;
            o[0] = quant8(acc[0]); o[1] = quant8(acc[1]); o[2] = quant8(acc[2]);
        }
    }
    // vertical pass: (h, ow, 3) -> (oh, ow, 3)
    for (int y = 0; y < oh; ++y) {
        const Tap& t = ytaps[y];
        float* orow = dst + static_cast<size_t>(y) * ow * 3;
        std::memset(orow, 0, sizeof(float) * ow * 3);
        for (int k = 0; k < t.n; ++k) {
            const float c = ycoef[t.coeff_off + k];
            const float* trow = tmp + static_cast<size_t>(t.lo + k) * ow * 3;
            for (int i = 0; i < ow * 3; ++i) orow[i] += c * trow[i];
        }
        for (int i = 0; i < ow * 3; ++i) orow[i] = quant8(orow[i]);
    }
}

}  // namespace

namespace {

// Shared chain for a batch of same-sized frames: resize smaller edge ->
// resize_to (aspect kept, `filter` kernel), center-crop crop x crop,
// /255, normalize (mean/std per channel), emit NCHW float32.
void preprocess_batch_impl(const uint8_t* src, int n, int h, int w,
                           int resize_to, int crop, int filter,
                           const float* mean, const float* stddev,
                           float* out, int threads) {
    int oh, ow;
    if (h <= w) {
        oh = resize_to;
        ow = static_cast<int>(static_cast<int64_t>(resize_to) * w / h);
    } else {
        ow = resize_to;
        oh = static_cast<int>(static_cast<int64_t>(resize_to) * h / w);
    }
    std::vector<Tap> ytaps, xtaps;
    std::vector<float> ycoef, xcoef;
    build_taps(h, oh, filter, ytaps, ycoef);
    build_taps(w, ow, filter, xtaps, xcoef);

    // round-half-to-even, matching Python round() in the PIL chain
    const int top = static_cast<int>(std::nearbyint((oh - crop) / 2.0));
    const int left = static_cast<int>(std::nearbyint((ow - crop) / 2.0));
    const float inv255 = 1.0f / 255.0f;

    auto work = [&](int begin, int end) {
        std::vector<float> resized(static_cast<size_t>(oh) * ow * 3);
        std::vector<float> tmp(static_cast<size_t>(h) * ow * 3);
        for (int f = begin; f < end; ++f) {
            resize_frame(src + static_cast<size_t>(f) * h * w * 3, h, w,
                         resized.data(), oh, ow, ytaps, ycoef, xtaps, xcoef,
                         tmp.data());
            float* o = out + static_cast<size_t>(f) * 3 * crop * crop;
            for (int c = 0; c < 3; ++c) {
                const float m = mean[c], inv_s = 1.0f / stddev[c];
                float* oc = o + static_cast<size_t>(c) * crop * crop;
                for (int y = 0; y < crop; ++y) {
                    const float* r =
                        resized.data() +
                        (static_cast<size_t>(top + y) * ow + left) * 3 + c;
                    for (int x = 0; x < crop; ++x)
                        oc[static_cast<size_t>(y) * crop + x] =
                            (r[static_cast<size_t>(x) * 3] * inv255 - m) * inv_s;
                }
            }
        }
    };

    threads = std::max(1, std::min(threads, n));
    if (threads == 1) {
        work(0, n);
        return;
    }
    std::vector<std::thread> pool;
    const int per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        const int b = t * per, e = std::min(n, b + per);
        if (b < e) pool.emplace_back(work, b, e);
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// torchvision chain (ResNet family): BILINEAR resize.
void imagenet_preprocess_batch(const uint8_t* src, int n, int h, int w,
                               int resize_to, int crop,
                               const float* mean, const float* stddev,
                               float* out, int threads) {
    preprocess_batch_impl(src, n, h, w, resize_to, crop, /*filter=*/0, mean,
                          stddev, out, threads);
}

// CLIP chain (pip `clip` preprocess): BICUBIC resize of the smaller edge
// straight to the crop size, then the same crop/normalize.
void clip_preprocess_batch(const uint8_t* src, int n, int h, int w, int size,
                           const float* mean, const float* stddev, float* out,
                           int threads) {
    preprocess_batch_impl(src, n, h, w, size, size, /*filter=*/1, mean, stddev,
                          out, threads);
}

}  // extern "C"
