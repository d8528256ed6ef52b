// framepipe: host-side uint8 frame pipeline for the video data loader (the
// port's own copy of native/framepipe.cpp).
//
// The loader decodes with cv2 and prepares frames here: batched bilinear
// resize (half-pixel centers, matching torch align_corners=False / cv2
// INTER_LINEAR semantics) and Inception-style crop+resize, multithreaded
// across frames with std::thread. Exposed with a plain C ABI for ctypes.
//
// Built at first use by gava_clip_tpu_torch/data/native.py:
//   g++ -O3 -std=c++17 -fPIC -shared -pthread -o libframepipe.so framepipe.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Bilinear-resize one HWC uint8 frame region [top:top+h, left:left+w] to
// (new_h, new_w), half-pixel center sampling, edge clamping.
void resize_frame(const uint8_t* src, int H, int W, int C,
                  int top, int left, int h, int w,
                  uint8_t* dst, int new_h, int new_w) {
    const float scale_y = static_cast<float>(h) / new_h;
    const float scale_x = static_cast<float>(w) / new_w;

    std::vector<int> x0s(new_w), x1s(new_w);
    std::vector<float> wxs(new_w);
    for (int x = 0; x < new_w; ++x) {
        float sx = (x + 0.5f) * scale_x - 0.5f;
        float fx = std::floor(sx);
        wxs[x] = sx - fx;
        int xi = static_cast<int>(fx);
        x0s[x] = std::min(std::max(xi, 0), w - 1) + left;
        x1s[x] = std::min(std::max(xi + 1, 0), w - 1) + left;
    }

    for (int y = 0; y < new_h; ++y) {
        float sy = (y + 0.5f) * scale_y - 0.5f;
        float fy = std::floor(sy);
        float wy = sy - fy;
        int yi = static_cast<int>(fy);
        int y0 = std::min(std::max(yi, 0), h - 1) + top;
        int y1 = std::min(std::max(yi + 1, 0), h - 1) + top;
        const uint8_t* row0 = src + (static_cast<size_t>(y0) * W) * C;
        const uint8_t* row1 = src + (static_cast<size_t>(y1) * W) * C;
        uint8_t* out = dst + (static_cast<size_t>(y) * new_w) * C;
        for (int x = 0; x < new_w; ++x) {
            float wx = wxs[x];
            const uint8_t* p00 = row0 + static_cast<size_t>(x0s[x]) * C;
            const uint8_t* p01 = row0 + static_cast<size_t>(x1s[x]) * C;
            const uint8_t* p10 = row1 + static_cast<size_t>(x0s[x]) * C;
            const uint8_t* p11 = row1 + static_cast<size_t>(x1s[x]) * C;
            for (int c = 0; c < C; ++c) {
                float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                          wy * ((1 - wx) * p10[c] + wx * p11[c]);
                out[static_cast<size_t>(x) * C + c] =
                    static_cast<uint8_t>(std::min(std::max(v + 0.5f, 0.0f), 255.0f));
            }
        }
    }
}

void parallel_frames(int T, int num_threads,
                     const std::function<void(int)>& fn) {
    if (num_threads <= 1 || T <= 1) {
        for (int t = 0; t < T; ++t) fn(t);
        return;
    }
    int n = std::min(num_threads, T);
    std::vector<std::thread> threads;
    threads.reserve(n);
    for (int i = 0; i < n; ++i) {
        threads.emplace_back([&, i]() {
            for (int t = i; t < T; t += n) fn(t);
        });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Resize all T frames (T, H, W, C) -> (T, new_h, new_w, C).
void fp_resize_bilinear_u8(const uint8_t* src, int T, int H, int W, int C,
                           uint8_t* dst, int new_h, int new_w,
                           int num_threads) {
    const size_t in_stride = static_cast<size_t>(H) * W * C;
    const size_t out_stride = static_cast<size_t>(new_h) * new_w * C;
    parallel_frames(T, num_threads, [&](int t) {
        resize_frame(src + t * in_stride, H, W, C, 0, 0, H, W,
                     dst + t * out_stride, new_h, new_w);
    });
}

// Crop region [top:top+h, left:left+w] of each frame, then resize — the
// temporally-consistent random-resized-crop hot path.
void fp_crop_resize_u8(const uint8_t* src, int T, int H, int W, int C,
                       int top, int left, int h, int w,
                       uint8_t* dst, int new_h, int new_w, int num_threads) {
    const size_t in_stride = static_cast<size_t>(H) * W * C;
    const size_t out_stride = static_cast<size_t>(new_h) * new_w * C;
    parallel_frames(T, num_threads, [&](int t) {
        resize_frame(src + t * in_stride, H, W, C, top, left, h, w,
                     dst + t * out_stride, new_h, new_w);
    });
}

// Plain center crop (memcpy rows) — no interpolation.
void fp_center_crop_u8(const uint8_t* src, int T, int H, int W, int C,
                       uint8_t* dst, int size, int num_threads) {
    const int top = (H - size) / 2;
    const int left = (W - size) / 2;
    const size_t in_stride = static_cast<size_t>(H) * W * C;
    const size_t out_stride = static_cast<size_t>(size) * size * C;
    parallel_frames(T, num_threads, [&](int t) {
        const uint8_t* s = src + t * in_stride;
        uint8_t* d = dst + t * out_stride;
        for (int y = 0; y < size; ++y) {
            std::memcpy(d + static_cast<size_t>(y) * size * C,
                        s + ((static_cast<size_t>(top) + y) * W + left) * C,
                        static_cast<size_t>(size) * C);
        }
    });
}

}  // extern "C"
