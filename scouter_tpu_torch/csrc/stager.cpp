// Host-side image staging for the port's data loader: the port's own copy of
// scouter_tpu/native/stager.cpp, plus the PNG row unfilter that
// core/png.py's reader calls.
//
//   - resize_batch_u8: batched bilinear uint8 resize (half-pixel centers,
//     jax.image.resize(method='bilinear', antialias=False)), the same
//     arithmetic as the JAX package's copy
//   - gather_items_u8: batched gather of whole items into a contiguous
//     buffer, the Loader's per-batch assembly of an in-memory dataset
//   - png_unfilter: undo the five PNG row filters (None, Sub, Up, Average,
//     Paeth). Average and Paeth depend on the pixel to the left, so a row is
//     walked byte by byte; rows depend on the row above, so one image is one
//     sequential pass.
//
// Plain C ABI for ctypes. data/native_stager.py builds it at first use:
// g++ -O3 -march=native -shared -fPIC -o libstager-<hash>.so stager.cpp -lpthread

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

void resize_one_bilinear(const uint8_t* src, int h, int w, int c,
                         uint8_t* dst, int oh, int ow) {
    const float sy = static_cast<float>(h) / oh;
    const float sx = static_cast<float>(w) / ow;
    for (int oy = 0; oy < oh; ++oy) {
        float fy = (oy + 0.5f) * sy - 0.5f;
        int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);
        float wy = fy - y0;
        int y0c = std::min(std::max(y0, 0), h - 1);
        int y1c = std::min(std::max(y0 + 1, 0), h - 1);
        for (int ox = 0; ox < ow; ++ox) {
            float fx = (ox + 0.5f) * sx - 0.5f;
            int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);
            float wx = fx - x0;
            int x0c = std::min(std::max(x0, 0), w - 1);
            int x1c = std::min(std::max(x0 + 1, 0), w - 1);
            const uint8_t* p00 = src + (static_cast<int64_t>(y0c) * w + x0c) * c;
            const uint8_t* p01 = src + (static_cast<int64_t>(y0c) * w + x1c) * c;
            const uint8_t* p10 = src + (static_cast<int64_t>(y1c) * w + x0c) * c;
            const uint8_t* p11 = src + (static_cast<int64_t>(y1c) * w + x1c) * c;
            uint8_t* out = dst + (static_cast<int64_t>(oy) * ow + ox) * c;
            for (int ch = 0; ch < c; ++ch) {
                float top = p00[ch] * (1.0f - wx) + p01[ch] * wx;
                float bot = p10[ch] * (1.0f - wx) + p11[ch] * wx;
                float v = top * (1.0f - wy) + bot * wy;
                out[ch] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

void parallel_for(int n, int nthreads, const std::function<void(int)>& fn) {
    nthreads = std::max(1, std::min(nthreads, n));
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
        threads.emplace_back([=, &fn]() {
            for (int i = t; i < n; i += nthreads) fn(i);
        });
    }
    for (auto& th : threads) th.join();
}

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// src: (n, h, w, c) uint8 contiguous; dst: (n, oh, ow, c)
void resize_batch_u8(const uint8_t* src, int n, int h, int w, int c,
                     uint8_t* dst, int oh, int ow, int nthreads) {
    const int64_t in_stride = static_cast<int64_t>(h) * w * c;
    const int64_t out_stride = static_cast<int64_t>(oh) * ow * c;
    parallel_for(n, nthreads, [&](int i) {
        resize_one_bilinear(src + i * in_stride, h, w, c,
                            dst + i * out_stride, oh, ow);
    });
}

// dst[i] = src[indices[i]] for n_out indices over items of item_bytes; the
// caller has checked every index
void gather_items_u8(const uint8_t* src, const int64_t* indices, int n_out,
                     int64_t item_bytes, uint8_t* dst, int nthreads) {
    parallel_for(n_out, nthreads, [&](int i) {
        std::memcpy(dst + static_cast<int64_t>(i) * item_bytes,
                    src + indices[i] * item_bytes,
                    static_cast<size_t>(item_bytes));
    });
}

// raw: h rows of (1 + rowbytes) bytes, each a filter type then the filtered
// row; out: h rows of rowbytes. bpp: bytes of one whole pixel, at least 1
// (PNG's left neighbour for sub-byte depths is the byte before). Returns 0,
// or 1 + the index of the first row whose filter type is not 0-4.
int png_unfilter(const uint8_t* raw, int h, int64_t rowbytes, int bpp, uint8_t* out) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* in = raw + static_cast<int64_t>(y) * (rowbytes + 1);
        const uint8_t filter = in[0];
        ++in;
        uint8_t* row = out + static_cast<int64_t>(y) * rowbytes;
        const uint8_t* up = y ? row - rowbytes : nullptr;
        switch (filter) {
            case 0:
                std::memcpy(row, in, static_cast<size_t>(rowbytes));
                break;
            case 1:
                for (int64_t x = 0; x < rowbytes; ++x)
                    row[x] = in[x] + (x >= bpp ? row[x - bpp] : 0);
                break;
            case 2:
                for (int64_t x = 0; x < rowbytes; ++x) row[x] = in[x] + (up ? up[x] : 0);
                break;
            case 3:
                for (int64_t x = 0; x < rowbytes; ++x) {
                    int a = x >= bpp ? row[x - bpp] : 0, b = up ? up[x] : 0;
                    row[x] = in[x] + static_cast<uint8_t>((a + b) >> 1);
                }
                break;
            case 4:
                for (int64_t x = 0; x < rowbytes; ++x) {
                    int a = x >= bpp ? row[x - bpp] : 0, b = up ? up[x] : 0;
                    int c = (x >= bpp && up) ? up[x - bpp] : 0;
                    row[x] = in[x] + paeth(a, b, c);
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}

}  // extern "C"
