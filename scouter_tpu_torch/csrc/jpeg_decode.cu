// JPEG decoding on the card: a plain-C shim over nvJPEG for ctypes
// (data/_decode.py), built by ops/cuda_build.py and linked with -lnvjpeg.
//
// Replaces the host decode of the JAX package's folder reader
// (scouter_tpu/data/streaming.py::FolderDataset._decode, Pillow on the
// host). That is not a Pallas kernel, and neither is this: nvJPEG is the
// library counterpart, as cuDNN is for the convolutions. The Huffman pass
// runs on the calling host thread, the IDCT and colour conversion on the
// card, on the stream the caller passes (torch's current stream), into a
// uint8 buffer that torch allocated. Nothing here allocates device memory
// for the caller or synchronises.
//
// One handle serves the process (nvJPEG's handle is thread-safe); a state
// holds one decode's intermediates and is used by one host thread at a time,
// so the wrapper keeps one state per thread. Both live as long as the
// process, as the loaded libraries do.
//
// Four-component JPEGs (CMYK, or YCCK: Adobe transform 2) are decoded into
// their planes as stored, each component at its own size
// (NVJPEG_OUTPUT_UNCHANGED); cmyk_to_rgb_kernel then upsamples each as
// libjpeg does under Pillow and gives the pixels Pillow gives them. Pillow (JpegImagePlugin) reads every
// four-layer JPEG with the raw mode "CMYK;I", inverted as Adobe writes it,
// after libjpeg turned YCCK into CMYK (jdcolor.c's ycck_cmyk_convert), and
// convert("RGB") applies Convert.c's cmyk2rgb. That conversion replaces no
// Pallas kernel either: it is Pillow's host arithmetic, moved to the card
// beside the decode, and data/_decode.py::cmyk_to_rgb_ref is its plain
// version. One byte in a stored sample and three out a pixel: bytes bound
// it.

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

// libjpeg's YCC-to-RGB tables (jdcolor.c, build_ycc_rgb_table): SCALEBITS 16,
// ONE_HALF 1 << 15, FIX(x) = x * 65536 + 0.5 rounded down; shifts of
// negative values arithmetic, as libjpeg's RIGHT_SHIFT
constexpr int kScaleBits = 16, kOneHalf = 1 << 15;
constexpr int kFixCrR = 91881, kFixCbB = 116130, kFixCrG = 46802, kFixCbG = 22554;

__device__ __forceinline__ int clip8(int x) { return x < 0 ? 0 : (x > 255 ? 255 : x); }

// Each component's size and its offset in the planes' buffer; the image's
// size is the largest.
struct PlaneSizes {
  int h[4], w[4];
  long long off[4];
};

// Sample (y, x) of the image from a component of (hc, wc) stored samples at
// p, upsampled as libjpeg-turbo upsamples it under Pillow (jdsample.c,
// do_fancy_upsampling on): the triangle filter for 2x horizontal
// (h2v1_fancy_upsample, where the component is wider than 2 samples), 2x
// vertical (h1v2_fancy_upsample) and both (h2v2_fancy_upsample, wider than
// 2), with the edge sample repeated as libjpeg's context rows repeat it;
// replication otherwise (h2v1_upsample, h2v2_upsample, int_upsample).
__device__ __forceinline__ int upsampled(const unsigned char* __restrict__ p, int hc, int wc,
                                         int vx, int hx, int y, int x) {
  if (hx == 1 && vx == 1) return p[(long long)y * wc + x];
  if (hx == 2 && vx == 1 && wc > 2) {
    const int i = x >> 1, odd = x & 1;
    const int n = odd ? min(i + 1, wc - 1) : max(i - 1, 0);
    const unsigned char* row = p + (long long)y * wc;
    return (3 * row[i] + row[n] + 1 + odd) >> 2;
  }
  if (hx == 1 && vx == 2) {
    const int j = y >> 1, odd = y & 1, jn = odd ? min(j + 1, hc - 1) : max(j - 1, 0);
    return (3 * p[(long long)j * wc + x] + p[(long long)jn * wc + x] + 1 + odd) >> 2;
  }
  if (hx == 2 && vx == 2 && wc > 2) {
    const int j = y >> 1, jn = (y & 1) ? min(j + 1, hc - 1) : max(j - 1, 0);
    const unsigned char* r0 = p + (long long)j * wc;
    const unsigned char* r1 = p + (long long)jn * wc;
    const int i = x >> 1, odd = x & 1, n = odd ? min(i + 1, wc - 1) : max(i - 1, 0);
    const int cs = 3 * r0[i] + r1[i], cn = 3 * r0[n] + r1[n];
    return (3 * cs + cn + 8 - odd) >> 4;
  }
  return p[(long long)(y / vx) * wc + x / hx];
}

// Per pixel of the image: each component upsampled to the image's size,
// then YCCK to CMYK where `ycck` (libjpeg), the Adobe inversion (Pillow's
// "CMYK;I") and cmyk2rgb of Pillow >= 9.1: nk = 255 - k; out = clip(nk -
// MULDIV255(c, nk)) with MULDIV255(a, b) = (t + (t >> 8)) >> 8, t = a b +
// 128. rgb (height, width, 3) uint8.
__global__ void cmyk_to_rgb_kernel(const unsigned char* __restrict__ planes, PlaneSizes sz,
                                   int height, int width, int ycck,
                                   unsigned char* __restrict__ rgb) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)height * width) return;
  const int y = (int)(i / width), x = (int)(i - (long long)y * width);
  int v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int hc = sz.h[q], wc = sz.w[q];
    v[q] = upsampled(planes + sz.off[q], hc, wc, (height + hc - 1) / hc, (width + wc - 1) / wc,
                     y, x);
  }
  int c = v[0], m = v[1], yy = v[2];
  const int k = v[3];
  if (ycck) {
    const int luma = c, cb = m - 128, cr = yy - 128;
    c = clip8(255 - (luma + ((kFixCrR * cr + kOneHalf) >> kScaleBits)));
    m = clip8(255 - (luma + ((-kFixCbG * cb + kOneHalf - kFixCrG * cr) >> kScaleBits)));
    yy = clip8(255 - (luma + ((kFixCbB * cb + kOneHalf) >> kScaleBits)));
  }
  const int nk = k;  // 255 - (255 - k): the inverted K
  const int cmy[3] = {255 - c, 255 - m, 255 - yy};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int t = cmy[q] * nk + 128;
    rgb[3 * i + q] = (unsigned char)clip8(nk - ((t + (t >> 8)) >> 8));
  }
}

}  // namespace

extern "C" {

int jpeg_handle_create(void** handle) {
    return static_cast<int>(nvjpegCreateSimple(reinterpret_cast<nvjpegHandle_t*>(handle)));
}

int jpeg_state_create(void* handle, void** state) {
    return static_cast<int>(nvjpegJpegStateCreate(
        static_cast<nvjpegHandle_t>(handle), reinterpret_cast<nvjpegJpegState_t*>(state)));
}

// components, chroma subsampling (nvjpegChromaSubsampling_t) and the size
// of each component (NVJPEG_MAX_COMPONENT = 4 entries each; component 0's
// is the image's size)
int jpeg_image_info(void* handle, const unsigned char* data, size_t length,
                    int* components, int* subsampling, int* widths, int* heights) {
    nvjpegChromaSubsampling_t css;
    nvjpegStatus_t st = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length,
                                           components, &css, widths, heights);
    *subsampling = static_cast<int>(css);
    return static_cast<int>(st);
}

// Decode into one interleaved plane: output_format NVJPEG_OUTPUT_RGBI (5)
// with pitch 3 * width, or NVJPEG_OUTPUT_Y (2) with pitch width. Returns
// nvJPEG's status, or 100 + the CUDA error if a launch was refused.
int jpeg_decode(void* handle, void* state, const unsigned char* data, size_t length,
                int output_format, unsigned char* out, size_t pitch, void* stream) {
    nvjpegImage_t dst = {};
    dst.channel[0] = out;
    dst.pitch[0] = pitch;
    nvjpegStatus_t st = nvjpegDecode(static_cast<nvjpegHandle_t>(handle),
                                     static_cast<nvjpegJpegState_t>(state), data, length,
                                     static_cast<nvjpegOutputFormat_t>(output_format), &dst,
                                     static_cast<cudaStream_t>(stream));
    if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
    cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? 0 : 100 + static_cast<int>(err);
}

// Decode a four-component JPEG into its planes as stored, each component at
// its own size (NVJPEG_OUTPUT_UNCHANGED): component c, heights[c] x
// widths[c] uint8, at out + the sizes of the components before it. Returns
// as jpeg_decode.
int jpeg_decode_planes(void* handle, void* state, const unsigned char* data, size_t length,
                       unsigned char* out, const int* widths, const int* heights, void* stream) {
    nvjpegImage_t dst = {};
    size_t off = 0;
    for (int c = 0; c < 4; ++c) {
        dst.channel[c] = out + off;
        dst.pitch[c] = widths[c];
        off += (size_t)widths[c] * heights[c];
    }
    nvjpegStatus_t st = nvjpegDecode(static_cast<nvjpegHandle_t>(handle),
                                     static_cast<nvjpegJpegState_t>(state), data, length,
                                     NVJPEG_OUTPUT_UNCHANGED, &dst,
                                     static_cast<cudaStream_t>(stream));
    if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
    cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? 0 : 100 + static_cast<int>(err);
}

// cmyk_to_rgb_kernel on `stream`: planes as jpeg_decode_planes lays them
// out (component c heights[c] x widths[c]), rgb (height, width, 3) with the
// image's size the largest component's; returns 0 or the CUDA error.
int jpeg_cmyk_to_rgb(const unsigned char* planes, const int* widths, const int* heights,
                     int ycck, unsigned char* rgb, void* stream) {
    PlaneSizes sz;
    long long off = 0;
    int width = 0, height = 0;
    for (int c = 0; c < 4; ++c) {
        sz.w[c] = widths[c];
        sz.h[c] = heights[c];
        sz.off[c] = off;
        off += (long long)widths[c] * heights[c];
        width = widths[c] > width ? widths[c] : width;
        height = heights[c] > height ? heights[c] : height;
    }
    const long long hw = (long long)width * height;
    if (hw == 0) return 0;
    cmyk_to_rgb_kernel<<<(unsigned)((hw + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(planes, sz, height, width, ycck,
                                                              rgb);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
