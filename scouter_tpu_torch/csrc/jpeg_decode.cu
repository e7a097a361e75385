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
// their planes as stored (NVJPEG_OUTPUT_UNCHANGED); cmyk_to_rgb_kernel then
// gives the pixels Pillow gives them. Pillow (JpegImagePlugin) reads every
// four-layer JPEG with the raw mode "CMYK;I", inverted as Adobe writes it,
// after libjpeg turned YCCK into CMYK (jdcolor.c's ycck_cmyk_convert), and
// convert("RGB") applies Convert.c's cmyk2rgb. That conversion replaces no
// Pallas kernel either: it is Pillow's host arithmetic, moved to the card
// beside the decode, and data/_decode.py::cmyk_to_rgb_ref is its plain
// version. One byte in and at most one out a sample: bytes bound it.

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

// libjpeg's YCC-to-RGB tables (jdcolor.c, build_ycc_rgb_table): SCALEBITS 16,
// ONE_HALF 1 << 15, FIX(x) = x * 65536 + 0.5 rounded down; shifts of
// negative values arithmetic, as libjpeg's RIGHT_SHIFT
constexpr int kScaleBits = 16, kOneHalf = 1 << 15;
constexpr int kFixCrR = 91881, kFixCbB = 116130, kFixCrG = 46802, kFixCbG = 22554;

__device__ __forceinline__ int clip8(int x) { return x < 0 ? 0 : (x > 255 ? 255 : x); }

// Per pixel of planes (4, hw) uint8: YCCK to CMYK where `ycck` (libjpeg),
// the Adobe inversion (Pillow's "CMYK;I"), then cmyk2rgb of Pillow >= 9.1:
// nk = 255 - k; out = clip(nk - MULDIV255(c, nk)) with MULDIV255(a, b) =
// (t + (t >> 8)) >> 8, t = a b + 128. rgb (hw, 3) uint8.
__global__ void cmyk_to_rgb_kernel(const unsigned char* __restrict__ planes, int hw, int ycck,
                                   unsigned char* __restrict__ rgb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  int c = planes[i], m = planes[hw + i], y = planes[2 * hw + i];
  const int k = planes[3 * hw + i];
  if (ycck) {
    const int luma = c, cb = m - 128, cr = y - 128;
    c = clip8(255 - (luma + ((kFixCrR * cr + kOneHalf) >> kScaleBits)));
    m = clip8(255 - (luma + ((-kFixCbG * cb + kOneHalf - kFixCrG * cr) >> kScaleBits)));
    y = clip8(255 - (luma + ((kFixCbB * cb + kOneHalf) >> kScaleBits)));
  }
  const int nk = k;  // 255 - (255 - k): the inverted K
  const int cmy[3] = {255 - c, 255 - m, 255 - y};
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

// Decode a four-component JPEG whose components all have the image's size
// into its planes as stored, `out` (4, height, width) uint8
// (NVJPEG_OUTPUT_UNCHANGED). Returns as jpeg_decode.
int jpeg_decode_planes(void* handle, void* state, const unsigned char* data, size_t length,
                       unsigned char* out, int width, int height, void* stream) {
    nvjpegImage_t dst = {};
    for (int c = 0; c < 4; ++c) {
        dst.channel[c] = out + (size_t)c * width * height;
        dst.pitch[c] = width;
    }
    nvjpegStatus_t st = nvjpegDecode(static_cast<nvjpegHandle_t>(handle),
                                     static_cast<nvjpegJpegState_t>(state), data, length,
                                     NVJPEG_OUTPUT_UNCHANGED, &dst,
                                     static_cast<cudaStream_t>(stream));
    if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
    cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? 0 : 100 + static_cast<int>(err);
}

// cmyk_to_rgb_kernel on `stream` over `hw` pixels; returns 0 or the CUDA
// error.
int jpeg_cmyk_to_rgb(const unsigned char* planes, int hw, int ycck, unsigned char* rgb,
                     void* stream) {
    if (hw == 0) return 0;
    cmyk_to_rgb_kernel<<<(hw + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        planes, hw, ycck, rgb);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
