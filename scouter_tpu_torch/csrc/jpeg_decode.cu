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

#include <cuda_runtime.h>
#include <nvjpeg.h>

extern "C" {

int jpeg_handle_create(void** handle) {
    return static_cast<int>(nvjpegCreateSimple(reinterpret_cast<nvjpegHandle_t*>(handle)));
}

int jpeg_state_create(void* handle, void** state) {
    return static_cast<int>(nvjpegJpegStateCreate(
        static_cast<nvjpegHandle_t>(handle), reinterpret_cast<nvjpegJpegState_t*>(state)));
}

// components, chroma subsampling (nvjpegChromaSubsampling_t) and the size
// of component 0, which is the image's size
int jpeg_image_info(void* handle, const unsigned char* data, size_t length,
                    int* components, int* subsampling, int* width, int* height) {
    int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegChromaSubsampling_t css;
    nvjpegStatus_t st = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length,
                                           components, &css, widths, heights);
    *subsampling = static_cast<int>(css);
    *width = widths[0];
    *height = heights[0];
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

}  // extern "C"
