// Heatmap render (K2) for Hopper (sm_90a), f32 throughout.
//
// Replaces the Pallas TPU kernel scouter_tpu/ops/render_pallas.py::
// render_heatmaps_fused (pallas_call :53, body _kernel :36-41, jet_rgba
// :27-33). For each row of the (C, N) attention:
//     lo, hi = min(row), max(row)
//     v      = (row - lo) / max(hi - lo, 1e-12)
//     r      = clip(min(4v - 1.5, -4v + 4.5), 0, 1)
//     g      = clip(min(4v - 0.5, -4v + 3.5), 0, 1)
//     b      = clip(min(4v + 0.5, -4v + 2.5), 0, 1)
//     out    = (r, g, b, alpha) * 255                  -> (C, N, 4)
//
// What bounds it: bytes. It reads 4*C*N bytes and writes 16*C*N, 20*C*N in
// all: 0.686 MB at the explain path's C=700, N=49, which is 0.2 us at the
// H100's 3.35 TB/s; its ~30 f32 operations per element are far below the f32
// rate. At these sizes the launch itself (a few us) costs more than the work,
// so this first kernel is simple and right rather than fast.
// What the design does about it: one warp per row and eight rows per
// 256-thread block; the lanes stride over N, reduce min and max with warp
// shuffles, then write each element as one float4, 16-byte aligned and
// coalesced across the warp. The row is read twice (reduction, then map);
// the second read hits in cache, so device memory sees each byte once.
//
// Semantics kept from the plain version (ops/render_kernel.py):
// - NaN propagates: a row holding a NaN has NaN lo, hi and v, so NaN r, g, b
//   (alpha stays alpha*255), as torch.amin/amax, minimum and clamp give.
//   fminf/fmaxf drop NaN, so min, max and clip are written out by hand.
// - A constant row has hi - lo = 0, denominator 1e-12, v = 0: blue.
// - True division: the build has no --use_fast_math. 4*v is exact, so
//   contracting 4v - 1.5 into an FMA changes no bit.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// min / max that return NaN when either side is NaN (torch.minimum, amin)
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || isnan(a)) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || isnan(a)) ? a : b; }

// clip to [0, 1] that lets NaN through (torch.clamp)
__device__ __forceinline__ float clip01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
render_heatmaps_kernel(const float* __restrict__ attn, float4* __restrict__ out, int c, int n,
                       float alpha) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= c) return;  // the whole warp leaves together
  const float* a = attn + (size_t)row * n;
  float4* o = out + (size_t)row * n;

  float lo = INFINITY, hi = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float x = a[j];
    lo = nan_min(lo, x);
    hi = nan_max(hi, x);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
  }
  const float range = hi - lo;
  const float den = isnan(range) ? range : fmaxf(range, 1e-12f);
  const float a255 = alpha * 255.0f;

  for (int j = lane; j < n; j += 32) {
    const float v4 = 4.0f * ((a[j] - lo) / den);
    float4 px;
    px.x = clip01(nan_min(v4 - 1.5f, -v4 + 4.5f)) * 255.0f;
    px.y = clip01(nan_min(v4 - 0.5f, -v4 + 3.5f)) * 255.0f;
    px.z = clip01(nan_min(v4 + 0.5f, -v4 + 2.5f)) * 255.0f;
    px.w = a255;
    o[j] = px;
  }
}

}  // namespace

extern "C" {

const char* render_heatmaps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// attn: contiguous f32 (C, N) on the device; out: contiguous f32 (C, N, 4),
// 16-byte aligned. Nothing is launched when C or N is 0.
int render_heatmaps(const void* attn, void* out, int c, int n, float alpha, void* stream) {
  if (c <= 0 || n <= 0) return 0;
  const int blocks = (c + kRowsPerBlock - 1) / kRowsPerBlock;
  render_heatmaps_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)attn, (float4*)out, c, n, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
