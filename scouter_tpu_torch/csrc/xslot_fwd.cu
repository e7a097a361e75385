// Forward of the fused xSlot loop for Hopper (sm_90a), f32 throughout.
//
// Replaces the Pallas TPU kernel scouter_tpu/ops/slot_pallas.py::_fused_forward
// (body _kernel, :42-81). One block per batch element runs all `iters`
// iterations of
//     dots  = slots . k^T * d^-1/2
//     dots  = dots / rowsum(dots) * sum(dots)      (no epsilon, by design)
//     attn  = sigmoid(dots)
//     upd   = attn . v / d
//     slots = GRU(upd, slots)                       (torch gate order r, z, n)
// and writes the last iteration's upd (B,S,d) and attn (B,S,N). The last
// iteration's GRU is skipped: nothing reads its output. With a non-null
// `hist` (training) the block also writes the slots entering each iteration
// to hist[b, it] (B,iters,S,d), the checkpoints the backward rebuilds each
// iteration from (_kernel's hist_ref, slot_pallas.py:57-58); inference
// passes nullptr and writes nothing, as the emit_hist=False build does.
//
// What bounds it: at the serving shapes (S=30, N=49, d=64) the work per
// element is ~0.9 MFLOP of f32 on ~25 KB of k and v, so neither the card's
// f32 rate nor its memory rate is the limit; the block's serial chain of five
// small products and three block-wide reductions per iteration is (latency
// within one SM), and at small batch most SMs are idle (B blocks on 132 SMs).
// The training build's hist adds B*iters*S*d floats of writes (1.6 MB at
// B=70), which changes neither bound.
// What the design does about it: k, v, the slots, the attention and the
// updates stay in shared memory across the iterations, so device memory is
// read once and written once; the rows of k are padded to d+1 floats so the
// dots loop reads shared memory without bank conflicts; the GRU weights
// (2 x 3d x d f32) are read through the read-only cache and stay resident in
// L2 across blocks, and each thread computes whole GRU outputs (s, j) from six
// length-d dot products, so no (S, 3d) gate buffer is needed. No tensor cores
// and no TF32: the parity bars need full f32. Splitting an element over
// several blocks (a cluster) and bf16 tensor-core products are later work.
//
// Order of operations follows _kernel (slot_pallas.py:59-78): `* scale`, then
// `/ row_sum * total`, then `/ d`.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared-memory layout, in floats. The first four buffers are multiples of
// d (d % 4 == 0), so every row of them is 16-byte aligned for float4 reads.
__host__ __device__ inline size_t smem_floats(int n, int s, int d) {
  return 3 * (size_t)s * d      // slots, next slots, updates
         + (size_t)n * d        // v
         + (size_t)n * (d + 1)  // k, rows padded by one float
         + (size_t)s * n        // dots, then attn
         + (size_t)s            // row sums
         + 32;                  // total
}

__global__ void __launch_bounds__(kThreads)
xslot_fwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ slots0,
                 const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                 const float* __restrict__ b_ih, const float* __restrict__ b_hh,
                 float* __restrict__ upd_out, float* __restrict__ attn_out,
                 float* __restrict__ hist_out, int n, int s, int d, int iters,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  const int sd = s * d, nd = n * d, sn = s * n, kd = d + 1;
  float* slots = smem;
  float* next = slots + sd;
  float* upd = next + sd;
  float* vs = upd + sd;
  float* ks = vs + nd;
  float* dots = ks + (size_t)n * kd;
  float* row_sum = dots + sn;
  float* total_s = row_sum + s;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const size_t b = blockIdx.x;
  const float* kb = k + b * nd;
  const float* vb = v + b * nd;
  for (int i = tid; i < nd; i += blockDim.x) {
    vs[i] = vb[i];
    ks[(i / d) * kd + (i % d)] = kb[i];
  }
  for (int i = tid; i < sd; i += blockDim.x) slots[i] = slots0[i];
  __syncthreads();

  const float fd = (float)d;
  for (int it = 0; it < iters; ++it) {
    // checkpoint the slots entering this iteration (only read here, so no
    // barrier is needed before the products below read them too)
    if (hist_out != nullptr) {
      float* hb = hist_out + (b * iters + it) * sd;
      for (int i = tid; i < sd; i += blockDim.x) hb[i] = slots[i];
    }
    // dots = slots . k^T * scale
    for (int i = tid; i < sn; i += blockDim.x) {
      const int si = i / n, ni = i - si * n;
      const float* sr = slots + si * d;
      const float* kr = ks + ni * kd;
      float acc = 0.0f;
      for (int c = 0; c < d; ++c) acc = fmaf(sr[c], kr[c], acc);
      dots[i] = acc * scale;
    }
    __syncthreads();
    // row sums, one warp per row; then the element's total from the row sums
    for (int si = warp; si < s; si += warps) {
      float acc = 0.0f;
      for (int ni = lane; ni < n; ni += 32) acc += dots[si * n + ni];
      acc = warp_sum(acc);
      if (lane == 0) row_sum[si] = acc;
    }
    __syncthreads();
    if (warp == 0) {
      float acc = 0.0f;
      for (int si = lane; si < s; si += 32) acc += row_sum[si];
      acc = warp_sum(acc);
      if (lane == 0) total_s[0] = acc;
    }
    __syncthreads();
    const float total = total_s[0];
    for (int i = tid; i < sn; i += blockDim.x) {
      dots[i] = sigmoid_f32(dots[i] / row_sum[i / n] * total);
    }
    __syncthreads();
    // updates = attn . v / d
    for (int i = tid; i < sd; i += blockDim.x) {
      const int si = i / d, c = i - si * d;
      const float* ar = dots + si * n;
      float acc = 0.0f;
      for (int ni = 0; ni < n; ++ni) acc = fmaf(ar[ni], vs[ni * d + c], acc);
      upd[i] = acc / fd;
    }
    __syncthreads();
    if (it + 1 == iters) break;
    // GRU: thread computes slot element (si, j) from six length-d products
    for (int i = tid; i < sd; i += blockDim.x) {
      const int si = i / d, j = i - si * d;
      const float* x = upd + si * d;
      const float* h = slots + si * d;
      const float* wir = w_ih + (size_t)j * d;
      const float* wiz = w_ih + (size_t)(d + j) * d;
      const float* win = w_ih + (size_t)(2 * d + j) * d;
      const float* whr = w_hh + (size_t)j * d;
      const float* whz = w_hh + (size_t)(d + j) * d;
      const float* whn = w_hh + (size_t)(2 * d + j) * d;
      float ir = 0.0f, iz = 0.0f, in = 0.0f, hr = 0.0f, hz = 0.0f, hn = 0.0f;
      for (int c = 0; c < d; c += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + c);
        const float4 hv = *reinterpret_cast<const float4*>(h + c);
        ir = dot4(xv, __ldg(reinterpret_cast<const float4*>(wir + c)), ir);
        iz = dot4(xv, __ldg(reinterpret_cast<const float4*>(wiz + c)), iz);
        in = dot4(xv, __ldg(reinterpret_cast<const float4*>(win + c)), in);
        hr = dot4(hv, __ldg(reinterpret_cast<const float4*>(whr + c)), hr);
        hz = dot4(hv, __ldg(reinterpret_cast<const float4*>(whz + c)), hz);
        hn = dot4(hv, __ldg(reinterpret_cast<const float4*>(whn + c)), hn);
      }
      ir += __ldg(b_ih + j);
      iz += __ldg(b_ih + d + j);
      in += __ldg(b_ih + 2 * d + j);
      hr += __ldg(b_hh + j);
      hz += __ldg(b_hh + d + j);
      hn += __ldg(b_hh + 2 * d + j);
      const float r = sigmoid_f32(ir + hr);
      const float z = sigmoid_f32(iz + hz);
      const float nn = tanhf(in + r * hn);
      next[i] = (1.0f - z) * nn + z * h[j];
    }
    __syncthreads();
    float* t = slots;
    slots = next;
    next = t;
  }

  float* ub = upd_out + b * sd;
  float* ab = attn_out + b * sn;
  for (int i = tid; i < sd; i += blockDim.x) ub[i] = upd[i];
  for (int i = tid; i < sn; i += blockDim.x) ab[i] = dots[i];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t xslot_fwd_smem_bytes(int n, int s, int d) { return smem_floats(n, s, d) * sizeof(float); }

// The most dynamic shared memory a block may opt in to on `device`.
int xslot_fwd_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return -1;
  }
  return v;
}

const char* xslot_fwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// All pointers are contiguous f32 device arrays: k, v (B,N,d); slots0 (S,d);
// w_ih, w_hh (3d,d); b_ih, b_hh (3d); upd (B,S,d); attn (B,S,N); hist
// (B,iters,S,d) or nullptr. d % 4 == 0.
int xslot_fwd(const void* k, const void* v, const void* slots0, const void* w_ih,
              const void* w_hh, const void* b_ih, const void* b_hh, void* upd, void* attn,
              void* hist, int batch, int n, int s, int d, int iters, float scale,
              void* stream) {
  const size_t smem = xslot_fwd_smem_bytes(n, s, d);
  cudaError_t err = cudaFuncSetAttribute(xslot_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  xslot_fwd_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)k, (const float*)v, (const float*)slots0, (const float*)w_ih,
      (const float*)w_hh, (const float*)b_ih, (const float*)b_hh, (float*)upd, (float*)attn,
      (float*)hist, n, s, d, iters, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
