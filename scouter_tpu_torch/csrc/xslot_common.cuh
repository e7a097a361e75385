// Building blocks shared by K1's forward (xslot_fwd.cu) and backward
// (xslot_bwd.cu) for Hopper (sm_90a), f32 arithmetic throughout.
//
// Both kernels give one batch element to one thread-block cluster of `c`
// CTAs (c <= 8, the portable limit). CTA `rank` owns the contiguous slots
// [rank*S/c, (rank+1)*S/c) and loads the whole of k and v. Within an element
// the slots interact only through sums over all of them (the renorm's total;
// in the backward also one sum of the renorm's gradient); each CTA keeps one
// value per slot, and cluster_slot_sum() reads all of them through
// distributed shared memory and adds them in the slots' order, so every CTA
// holds the same bits whatever c is.
//
// Shared-memory buffers that hold one row per slot have `slp` rows (the CTA's
// largest share rounded up to 4) of row stride d+4 (16-byte aligned rows,
// and rows two apart land on different banks); the tiles below read up to
// four rows past the share, which are zero.
//
// The GRU products read the weights W (3d, d) by rows: output j of gate g
// is row g*d+j of W dotted with the input. W_ih and W_hh go to shared memory
// as they are, in 16-byte pieces, with each row padded by four floats, so
// that the float4 reads of lanes holding consecutive outputs j (rows d+4 or
// kTileC+4 floats apart) fall on distinct banks: all of them at once where
// they fit beside the rest (resident, copied while the first attention pass
// runs), else streamed in tiles of kTileC columns through two buffers. f32
// pieces are copied with cp.async, bf16 ones converted on load.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace xslot {

constexpr int kThreads = 256;
constexpr int kTileC = 8;             // columns of W per staged tile

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int row_ld(int d) { return d + 4; }
// row stride of the staged GRU weights: whole rows (resident) or a tile's
__host__ __device__ inline int w_ld(int d, bool resident) { return (resident ? d : kTileC) + 4; }
// floats of the staged GRU weights: all of W_ih and W_hh (resident), or two
// buffers of one tile of each
__host__ __device__ inline size_t tile_floats(int d, bool resident) {
  return (resident ? 2 : 4) * (size_t)3 * d * w_ld(d, resident);
}
__host__ __device__ inline int share_max(int s, int c) { return (s + c - 1) / c; }

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// f32 to an output element: as it is, or rounded to the nearest bf16 (ties to even)
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float comp(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline void slot_range(int s, int c, int rank, int* s0, int* sl) {
  *s0 = (int)((long long)rank * s / c);
  *sl = (int)((long long)(rank + 1) * s / c) - *s0;
}

__device__ inline void zero(float* p, size_t count) {
  for (size_t i = threadIdx.x; i < count; i += blockDim.x) p[i] = 0.0f;
}

// Four consecutive floats from device memory: src 16-byte aligned (f32) or
// 8-byte aligned (bf16, converted).
__device__ __forceinline__ float4 load4(const float* __restrict__ src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four floats to shared memory: f32 asynchronously (cp.async, 16 bytes, both
// sides 16-byte aligned), bf16 converted on load.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}
__device__ __forceinline__ void copy4(float* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<float4*>(dst) = load4(src);
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * ld + c] = src[r * cols + c] for r < rows, c < cols, four floats at
// a time (cols % 4 == 0, rows 16-byte aligned on both sides) with copy4: the
// caller commits the f32 copies and waits for them before a barrier.
template <typename T>
__device__ inline void load_rows(float* dst, int ld, const T* __restrict__ src, int rows,
                                 int cols) {
  const int q4 = cols >> 2;
  for (int i = threadIdx.x; i < rows * q4; i += blockDim.x) {
    const int r = i / q4, c = 4 * (i - r * q4);
    copy4(dst + r * ld + c, src + (size_t)r * cols + c);
  }
}

// dst[r * cols + c] = src[r * ld + c] for r < rows, c < cols
__device__ inline void store_rows(float* __restrict__ dst, const float* src, int ld, int rows,
                                  int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    dst[i] = src[r * ld + (i - r * cols)];
  }
}

// ------------------------------------------------------------ cluster sums

// A barrier over the element's CTAs: the cluster's, or the CTA's where the
// cluster is this CTA alone (then the cluster barrier only costs more).
__device__ __forceinline__ void element_sync(cg::cluster_group& cluster) {
  if (cluster.num_blocks() == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// The sum over all of the element's slots of `vals` (each CTA's array, at the
// same shared-memory address, holds one value per slot it owns), in the
// slots' order: lane l adds slots l, l+32, ... and a butterfly adds the lanes,
// as a one-CTA kernel would. Every warp computes it; every CTA gets the same
// bits, whatever the cluster size. The caller has synchronised the element's
// CTAs since `vals` was written (cluster_slot_sum below).
__device__ inline float slot_values_sum(cg::cluster_group& cluster, const float* vals, int s) {
  const int c = (int)cluster.num_blocks(), lane = threadIdx.x & 31;
  int r = 0, first = 0, end = (int)((long long)s / c);
  float acc = 0.0f;
  for (int i = lane; i < s; i += 32) {
    while (i >= end) {
      ++r;
      first = end;
      end = (int)((long long)(r + 1) * s / c);
    }
    acc += cluster.map_shared_rank(vals, r)[i - first];
  }
  return warp_sum(acc);
}

// slot_values_sum after element_sync (also a barrier for the CTA). A CTA
// writes `vals` again only after the next element_sync that follows this
// call, which its peers reach only once they have read.
__device__ inline float cluster_slot_sum(cg::cluster_group& cluster, float* vals, int s) {
  element_sync(cluster);
  return slot_values_sum(cluster, vals, s);
}

// out[r] = sum_n a[r][n] (b[r][n] if b is given) for r < rows, one warp a row
__device__ inline void row_sums(float* out, const float* a, const float* b, int rows, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    float acc = 0.0f;
    for (int i = lane; i < n; i += 32) acc += b ? a[r * n + i] * b[r * n + i] : a[r * n + i];
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

// --------------------------------------------------------------- products

// out[s][m] = (x[s] . y[m]) * mul / div (+ add[s * ldadd + m] if add) for
// s < sl, m < rows_y: x (slp, d) and y (rows_y, d) in shared memory with row
// stride ld, out (sl, rows_y) with row stride rows_y. A thread takes four
// slots at one m, so each row of y it reads serves four outputs.
__device__ inline void rows_dot_rows(float* out, const float* x, const float* y, int ld,
                                     int sl, int rows_y, int d, float mul, float div,
                                     const float* __restrict__ add, int ldadd) {
  const int groups = (sl + 3) >> 2;
  for (int task = threadIdx.x; task < groups * rows_y; task += blockDim.x) {
    const int g = task / rows_y, m = task - g * rows_y, s = 4 * g;
    const float* yr = y + m * ld;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int c = 0; c < d; c += 4) {
      const float4 yv = *reinterpret_cast<const float4*>(yr + c);
      a0 = dot4(*reinterpret_cast<const float4*>(x + s * ld + c), yv, a0);
      a1 = dot4(*reinterpret_cast<const float4*>(x + (s + 1) * ld + c), yv, a1);
      a2 = dot4(*reinterpret_cast<const float4*>(x + (s + 2) * ld + c), yv, a2);
      a3 = dot4(*reinterpret_cast<const float4*>(x + (s + 3) * ld + c), yv, a3);
    }
    const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (s + r < sl) {
        float o = acc[r] * mul / div;
        if (add) o = add[(s + r) * ldadd + m] + o;
        out[(s + r) * rows_y + m] = o;
      }
    }
  }
}

// out[s][j] (+)= (sum_i a[s][i] * b[i][j]) / div for s < sl, j < d: a (slp,
// inner) with row stride lda in shared memory, b (inner, d) with row stride
// ldb (shared or device memory), out with row stride ldo. A thread takes two
// slots at four consecutive j, so each float4 of b serves eight outputs.
__device__ inline void rows_times(float* out, int ldo, const float* a, int lda,
                                  const float* b, int ldb, int sl, int inner, int d, float div,
                                  bool accumulate) {
  const int nq = d >> 2, pairs = (sl + 1) >> 1;
  for (int task = threadIdx.x; task < pairs * nq; task += blockDim.x) {
    const int q = task % nq, s = 2 * (task / nq);
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f), w = u;
    const float* a0 = a + s * lda;
    const float* a1 = a0 + lda;
    for (int i = 0; i < inner; ++i) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (size_t)i * ldb + 4 * q);
      const float x0 = a0[i], x1 = a1[i];
      u.x = fmaf(x0, bv.x, u.x); u.y = fmaf(x0, bv.y, u.y);
      u.z = fmaf(x0, bv.z, u.z); u.w = fmaf(x0, bv.w, u.w);
      w.x = fmaf(x1, bv.x, w.x); w.y = fmaf(x1, bv.y, w.y);
      w.z = fmaf(x1, bv.z, w.z); w.w = fmaf(x1, bv.w, w.w);
    }
    const float4 acc[2] = {u, w};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (s + r >= sl) break;
      float* o = out + (s + r) * ldo + 4 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = comp(acc[r], e) / div;
        o[e] = accumulate ? o[e] + v : v;
      }
    }
  }
}

// -------------------------------------------------------------------- GRU

// Columns [c0, c0 + cols) of W_ih and W_hh into w[m][row][0 .. cols) (m = 0
// for W_ih, 1 for W_hh), row stride ld: consecutive threads take consecutive
// 16-byte pieces of a row.
template <typename T>
__device__ inline void stage_columns(float* w, const T* __restrict__ w_ih,
                                     const T* __restrict__ w_hh, int d, int c0, int cols,
                                     int ld) {
  const int q4 = cols >> 2, per = 3 * d * q4;
  for (int e = threadIdx.x; e < 2 * per; e += blockDim.x) {
    const int m = e >= per, rem = e - m * per, row = rem / q4, c = 4 * (rem - row * q4);
    copy4(w + ((size_t)m * 3 * d + row) * ld + c, (m ? w_hh : w_ih) + (size_t)row * d + c0 + c);
  }
}

// Stages all of both matrices (resident) and commits the copies; the caller
// waits (copy_wait<0>, then a barrier) before the first use.
template <typename T>
__device__ inline void stage_all(float* w, const T* __restrict__ w_ih,
                                 const T* __restrict__ w_hh, int d) {
  stage_columns(w, w_ih, w_hh, d, 0, d, w_ld(d, true));
  copy_commit();
}

// Output u of the thread with column quad q: j = q + u*d/4, so that lanes
// with consecutive q hold consecutive j.
__device__ __forceinline__ int gru_col(int q, int u, int d) { return q + u * (d >> 2); }

// The GRU's thread tile: thread t takes column quad q = t % (d/4) of the
// slot pair t / (d/4); `pairs` = kThreads / (d/4) whole pairs of threads, so
// where d/4 does not divide kThreads the last kThreads % (d/4) threads hold
// no pair (they only stage weights). A CTA's slots go in chunks of 2 * pairs.
struct GruTile {
  int q, pair, pairs;
  __device__ explicit GruTile(int d)
      : q(threadIdx.x % (d >> 2)), pair(threadIdx.x / (d >> 2)), pairs(kThreads / (d >> 2)) {}
  __device__ int chunk() const { return 2 * pairs; }
  // the first of the thread's two slots in the chunk at `base`, or -1
  __device__ int first(int base, int sl) const {
    const int sa = base + 2 * pair;
    return pair < pairs && sa < sl ? sa : -1;
  }
};

// gi[s][g][u] = x[sa+s] . W_ih[g*d + j] and gh[s][g][u] = h[sa+s] .
// W_hh[g*d + j] for the thread's two slots sa, sa+1 (s = 0, 1), gates g =
// r, z, n and four outputs j = gru_col(q, u, d), without biases. x and h are (slp, d) in
// shared memory with row stride row_ld(d). With `resident`, `tiles` holds all
// of the weights (stage_all) and the call has no barrier; otherwise it
// streams the tiles through two buffers, every thread of the CTA calls it
// (it stages the weights for all) and an inactive thread only stages. The
// last tile is 4 columns wide where d % kTileC == 4.
struct GruAcc {
  float gi[2][3][4];
  float gh[2][3][4];
};

template <typename T>
__device__ inline void gru_products(GruAcc& acc, const float* x, const float* h, int sa, int q,
                                    bool active, float* tiles, const T* __restrict__ w_ih,
                                    const T* __restrict__ w_hh, int d, bool resident) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc.gi[s][g][u] = acc.gh[s][g][u] = 0.0f;
  const int ld = row_ld(d), wld = w_ld(d, resident), ntiles = (d + kTileC - 1) / kTileC;
  const size_t mat = (size_t)3 * d * wld;  // one matrix; a streamed buffer holds two
  if (!resident) {
    stage_columns(tiles, w_ih, w_hh, d, 0, min(kTileC, d), wld);
    copy_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int cols = min(kTileC, d - t * kTileC);
    if (!resident) {
      if (t + 1 < ntiles) {
        const int c1 = (t + 1) * kTileC;
        stage_columns(tiles + ((t + 1) & 1) * 2 * mat, w_ih, w_hh, d, c1,
                      min(kTileC, d - c1), wld);
        copy_commit();
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();
    }
    if (active) {
      // this tile's columns: at t*kTileC of the whole rows, or a buffer's
      const float* wi = resident ? tiles + t * kTileC : tiles + (t & 1) * 2 * mat;
      const float* wh = wi + mat;
#pragma unroll
      for (int c4 = 0; c4 < kTileC; c4 += 4) {
        if (c4 >= cols) break;
        const int c = t * kTileC + c4;
        const float4 xv[2] = {*reinterpret_cast<const float4*>(x + sa * ld + c),
                              *reinterpret_cast<const float4*>(x + (sa + 1) * ld + c)};
        const float4 hv[2] = {*reinterpret_cast<const float4*>(h + sa * ld + c),
                              *reinterpret_cast<const float4*>(h + (sa + 1) * ld + c)};
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int row = g * d + gru_col(q, u, d);
            const float4 a = *reinterpret_cast<const float4*>(wi + row * wld + c4);
            const float4 b = *reinterpret_cast<const float4*>(wh + row * wld + c4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                acc.gi[s][g][u] = fmaf(comp(xv[s], e), comp(a, e), acc.gi[s][g][u]);
                acc.gh[s][g][u] = fmaf(comp(hv[s], e), comp(b, e), acc.gh[s][g][u]);
              }
            }
          }
        }
      }
    }
    if (!resident) __syncthreads();
  }
}

// ------------------------------------------------------------------ host

// Raises the kernel's dynamic shared memory limit on the current device to at
// least `smem` (the limit belongs to the function, so it is never lowered:
// another shape's launch may need more). ctypes calls may come from several
// threads. Returns 0 or a CUDA error.
inline int ensure_smem(const void* fn, size_t smem) {
  struct Limit {
    const void* fn;
    int device;
    size_t smem;
  };
  static std::mutex mutex;
  static Limit limits[64];
  static int count = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mutex);
  Limit* found = nullptr;
  for (int i = 0; i < count; ++i) {
    if (limits[i].fn == fn && limits[i].device == device) found = &limits[i];
  }
  if (found != nullptr && found->smem >= smem) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (found != nullptr) {
    found->smem = smem;
  } else if (count < 64) {
    limits[count++] = {fn, device, smem};
  }
  return 0;
}

// How many clusters of `config` the current device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
inline int max_active_clusters(const void* fn, const cudaLaunchConfig_t* config) {
  const int err = ensure_smem(fn, config->dynamicSmemBytes);
  if (err != 0) return -err;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, config);
  return e == cudaSuccess ? clusters : -(int)e;
}

// A launch configuration of `batch` clusters of `cluster` CTAs; `attr` must
// outlive it.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int batch, int cluster,
                                         size_t smem, void* stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace xslot

// Each library that includes this header exports these two.
extern "C" {

// The most dynamic shared memory a CTA may opt in to on `device`.
int xslot_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return -1;
  }
  return v;
}

const char* xslot_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
