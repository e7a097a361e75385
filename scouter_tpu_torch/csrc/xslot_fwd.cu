// Forward of the fused xSlot loop for Hopper (sm_90a): f32 arithmetic,
// inputs in f32 or bf16 (converted on load, exactly), outputs in f32.
//
// Replaces the Pallas TPU kernel scouter_tpu/ops/slot_pallas.py::_fused_forward
// (pallas_call :107, body _kernel :42-81). For each batch element it runs all
// `iters` iterations of
//     dots  = slots . k^T * d^-1/2
//     dots  = dots / rowsum(dots) * sum(dots)      (no epsilon, by design)
//     attn  = sigmoid(dots)
//     upd   = attn . v / d
//     slots = GRU(upd, slots)                       (torch gate order r, z, n)
// and writes the last iteration's upd (B,S,d) and attn (B,S,N). The last
// iteration's GRU is skipped: nothing reads its output. With a non-null
// `hist` (training) it also writes the slots entering each iteration to
// hist[b, it] (B,iters,S,d), the checkpoints xslot_bwd.cu rebuilds each
// iteration from (_kernel's hist_ref, slot_pallas.py:57-58).
//
// What bounds it: per element 3 x (two (S,N,d) products) + 2 GRUs of two
// (S,d)x(d,3d) products: 4.08 MFLOP at the flagship (S=30, N=49, d=64), 72% of
// it in the GRU, on 25 KB of k and v. At B=70 that is 0.0043 ms at the card's
// f32 rate; memory is no limit. A design with one CTA per element cannot beat
// one SM's share of that rate, ~8 us, and leaves most SMs idle at B <= 16.
// What the design does about it:
// - One thread-block cluster per element (xslot_common.cuh): its c CTAs split
//   the slots, each loads k and v, and the renorm's total is added from all
//   of the element's row sums through distributed shared memory, in the
//   slots' order, once per iteration. The wrapper (ops/slot_kernel.py::_plan)
//   picks c: the smallest that fits in shared memory, raised while B*c CTAs
//   still fit in one wave. This also lifts the one-CTA ceiling on S (S=1000
//   at N=81 runs on 8 CTAs).
// - The GRU weights go to shared memory row by row, rows padded so that the
//   lanes' float4 reads fall on distinct banks: all 96 KB of them (f32,
//   d=64) where they fit beside the rest, 16-byte cp.async copies issued
//   with k, v and the slots and waited for only before the first GRU, else
//   streamed in tiles of 8 columns through two buffers. Each thread owns two
//   slots x four outputs j with all six gate products of both matrices in
//   registers (48 accumulators), so r, z and n combine in registers and no
//   (S, 3d) buffer is needed. A weight float4 serves 8 FMAs.
// - The dots take four slots per thread (a row of k serves four outputs) and
//   the update two slots x four j (a float4 of v serves eight). Rows of k, v
//   and the slot buffers are padded to d+4 floats: 16-byte aligned, and the
//   lanes' float4 reads fall on distinct banks.
// - A cluster of one CTA synchronises with CTA barriers; a cluster barrier
//   costs ~1k cycles more and orders nothing more there.
// - No tensor cores and no TF32: the parity bars (1e-4 absolute, the renorm
//   has no epsilon) need full f32; 3xTF32 was not tried.
// The order of operations follows _kernel (slot_pallas.py:59-78): `* scale`,
// then `/ row_sum * total`, then `/ d` (`div`: the true d where the wrapper
// zero-padded it to a multiple of 4; `scale` is its d^-1/2).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include "xslot_common.cuh"

using namespace xslot;

namespace {

// Layout of one CTA's dynamic shared memory, in floats (ld = d + 4):
// k (n, ld), v (n, ld), slots, next slots, updates (3 x slp x ld), attn
// (slp, n), row sums (2 x slp, by iteration parity), GRU weights.
__host__ __device__ inline size_t fwd_smem_floats(int n, int s_cta, int d, bool resident) {
  const size_t slp = round4(s_cta), ld = row_ld(d);
  return 2 * (size_t)n * ld + 3 * slp * ld + slp * n + 2 * slp + tile_floats(d, resident);
}

// kResident: all of the GRU weights in shared memory, one CTA per SM (so
// the registers are not capped at 128); else streamed, two CTAs per SM.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, kResident ? 1 : 2)
xslot_fwd_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ slots0,
                 const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                 const T* __restrict__ b_ih, const T* __restrict__ b_hh,
                 float* __restrict__ upd_out, float* __restrict__ attn_out,
                 float* __restrict__ hist_out, int n, int s, int d, int iters, float scale,
                 float div) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / c;
  int s0, sl;
  slot_range(s, c, rank, &s0, &sl);
  const int slp = round4(share_max(s, c)), ld = row_ld(d);

  float* ks = smem;
  float* vs = ks + n * ld;
  float* slots = vs + n * ld;
  float* next = slots + slp * ld;
  float* upd = next + slp * ld;
  float* attn = upd + slp * ld;
  float* row_sums2 = attn + slp * n;
  float* tiles = row_sums2 + 2 * slp;

  zero(slots, (size_t)slp * (3 * ld + n));
  __syncthreads();
  load_rows(ks, ld, k + b * n * d, n, d);
  load_rows(vs, ld, v + b * n * d, n, d);
  load_rows(slots, ld, slots0 + (size_t)s0 * d, sl, d);
  copy_commit();
  // the weights may still be in flight: the first GRU waits for them
  if (kResident && iters > 1) {
    stage_all(tiles, w_ih, w_hh, d);
    copy_wait<1>();
  } else {
    copy_wait<0>();
  }
  __syncthreads();

  const GruTile tile(d);
  for (int it = 0; it < iters; ++it) {
    if (hist_out != nullptr) {
      store_rows(hist_out + ((b * iters + it) * s + s0) * d, slots, ld, sl, d);
    }
    rows_dot_rows(attn, slots, ks, ld, sl, n, d, scale, 1.0f, nullptr, 0);
    __syncthreads();
    // row sums, and the element's total from all of its row sums
    float* row_sum = row_sums2 + (it & 1) * slp;
    row_sums(row_sum, attn, nullptr, sl, n);
    const float total = cluster_slot_sum(cluster, row_sum, s);
    for (int i = threadIdx.x; i < sl * n; i += blockDim.x) {
      attn[i] = sigmoid_f32(attn[i] / row_sum[i / n] * total);
    }
    __syncthreads();
    rows_times(upd, ld, attn, n, vs, ld, sl, n, d, div, false);
    __syncthreads();
    if (it + 1 == iters) break;
    if (kResident && it == 0) {
      copy_wait<0>();
      __syncthreads();
    }
    for (int base = 0; base < sl; base += tile.chunk()) {
      const int sa = tile.first(base, sl);
      GruAcc acc;
      gru_products(acc, upd, slots, sa, tile.q, sa >= 0, tiles, w_ih, w_hh, d, kResident);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int si = sa + r;
        if (sa < 0 || si >= sl) break;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = gru_col(tile.q, u, d);
          const float ir = acc.gi[r][0][u] + to_f32(b_ih[j]);
          const float iz = acc.gi[r][1][u] + to_f32(b_ih[d + j]);
          const float in = acc.gi[r][2][u] + to_f32(b_ih[2 * d + j]);
          const float hr = acc.gh[r][0][u] + to_f32(b_hh[j]);
          const float hz = acc.gh[r][1][u] + to_f32(b_hh[d + j]);
          const float hn = acc.gh[r][2][u] + to_f32(b_hh[2 * d + j]);
          const float rg = sigmoid_f32(ir + hr);
          const float zg = sigmoid_f32(iz + hz);
          const float ng = tanhf(in + rg * hn);
          next[si * ld + j] = (1.0f - zg) * ng + zg * slots[si * ld + j];
        }
      }
    }
    __syncthreads();
    float* t = slots;
    slots = next;
    next = t;
  }

  store_rows(upd_out + (b * s + s0) * d, upd, ld, sl, d);
  store_rows(attn_out + (b * s + s0) * n, attn, n, sl, n);
  // a peer may still read this CTA's row sums: leave together
  if (c > 1) cluster.sync();
}

template <typename T, bool kResident>
int launch(const cudaLaunchConfig_t& config, const void* k, const void* v, const void* slots0,
           const void* w_ih, const void* w_hh, const void* b_ih, const void* b_hh, void* upd,
           void* attn, void* hist, int n, int s, int d, int iters, float scale, float div) {
  auto fn = xslot_fwd_kernel<T, kResident>;
  const int err = ensure_smem((const void*)fn, config.dynamicSmemBytes);
  if (err != 0) return err;
  return (int)cudaLaunchKernelEx(&config, fn, (const T*)k, (const T*)v, (const T*)slots0,
                                 (const T*)w_ih, (const T*)w_hh, (const T*)b_ih,
                                 (const T*)b_hh, (float*)upd, (float*)attn, (float*)hist, n, s,
                                 d, iters, scale, div);
}

const void* kernel_of(int bf16, int resident) {
  if (bf16) {
    return resident ? (const void*)xslot_fwd_kernel<__nv_bfloat16, true>
                    : (const void*)xslot_fwd_kernel<__nv_bfloat16, false>;
  }
  return resident ? (const void*)xslot_fwd_kernel<float, true>
                  : (const void*)xslot_fwd_kernel<float, false>;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA owning `s_cta` slots, in bytes, with all
// of the GRU weights resident (resident == 1) or streamed.
size_t xslot_fwd_smem_bytes(int n, int s_cta, int d, int resident) {
  return fwd_smem_floats(n, s_cta, d, resident != 0) * sizeof(float);
}

// How many clusters of `cluster` CTAs owning `s_cta` slots each the current
// device holds at once (cudaOccupancyMaxActiveClusters), or a negative CUDA
// error.
int xslot_fwd_max_clusters(int n, int s_cta, int d, int resident, int bf16, int cluster) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(
      attr, 1, cluster, xslot_fwd_smem_bytes(n, s_cta, d, resident), nullptr);
  return max_active_clusters(kernel_of(bf16, resident), &config);
}

// Launches on `stream` with `cluster` CTAs per batch element, the GRU weights
// resident in shared memory or streamed; returns 0 or the error. Pointers
// are contiguous device arrays: k, v (B,N,d); slots0 (S,d); w_ih, w_hh
// (3d,d); b_ih, b_hh (3d), all f32 (bf16 == 0) or all bf16
// (bf16 == 1); upd (B,S,d), attn (B,S,N) and hist (B,iters,S,d) or nullptr,
// f32. d % 4 == 0 and d <= 4 * kThreads; `div` is the update's divisor (the
// true slot width, where the wrapper zero-padded d to a multiple of 4).
int xslot_fwd(const void* k, const void* v, const void* slots0, const void* w_ih,
              const void* w_hh, const void* b_ih, const void* b_hh, void* upd, void* attn,
              void* hist, int batch, int n, int s, int d, int iters, float scale, float div,
              int bf16, int cluster, int resident, void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(attr, batch, cluster,
                     xslot_fwd_smem_bytes(n, share_max(s, cluster), d, resident), stream);
  const int err =
      bf16 ? (resident ? launch<__nv_bfloat16, true> : launch<__nv_bfloat16, false>)(
                 config, k, v, slots0, w_ih, w_hh, b_ih, b_hh, upd, attn, hist, n, s, d, iters,
                 scale, div)
           : (resident ? launch<float, true> : launch<float, false>)(
                 config, k, v, slots0, w_ih, w_hh, b_ih, b_hh, upd, attn, hist, n, s, d, iters,
                 scale, div);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
