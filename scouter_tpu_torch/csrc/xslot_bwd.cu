// Checkpointed backward of the fused xSlot loop for Hopper (sm_90a): f32
// arithmetic, residuals in f32 or bf16, gradients in the residuals' dtype.
//
// Replaces the backward of the Pallas op scouter_tpu/ops/slot_pallas.py::
// xslot_iterations_fused, its custom_vjp _bwd (:168-208), which the JAX
// package runs as plain XLA ops. Given the residuals k, v (B,N,d), W_ih,
// W_hh (3d,d), b_ih, b_hh (3d) and hist (B,iters,S,d) that xslot_fwd.cu wrote,
// and the cotangents du (B,S,d) and dattn (B,S,N) of its outputs, it returns
// dk, dv, d_initial_slots (S,d), dW_ih, dW_hh, db_ih and db_hh. It walks the
// iterations in reverse and rebuilds iteration i from hist[:, i]: dots,
// renorm, attention and update, and, before the last iteration, the GRU's
// gates. The formulas and their order are those of
// ops/slot_kernel.py::xslot_bwd_ref, its plain version:
//   GRU (h entering, x = upd, g the cotangent of the new slots):
//     dn = g(1-z); dz = g(h-n); dh = g z; a_n = dn(1-n^2); a_r = a_n gh_n r(1-r);
//     a_z = dz z(1-z); dgi = [a_r, a_z, a_n]; dgh = [a_r, a_z, a_n r];
//     dx = dgi W_ih; dh += dgh W_hh; dW_ih += dgi^T x; dW_hh += dgh^T h; db += sum_s
//   attention (x_ij = D_ij T / rs_i, D the scaled dots, T their total):
//     dupd = du (last iteration) or dx; P = dattn (last only) + dupd v^T / d;
//     dv += attn^T dupd / d; G = P attn (1 - attn); rg_k = sum_j G_kj D_kj;
//     dD = (T G / rs - T rg / rs^2 + sum_i rg_i / rs_i) * scale;
//     dh += dD k; dk += dD^T h
// The last iteration's GRU has a zero cotangent and is skipped.
//
// bf16 residuals (a bf16 slot head in training): k, v, the GRU weights and
// biases arrive in bf16, as xslot_fwd.cu takes them, and are converted to f32
// exactly, on load into shared memory (the cluster route) or by one pass into
// the scratch at the head of the tiled route; hist, du and dattn stay f32.
// Everything after is the f32 instance's arithmetic in its order, and each
// gradient is rounded once to bf16 where it is written last: dk and dv at the
// cluster's closing sum (on the tiled route from f32 partials by the closing
// sums), the weight, bias and initial-slot gradients by the closing sums.
//
// What bounds it: per element 3 attention recomputes and backwards and 2 GRU
// recomputes and backwards, ~12.2 MFLOP at the flagship (S=30, N=49, d=64):
// 0.013 ms at B=70 over the card's f32 rate. In practice latency bounds it:
// an element runs on a cluster of c CTAs, one an SM with 8 warps, and every
// phase is a short chain of shared-memory loads between two barriers; at
// the engine's batches (c = 6 or 8, 4-5 slots a CTA) a product has a few
// dozen outputs a CTA, and each iteration meets the cluster twice. Clock
// stamps of the design before this one put over half of its time in the
// GRU: dx and dh read W from L2 one float4 a term, the gates streamed W
// through shared memory with a barrier a tile, and the weight gradients
// read back a partial in device memory.
// What the design does about it:
// - W_ih, W_hh and the biases stay in shared memory for the whole call,
//   copied with cp.async while the last iteration (no GRU) runs.
// - The products of the CTA's slots read float4 of both operands (N padded
//   to a multiple of 4 with zeros) into register tiles: dx and dh 4 slots x
//   4 columns a thread; x and dh += dD k 2 x 4; the dots and P 4 slots at
//   one m; the gates 8 slots at one output column, so each row of W is read
//   once a CTA. Where a product's tasks leave threads idle, its inner terms
//   split over up to 8 lanes, added by a butterfly of shuffles in a fixed
//   order (every lane gets the same bits; the shuffles sit outside any
//   branch, which would wrap each in a convergence loop).
// - The GRU writes its pre-activations into A, then a flat pass over all of
//   the CTA's (slot, column) turns them into the gradient [a_r, a_z, a_n,
//   a_n r] in place, from which dgi and dgh are read; dx overwrites the
//   cotangent it came from. This keeps the flagship's 30 slots on one CTA.
// - The weight gradients are stored, never read back: each CTA writes the
//   partial of its slots once a GRU iteration, and the second launch adds
//   them in a fixed order, 32 outputs a block, eight warps a term each.
// - dk and dv accumulate in registers (one, two or three 4 x 4 tiles of
//   each a thread, the fewest that cover them: each instance of the kernel
//   holds its own count); the CTAs' partials meet in shared memory at the
//   end and are summed across the cluster in rank order. Each iteration's
//   two cluster barriers are split into arrive and wait: dk's update runs
//   inside the first, dv's and the weight gradients inside the second.
// - The renorm's row sums (rs, rg) are added in f64, as the tiled route
//   adds them: the renorm divides by rs, near zero on some rows.
// - The next iteration's hist rows are copied in while dh += dD k runs.
// Only T and sum_i rg_i / rs_i cross CTAs within an iteration, each added
// from all of the element's per-slot values through distributed shared
// memory in the slots' order. No float atomics: the gradient is the same
// bits from run to run. Where no cluster of 8 CTAs holds an element's share
// of the backward's state (S=1000 at N=81, d past 84 at N=49), or dk and
// dv exceed three tiles a thread (N/4 * d/4 > 768: N=196 at S=30), the
// wrapper plans the tiled route below instead: the same formulas as a chain
// of launches over the batch, with the intermediates in device memory.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include <algorithm>
#include <type_traits>

#include "xslot_common.cuh"
#include "xslot_tiled.cuh"

using namespace xslot;

namespace {

constexpr int kMaxParts = 8;    // lanes a task's inner terms split over
constexpr int kMaxCluster = 8;  // the portable cluster limit
constexpr int kKvMax = 3;       // 4 x 4 tiles of dk and of dv a thread holds, at most
constexpr int kStampPhases = 9; // XSLOT_STAMP's slots an iteration

#ifdef XSLOT_STAMPS
// Clock stamps of the cluster kernel, for examples/torch_k1_bench.py
// --stamps, which builds this source with -DXSLOT_STAMPS into a library of
// its own. After a CTA barrier, thread 0 of each of the first kStampCtas
// CTAs writes clock64() to slot 0 at the start, to slot 1 + kStampPhases j
// + p at the end of phase p of the j-th iteration walked (a phase an
// iteration skips leaves its slot unwritten), and to the two slots after
// the iterations at the end of the d_slots0 store and of the dk/dv sum.
constexpr int kStampSlots = 32, kStampCtas = 160;
__device__ long long g_stamps[kStampCtas * kStampSlots];
#define XSLOT_STAMP(i)                                                  \
  do {                                                                  \
    __syncthreads();                                                    \
    if (threadIdx.x == 0 && blockIdx.x < kStampCtas && (i) < kStampSlots) \
      g_stamps[blockIdx.x * kStampSlots + (i)] = clock64();             \
  } while (0)
#else
#define XSLOT_STAMP(i) ((void)0)
#endif

// Layout of one CTA's dynamic shared memory, in floats (ld = d + 4, np = n
// rounded up to 4, the rows and columns past n zero): W_ih and W_hh
// (resident, 2 x 3d x (d+4)); k, v (np, ld); h, upd (then the next
// iteration's h), the cotangents leaving and entering the iteration (4 x slp
// x ld); dots, attn, P (3 x slp x np); row sums, rg and rg / row sums (3 x
// slp); the GRU's gradient [a_r, a_z, a_n, a_n r] (slp x 4d); b_ih, b_hh (6d).
__host__ __device__ inline size_t bwd_smem_floats(int n, int s_cta, int d) {
  const size_t slp = round4(s_cta), ld = row_ld(d), np = round4(n);
  return tile_floats(d, true) + 2 * np * ld + 4 * slp * ld + 3 * slp * np + 3 * slp +
         4 * slp * d + 6 * d;
}

inline size_t bwd_smem_bytes(int n, int s_cta, int d) {
  return bwd_smem_floats(n, s_cta, d) * sizeof(float);
}

// floats of one partial: dW_ih, dW_hh (3d, d), db_ih, db_hh (3d)
__host__ __device__ inline size_t partial_floats(int d) { return 6 * (size_t)d * d + 6 * d; }

// dk's and dv's 4 x 4 tiles a thread holds for N rows of d columns: the
// fewest that cover them, or 0 past kKvMax.
__host__ __device__ inline int kv_tiles(int n, int d) {
  const long long tiles = (long long)round4(n) / 4 * (d / 4);
  const int k = (int)((tiles + kThreads - 1) / kThreads);
  return k <= kKvMax ? k : 0;
}

// The lanes a product's inner terms split over: the most, a power of two up
// to kMaxParts, with which its `tasks` still fit in one pass of the CTA.
__device__ __forceinline__ int split_parts(int tasks) {
  int parts = 1;
  while (parts < kMaxParts && tasks * 2 * parts <= kThreads) parts *= 2;
  return parts;
}

// a[o] for a runtime o < N, by selects (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int o) {
  float v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = o == k ? a[k] : v;
  return v;
}

// Adds each v[i] over the `parts` neighbouring lanes of a task (xor
// butterfly: every lane gets the same bits). Every lane shuffles at every
// level, outside any branch, and a level past `parts` adds nothing: a
// shuffle under a branch costs a warp-convergence wrapper each.
template <int N>
__device__ __forceinline__ void lanes_sum(float (&v)[N], int parts) {
#pragma unroll
  for (int o = kMaxParts >> 1; o > 0; o >>= 1) {
    float w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = __shfl_xor_sync(0xffffffffu, v[i], o);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = o < parts ? v[i] + w[i] : v[i];
  }
}

// The inner steps of lane `part` of `parts` over `count` terms (interleaved).
__device__ __forceinline__ int lane_steps(int count, int part, int parts) {
  return (count - part + parts - 1) / parts;
}

// out[s][m] = (x[s] . y[m]) * mul / div (+ add[s * ldadd + m]) for s < sl, m
// < rows_y, then times attn (1 - attn) at out's index where attn is given
// (the renorm's G): x (slp, d) and y (rows_y, d) in shared memory with row
// stride ld, out and attn with row stride ldo. A task takes four slots at
// one m, so each float4 of y serves four dot products; its d/4 column quads
// split over split_parts lanes, and lane `part` stores the slots o = part +
// parts t.
template <typename T>
__device__ void dot_rows(float* out, int ldo, const float* x, const float* y, int ld, int sl,
                         int rows_y, int d, float mul, float div, const T* __restrict__ add,
                         int ldadd, const float* attn) {
  const int tasks = ((sl + 3) >> 2) * rows_y;
  const int parts = split_parts(tasks), part = threadIdx.x & (parts - 1);
  for (int base = 0; base < tasks; base += kThreads / parts) {
    const int task = base + threadIdx.x / parts;
    const bool valid = task < tasks;
    const int g = valid ? task / rows_y : 0, m = valid ? task - g * rows_y : 0, s = 4 * g;
    float acc[4] = {};
    const int steps = lane_steps(d >> 2, part, parts);
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      const int c = 4 * (part + k * parts);
      const float4 yv = *reinterpret_cast<const float4*>(y + m * ld + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] = dot4(*reinterpret_cast<const float4*>(x + (s + r) * ld + c), yv, acc[r]);
      }
    }
    lanes_sum(acc, parts);
#pragma unroll 1
    for (int r = part; r < 4; r += parts) {
      if (!valid || s + r >= sl) continue;
      const int i = (s + r) * ldo + m;
      float v = pick(acc, r) * mul / div;
      if (add) v = to_f32(add[(s + r) * ldadd + m]) + v;
      if (attn) v = v * attn[i] * (1.0f - attn[i]);
      out[i] = v;
    }
  }
}

// One product of rows_split: out[s][j] (+)= (sum_i a[s][col(i)] b[i][j]) / div
// with col(i) = i, or i + shift from `from` on (dgh's columns in the GRU's
// gradient; `from` and `shift` multiples of 4).
struct RowsOp {
  float* out;
  const float* a;
  int lda, from, shift;
  const float* b;
  int ldb;
  bool accumulate;
};

// One or two products of one shape (`ops`) over the CTA's sl slots, j < d,
// `inner` terms (a multiple of 4: a's columns and b's rows past the true
// count are zero): a (slp, lda) and b (inner, ldb) in shared memory, 16-byte
// rows, out with row stride ldo. A task takes G slots at four consecutive j;
// a step reads four inner terms of each of its slots' rows and the four rows
// of b they meet, a float4 each, for 16 G FMAs. Its steps split over
// split_parts lanes (interleaved), and lane `part` stores the outputs o =
// part + parts t (slot o / 4, j o % 4).
template <int G>
__device__ void rows_split(const RowsOp& p0, const RowsOp& p1, int ops, int ldo, int sl,
                           int inner, int d, float div) {
  const int nq = d >> 2, per_op = ((sl + G - 1) / G) * nq, tasks = ops * per_op;
  const int parts = split_parts(tasks), part = threadIdx.x & (parts - 1);
  for (int base = 0; base < tasks; base += kThreads / parts) {
    const int task = base + threadIdx.x / parts;
    const bool valid = task < tasks;
    const int op = valid ? task / per_op : 0, rest = valid ? task - op * per_op : 0;
    const RowsOp p = op ? p1 : p0;
    const int q = rest % nq, s = G * (rest / nq);
    float acc[4 * G] = {};
    const int steps = lane_steps(inner >> 2, part, parts);
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      const int i = 4 * (part + k * parts);
      const int ai = i < p.from ? i : i + p.shift;
      float4 av[G], bv[4];
#pragma unroll
      for (int r = 0; r < G; ++r) av[r] = *reinterpret_cast<const float4*>(p.a + (s + r) * p.lda + ai);
#pragma unroll
      for (int t = 0; t < 4; ++t) bv[t] = *reinterpret_cast<const float4*>(p.b + (i + t) * p.ldb + 4 * q);
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[4 * r + e] = fmaf(comp(av[r], t), comp(bv[t], e), acc[4 * r + e]);
          }
    }
    lanes_sum(acc, parts);
#pragma unroll 1
    for (int o = part; o < 4 * G; o += parts) {
      const int r = o >> 2;
      if (!valid || s + r >= sl) continue;
      float* out = p.out + (s + r) * ldo + 4 * q + (o & 3);
      const float v = pick(acc, o) / div;
      *out = p.accumulate ? *out + v : v;
    }
  }
}

constexpr int kGruGroup = 8;  // slots a task of the GRU's gates takes

// The GRU's gates again for the CTA's slots, from W_ih and W_hh resident in
// `w` and the biases b_ih, b_hh in `bias` (3d each): A[s] = [ir + hr, iz +
// hz, in, hn] (row stride 4d), the pre-activations gru_grads reads. A task
// takes kGruGroup slots at one output column j: the rows j, d + j, 2d + j of
// both matrices, read once for the group (a group past the share reads rows
// past it, whose sums it drops). Its d/4 inner quads split over split_parts
// lanes, and after their sum lane `part` stores the group's slots o with o
// % parts == part.
__device__ void gru_gates(float* A, const float* x, const float* h, const float* w,
                          const float* bias, int sl, int d) {
  const int ld = row_ld(d), wld = w_ld(d, true), a4 = 4 * d;
  const int tasks = (sl + kGruGroup - 1) / kGruGroup * d;
  const int parts = split_parts(tasks), part = threadIdx.x & (parts - 1);
  const float* wi = w;
  const float* wh = w + (size_t)3 * d * wld;
  for (int base = 0; base < tasks; base += kThreads / parts) {
    const int task = base + threadIdx.x / parts;
    const bool valid = task < tasks;
    const int grp = valid ? task / d : 0, j = valid ? task - grp * d : 0;
    const int sg = kGruGroup * grp;
    float gi[kGruGroup * 3] = {}, gh[kGruGroup * 3] = {};  // [slot][gate]
    const int steps = lane_steps(d >> 2, part, parts);
    for (int k = 0; k < steps; ++k) {
      const int c = 4 * (part + k * parts);
      float4 a[3], bw[3];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        a[gt] = *reinterpret_cast<const float4*>(wi + (gt * d + j) * wld + c);
        bw[gt] = *reinterpret_cast<const float4*>(wh + (gt * d + j) * wld + c);
      }
#pragma unroll
      for (int r = 0; r < kGruGroup; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (sg + r) * ld + c);
        const float4 hv = *reinterpret_cast<const float4*>(h + (sg + r) * ld + c);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          gi[3 * r + gt] = dot4(xv, a[gt], gi[3 * r + gt]);
          gh[3 * r + gt] = dot4(hv, bw[gt], gh[3 * r + gt]);
        }
      }
    }
    lanes_sum(gi, parts);
    lanes_sum(gh, parts);
#pragma unroll
    for (int r = 0; r < kGruGroup; ++r) {
      if (!valid || (r & (parts - 1)) != part || sg + r >= sl) continue;
      float* ar = A + (sg + r) * a4 + j;
      ar[0] = (gi[3 * r] + bias[j]) + (gh[3 * r] + bias[3 * d + j]);
      ar[d] = (gi[3 * r + 1] + bias[d + j]) + (gh[3 * r + 1] + bias[4 * d + j]);
      ar[2 * d] = gi[3 * r + 2] + bias[2 * d + j];
      ar[3 * d] = gh[3 * r + 2] + bias[5 * d + j];
    }
  }
}

// The GRU's backward for cotangent g, in place of gru_gates' pre-activations:
// A[s] = [a_r, a_z, a_n, a_n r], dh = g z, over all of the CTA's (slot, j),
// two a thread side by side.
__device__ void gru_grads(float* A, float* dh, const float* g, const float* h, int sl, int d) {
  const int ld = row_ld(d), a4 = 4 * d, total = sl * d;
  for (int i0 = threadIdx.x; i0 < total; i0 += 2 * kThreads) {
    int at[2], hi[2];
    float pre[2][4], gv[2], hv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = min(i0 + u * kThreads, total - 1), si = i / d, j = i - si * d;
      at[u] = si * a4 + j;
      hi[u] = si * ld + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[u][q] = A[at[u] + q * d];
      gv[u] = g[hi[u]];
      hv[u] = h[hi[u]];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && i0 + kThreads >= total) break;
      const float rg_ = sigmoid_f32(pre[u][0]);
      const float zg = sigmoid_f32(pre[u][1]);
      const float hn = pre[u][3];
      const float ng = tanhf(pre[u][2] + rg_ * hn);
      const float dn = gv[u] * (1.0f - zg), dz = gv[u] * (hv[u] - ng);
      const float a_n = dn * (1.0f - ng * ng);
      float* ar = A + at[u];
      ar[0] = a_n * hn * rg_ * (1.0f - rg_);
      ar[d] = dz * zg * (1.0f - zg);
      ar[2 * d] = a_n;
      ar[3 * d] = a_n * rg_;
      dh[hi[u]] = gv[u] * zg;
    }
  }
}

// part = the CTA's partial of one GRU iteration, stored: dW_ih = dgi^T x and
// dW_hh = dgh^T h over its slots (dgi's rows are A's columns 0..3d, dgh's
// 0..2d and 3d..4d), db_ih and db_hh their column sums. A task is (matrix,
// four rows, four columns); a thread runs two of them side by side.
__device__ void weight_grads(float* __restrict__ part, const float* A, const float* x,
                             const float* h, int ld, int sl, int d) {
  const int nq = d >> 2, rq = (3 * d) >> 2, a4 = 4 * d, tasks = 2 * rq * nq;
  for (int t0 = threadIdx.x; t0 < tasks; t0 += 2 * blockDim.x) {
    const int pair[2] = {t0, min(t0 + (int)blockDim.x, tasks - 1)};
    int col[2], xoff[2];
    const float* xm[2];
    float* out[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = pair[u] % nq, rest = pair[u] / nq, m = rest / rq, r4 = 4 * (rest - m * rq);
      col[u] = m && r4 >= 2 * d ? r4 + d : r4;
      xm[u] = m ? h : x;
      xoff[u] = 4 * q;
      out[u] = part + (size_t)m * 3 * d * d + (size_t)r4 * d + 4 * q;
    }
    float acc[2][4][4] = {};
#pragma unroll 2
    for (int s = 0; s < sl; ++s) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 gv = *reinterpret_cast<const float4*>(A + s * a4 + col[u]);
        const float4 xv = *reinterpret_cast<const float4*>(xm[u] + s * ld + xoff[u]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[u][a][e] = fmaf(comp(gv, a), comp(xv, e), acc[u][a][e]);
          }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && t0 + (int)blockDim.x >= tasks) break;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        *reinterpret_cast<float4*>(out[u] + a * d) =
            make_float4(acc[u][a][0], acc[u][a][1], acc[u][a][2], acc[u][a][3]);
      }
    }
  }
  for (int i = threadIdx.x; i < 6 * d; i += blockDim.x) {
    const int m = i >= 3 * d, row = i - m * 3 * d;
    const int col = m && row >= 2 * d ? row + d : row;
    float acc = 0.0f;
    for (int s = 0; s < sl; ++s) acc += A[s * a4 + col];
    part[6 * (size_t)d * d + i] = acc;
  }
}

// acc[k][4j + e] += (sum_{s < sl} a[s][m + j] x[s][c + e]) / div for the
// thread's tiles k (task t + k kThreads = (m / 4, c / 4) of an output of
// `mq` row quads and d columns; a tile past the output repeats the last
// one, unstored): a (slp, lda) with zero columns past the true count, x
// (slp, d) with row stride ld. A slot's step reads a float4 of each for 16
// FMAs; the slots run outermost, so the thread's tiles are independent
// chains.
template <int K>
__device__ __forceinline__ void cols_accumulate(float (&acc)[K][16], const float* a, int lda,
                                                int mq, const float* x, int ld, int sl, int d,
                                                float div) {
  const int nq = d >> 2, tasks = mq * nq;
  int m[K], c[K];
  float sum[K][16];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int task = min((int)threadIdx.x + k * kThreads, tasks - 1);
    m[k] = 4 * (task / nq);
    c[k] = 4 * (task % nq);
#pragma unroll
    for (int o = 0; o < 16; ++o) sum[k][o] = 0.0f;
  }
#pragma unroll 2
  for (int s = 0; s < sl; ++s) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + s * lda + m[k]);
      const float4 xv = *reinterpret_cast<const float4*>(x + s * ld + c[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[k][4 * j + e] = fmaf(comp(av, j), comp(xv, e), sum[k][4 * j + e]);
        }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 0; o < 16; ++o) acc[k][o] += sum[k][o] / div;
}

// out[r] = sum_{m < n} a[r][m] (times b[r][m] where b is given) for r <
// rows, a and b with row stride lda, and q[r] = out[r] / rs[r] where q is
// given (the renorm's rg and rg / rs); one warp a row. Added in f64, as the
// tiled route adds them: the renorm divides by rs, which is near zero on
// some rows, and its gradient by rs^2.
__device__ inline void row_totals(float* out, float* q, const float* a, const float* b,
                                  const float* rs, int lda, int rows, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    double acc = 0.0;
    for (int i = lane; i < n; i += 32) {
      acc += b ? (double)a[r * lda + i] * b[r * lda + i] : (double)a[r * lda + i];
    }
    acc = warp_sum_f64(acc);
    if (lane == 0) {
      out[r] = (float)acc;
      if (q) q[r] = (float)(acc / rs[r]);
    }
  }
}

// cluster_slot_sum in two halves, so that work which touches neither the
// summed values nor any buffer a peer reads runs while the element's
// barrier completes: slot_sum_arrive once the values are written (a CTA
// barrier where the cluster is this CTA alone), slot_sum_wait for the sum.
__device__ __forceinline__ void slot_sum_arrive(cg::cluster_group& cluster) {
  if (cluster.num_blocks() == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
}

__device__ __forceinline__ float slot_sum_wait(cg::cluster_group& cluster, const float* vals,
                                               int s) {
  if (cluster.num_blocks() > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  return slot_values_sum(cluster, vals, s);
}

// T: the residuals' and dk's and dv's type (f32 or bf16); K: dk's and dv's
// 4 x 4 tiles a thread holds (kv_tiles).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
xslot_bwd_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ w_ih,
                 const T* __restrict__ w_hh, const T* __restrict__ b_ih,
                 const T* __restrict__ b_hh, const float* __restrict__ hist,
                 const float* __restrict__ du, const float* __restrict__ dattn,
                 T* __restrict__ dk_out, T* __restrict__ dv_out,
                 float* __restrict__ partials, float* __restrict__ dslots0, int n, int s, int d,
                 int iters, float scale, float div) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / c;
  int s0, sl;
  slot_range(s, c, rank, &s0, &sl);
  const int slp = round4(share_max(s, c)), ld = row_ld(d), wld = w_ld(d, true);
  const int np = round4(n), mq = np / 4;
  const size_t wmat = (size_t)3 * d * wld;

  float* w = smem;  // W_ih, then W_hh
  float* ks = w + 2 * wmat;
  float* vs = ks + np * ld;
  float* h = vs + np * ld;    // slots entering the iteration
  float* xb = h + slp * ld;   // upd, then the next iteration's h
  float* g = xb + slp * ld;   // cotangent of the slots leaving it, then dupd
  float* dh = g + slp * ld;   // cotangent of the slots entering it
  float* dots = dh + slp * ld;
  float* attn = dots + slp * np;
  float* p = attn + slp * np;  // dattn_tot, then G, then d dots
  float* rs = p + slp * np;
  float* rg = rs + slp;
  float* qv = rg + slp;
  float* A = qv + slp;        // [a_r, a_z, a_n, a_n r] a slot
  float* bias = A + slp * 4 * d;  // b_ih, then b_hh
  const size_t per_part = partial_floats(d);
  XSLOT_STAMP(0);

  load_rows(ks, ld, k + b * n * d, n, d);
  load_rows(vs, ld, v + b * n * d, n, d);
  load_rows(h, ld, hist + ((b * iters + iters - 1) * s + s0) * d, sl, d);
  load_rows(g, ld, du + (b * s + s0) * d, sl, d);  // the last iteration's dupd
  copy_commit();
  // every row the copies leave out is zero: k's and v's past n, the slot
  // buffers' past sl, and the rest whole
  zero(ks + n * ld, (size_t)(np - n) * ld);
  zero(vs + n * ld, (size_t)(np - n) * ld);
  zero(h + sl * ld, (size_t)(slp - sl) * ld);
  zero(xb, (size_t)slp * ld);
  zero(g + sl * ld, (size_t)(slp - sl) * ld);
  zero(dh, (size_t)(A + slp * 4 * d - dh));

  float dk_acc[K][16] = {}, dv_acc[K][16] = {};
  const RowsOp none{};
  for (int it = iters - 1; it >= 0; --it) {
    const bool last = it == iters - 1;
    [[maybe_unused]] const int phase = 1 + kStampPhases * (iters - 1 - it);  // its first stamp
    // hist[:, it] (and at the last iteration k, v and du) have landed; the
    // GRU's weights and biases follow while the last iteration (no GRU) runs
    copy_wait<0>();
    __syncthreads();
    if (last && iters > 1) {
      stage_all(w, w_ih, w_hh, d);
      load_rows(bias, 3 * d, b_ih, 1, 3 * d);
      load_rows(bias + 3 * d, 3 * d, b_hh, 1, 3 * d);
      copy_commit();
    }
    XSLOT_STAMP(phase);  // 0: the hist load
    // rebuild the iteration's forward: dots, row sums and T, attn
    dot_rows(dots, np, h, ks, ld, sl, n, d, scale, 1.0f, (const float*)nullptr, 0, nullptr);
    __syncthreads();
    row_totals(rs, nullptr, dots, nullptr, nullptr, np, sl, n);
    XSLOT_STAMP(phase + 1);  // 1: dots, row sums
    slot_sum_arrive(cluster);
    // while the element's CTAs meet: the previous iteration's dk += dD^T h
    // (its dD in p, its h in xb since the swap)
    if (!last) cols_accumulate(dk_acc, p, np, mq, xb, ld, sl, d, 1.0f);
    const float total = slot_sum_wait(cluster, rs, s);
    XSLOT_STAMP(phase + 2);  // 2: the T barrier, dk
    for (int i = threadIdx.x; i < sl * n; i += blockDim.x) {
      const int si = i / n, e = si * np + i - si * n;
      attn[e] = sigmoid_f32(dots[e] / rs[si] * total);
    }
    __syncthreads();
    XSLOT_STAMP(phase + 3);  // 3: attn

    if (!last) {
      // upd, the GRU's gates and their backward for cotangent g
      rows_split<2>(RowsOp{xb, attn, np, np, 0, vs, ld, false}, none, 1, ld, sl, np, d, div);
      __syncthreads();
      gru_gates(A, xb, h, w, bias, sl, d);
      __syncthreads();
      gru_grads(A, dh, g, h, sl, d);
      __syncthreads();
      XSLOT_STAMP(phase + 4);  // 4: x, the GRU's gates and gradient
      // dx into g (read above for the last time), dh += dgh W_hh
      rows_split<4>(RowsOp{g, A, 4 * d, 3 * d, 0, w, wld, false},
                    RowsOp{dh, A, 4 * d, 2 * d, d, w + wmat, wld, true}, 2, ld, sl, 3 * d, d,
                    1.0f);
      __syncthreads();
      XSLOT_STAMP(phase + 5);  // 5: dx, dh
    }

    // attention: dattn_tot and G in place of P; rg, q and their total
    dot_rows(p, np, g, vs, ld, sl, n, d, 1.0f, div,
             last ? dattn + (b * s + s0) * n : nullptr, n, attn);
    __syncthreads();
    row_totals(rg, qv, p, dots, rs, np, sl, n);
    XSLOT_STAMP(phase + 6);  // 6: P, G, rg
    slot_sum_arrive(cluster);
    // while the element's CTAs meet: dv, and the GRU's dW and db
    cols_accumulate(dv_acc, attn, np, mq, g, ld, sl, d, div);
    if (!last) {
      weight_grads(partials + ((size_t)blockIdx.x * (iters - 1) + (iters - 2 - it)) * per_part,
                   A, xb, h, ld, sl, d);
    }
    const float qsum = slot_sum_wait(cluster, qv, s);
    XSLOT_STAMP(phase + 7);  // 7: the q barrier, dv, dW
    for (int i = threadIdx.x; i < sl * n; i += blockDim.x) {
      const int si = i / n, e = si * np + i - si * n;
      p[e] = (total * p[e] / rs[si] - total * rg[si] / (rs[si] * rs[si]) + qsum) * scale;
    }
    __syncthreads();
    if (it > 0) {  // upd is spent: the next iteration's h lands there
      load_rows(xb, ld, hist + ((b * iters + it - 1) * s + s0) * d, sl, d);
      copy_commit();
    }
    // dh (+)= dD k (dk += dD^T h waits for the next iteration's barrier)
    rows_split<2>(RowsOp{dh, p, np, np, 0, ks, ld, !last}, none, 1, ld, sl, np, d, 1.0f);
    __syncthreads();
    XSLOT_STAMP(phase + 8);  // 8: dD, dh
    float* t = g;
    g = dh;
    dh = t;
    if (it > 0) {
      t = h;
      h = xb;
      xb = t;
    }
  }

  cols_accumulate(dk_acc, p, np, mq, h, ld, sl, d, 1.0f);  // iteration 0's
  store_rows(dslots0 + (b * s + s0) * d, g, ld, sl, d);
  XSLOT_STAMP(1 + kStampPhases * iters);
  // dk and dv: each CTA's partials go to its k and v rows (spent since the
  // last barrier), then the CTAs' partials are summed in rank order, each
  // CTA writing its share of the rows; the second sync keeps this CTA's
  // partials alive while its peers read them
  const int nq = d >> 2;
  float* dk_s = ks;
  float* dv_s = vs;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int task = threadIdx.x + t * kThreads;
    if (task >= mq * nq) continue;
    const int m = 4 * (task / nq), col = 4 * (task % nq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (m + j >= n) continue;
      const float* kr = dk_acc[t] + 4 * j;
      const float* vr = dv_acc[t] + 4 * j;
      *reinterpret_cast<float4*>(dk_s + (m + j) * d + col) = make_float4(kr[0], kr[1], kr[2], kr[3]);
      *reinterpret_cast<float4*>(dv_s + (m + j) * d + col) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    }
  }
  element_sync(cluster);
  int n0, nl;
  slot_range(n, c, rank, &n0, &nl);
  for (int i = threadIdx.x; i < nl * d; i += blockDim.x) {
    const int idx = n0 * d + i;
    float pk[kMaxCluster], pv[kMaxCluster];  // every rank's loads in flight together
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      pk[r] = r < c ? cluster.map_shared_rank(dk_s, r)[idx] : 0.0f;
      pv[r] = r < c ? cluster.map_shared_rank(dv_s, r)[idx] : 0.0f;
    }
    float sk = 0.0f, sv = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < c) {
        sk += pk[r];
        sv += pv[r];
      }
    }
    dk_out[b * n * d + idx] = from_f32<T>(sk);
    dv_out[b * n * d + idx] = from_f32<T>(sv);
  }
  XSLOT_STAMP(2 + kStampPhases * iters);
  if (c > 1) cluster.sync();
}

// The gradient kernel's instance for residuals of type T and dk and dv of N
// rows of d columns, or nullptr where they do not fit a thread's registers.
// Each holds the fewest tiles that cover them: unused tiles cost time (an
// instance of two tiles ran the flagship's shapes 13-17% slower than one of
// one tile, one of three 6-12% slower than two at N=81; NVIDIA H100 80GB
// HBM3, 700 W, examples/torch_k1_bench.py --cluster).
template <typename T>
using BwdKernel = decltype(&xslot_bwd_kernel<T, 1>);
template <typename T>
inline BwdKernel<T> bwd_kernel(int n, int d) {
  switch (kv_tiles(n, d)) {
    case 1:
      return &xslot_bwd_kernel<T, 1>;
    case 2:
      return &xslot_bwd_kernel<T, 2>;
    case 3:
      return &xslot_bwd_kernel<T, 3>;
    default:
      return nullptr;
  }
}

// The cluster route's partials: one a CTA and GRU iteration.
inline size_t cluster_parts(int batch, int cluster, int iters) {
  return (size_t)batch * cluster * (iters - 1);
}

// Output e of the sums over the batch: dw_ih, dw_hh (3d x d), db_ih, db_hh
// (3d), then d_init (S x d), in that order, in the outputs' type T.
template <typename T>
__device__ __forceinline__ void store_sum(int e, float acc, int d, T* __restrict__ dw_ih,
                                          T* __restrict__ dw_hh, T* __restrict__ db_ih,
                                          T* __restrict__ db_hh, T* __restrict__ d_init) {
  const int per_part = (int)partial_floats(d), dd = 3 * d * d;
  const T v = from_f32<T>(acc);
  if (e < dd) {
    dw_ih[e] = v;
  } else if (e < 2 * dd) {
    dw_hh[e - dd] = v;
  } else if (e < 2 * dd + 3 * d) {
    db_ih[e - 2 * dd] = v;
  } else if (e < per_part) {
    db_hh[e - 2 * dd - 3 * d] = v;
  } else {
    d_init[e - per_part] = v;
  }
}

// Output e of the sums over the batch (store_sum's order), each added in a
// fixed order: the dW and db partials (partial p at partials + p * per_cta),
// and the elements' rows of dslots0 (B, S*d) into d_init.
template <typename T>
__device__ __forceinline__ void sum_partials(int e, const float* __restrict__ partials,
                                             int nparts, const float* __restrict__ dslots0,
                                             int batch, int sd, int d, T* __restrict__ dw_ih,
                                             T* __restrict__ dw_hh, T* __restrict__ db_ih,
                                             T* __restrict__ db_hh, T* __restrict__ d_init) {
  const int per_cta = (int)partial_floats(d);
  if (e < per_cta) {
    float acc = 0.0f;
    for (int i = 0; i < nparts; ++i) acc += partials[(size_t)i * per_cta + e];
    store_sum(e, acc, d, dw_ih, dw_hh, db_ih, db_hh, d_init);
  } else if (e < per_cta + sd) {
    const int f = e - per_cta;
    float acc = 0.0f;
    for (int i = 0; i < batch; ++i) acc += dslots0[(size_t)i * sd + f];
    store_sum(e, acc, d, dw_ih, dw_hh, db_ih, db_hh, d_init);
  }
}

constexpr int kSumWarps = kThreads / 32;

// The cluster route's sums over the batch, store_sum's outputs 32 a block:
// lane l takes output 32 blockIdx.x + l, warp w adds its terms w, w + 8, ...
// (the partials, one a CTA and GRU iteration, or the elements' d_slots0
// rows) in order, and warp 0 adds the eight warps' sums in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_sum_kernel(const float* __restrict__ partials, int nparts,
                   const float* __restrict__ dslots0, int batch, int sd, int d,
                   T* __restrict__ dw_ih, T* __restrict__ dw_hh, T* __restrict__ db_ih,
                   T* __restrict__ db_hh, T* __restrict__ d_init) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_part = (int)partial_floats(d), e = blockIdx.x * 32 + lane;
  const bool head = e < per_part, inside = e < per_part + sd;
  const float* src = head ? partials + e : dslots0 + (e - per_part);
  const size_t stride = head ? per_part : sd;
  const int terms = inside ? (head ? nparts : batch) : 0;
  float acc = 0.0f;
#pragma unroll 4
  for (int i = warp; i < terms; i += kSumWarps) acc += src[i * stride];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && inside) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += sums[w][lane];
    store_sum(e, total, d, dw_ih, dw_hh, db_ih, db_hh, d_init);
  }
}

// ------------------------------------------------------------ tiled route
//
// Where an element's share of the slots does not fit in a cluster of 8 CTAs
// (S=1000 at N=81, N=196 at S=30, at d=64), each iteration's backward runs
// as a chain of launches over the whole batch, its intermediates in device
// memory (~3.5 MB an element at (81, 1000), held in L2 between launches).
// Every output element adds its terms in a fixed order in f32 FMA, with no
// float atomics and no TF32, so the route gives the same bits from call to
// call.
//
// What bounds it: the products, 7.7 GFLOP at (16, 81, 1000), 0.115 ms at the
// card's f32 rate (the bytes take 0.007 ms). What the design does about it:
// - tile_gemm, a register-tiled SIMT product: a CTA of 256 threads computes
//   a 128 x BN tile (BN 64 or 128, tile_cols picks per product), each thread
//   8 x BN/16 outputs. Both operands are staged k-major in shared memory, 16
//   inner terms a stage, two stages deep (Route: cp.async where an operand
//   is contiguous along the tile, register loads stored down the columns
//   where it is contiguous along the inner terms), and read back as float4:
//   at BN = 128 four shared loads feed 64 FMAs. The epilogue goes through
//   shared memory half a tile at a time, so its loads and stores are
//   coalesced whatever the output's alignment (N=81 rows are not).
// - Products whose second operand the batch shares (the GRU's gates and
//   their input gradients) fold the batch into rows: one product over B*S
//   rows.
// - Independent products of one shape share a launch, the grid picking the
//   operand pair: gi with gh, dx with dh, dW_ih with dW_hh, dv with dk.
// - Where one CTA tile spans a whole row (N <= 128), the row passes run in a
//   product's epilogue: the dots' row sums, and the renorm's gradient (G, rg,
//   rg / rs) with P. db rides in dW's product as the row sums of its first
//   operand. These row sums (rs, rg) are added in f64: the renorm divides by
//   rs, which is near zero on some rows, and its gradient by rs^2. Each
//   element's totals (T, sum_i rg_i / rs_i) are taken in every CTA of the
//   pass that reads them, in a fixed order.
// - Products with the slots as their inner dimension and too few tiles to
//   fill the card (dW, dv and dk at B=16) split the slots into pieces. Each
//   (piece, element) keeps its own partial across the iterations; the first
//   iteration to write one stores it, and the route's last launch adds them
//   in order. An unsplit dv or dk goes straight to its output.
// tiled_plan gives each product's tile width, pieces and rows, and the
// scratch.

// The GRU's backward per (element, slot, j): gi, gh (B, S, 3d) hold the gate
// pre-activations with their biases and are overwritten with dgi and dgh; g
// is the cotangent of the slots leaving the iteration, h (rows hz apart per
// element) the slots entering it; dh = g z. Indices are 32-bit (count =
// B*S*d < 2^31): 64-bit divisions cost more than the pass's arithmetic.
__global__ void gru_bwd_kernel(float* __restrict__ gi, float* __restrict__ gh,
                               const float* __restrict__ g, const float* __restrict__ h,
                               long long hz, int s, int d, int count, float* __restrict__ dh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int row = i / d, j = i - row * d;
  float* gi_row = gi + (size_t)row * 3 * d;
  float* gh_row = gh + (size_t)row * 3 * d;
  const float rg = sigmoid_f32(gi_row[j] + gh_row[j]);
  const float zg = sigmoid_f32(gi_row[d + j] + gh_row[d + j]);
  const float hn = gh_row[2 * d + j];
  const float ng = tanhf(gi_row[2 * d + j] + rg * hn);
  const int zi = row / s;
  const float gv = g[i], hv = h[zi * hz + (long long)(row - zi * s) * d + j];
  const float dn = gv * (1.0f - zg), dz = gv * (hv - ng);
  const float a_n = dn * (1.0f - ng * ng);
  const float a_r = a_n * hn * rg * (1.0f - rg);
  const float a_z = dz * zg * (1.0f - zg);
  gi_row[j] = a_r;
  gi_row[d + j] = a_z;
  gi_row[2 * d + j] = a_n;
  gh_row[j] = a_r;
  gh_row[d + j] = a_z;
  gh_row[2 * d + j] = a_n * rg;
  dh[i] = gv * zg;
}

// Per row of P (one warp a row): G = P attn (1 - attn) in place of P,
// rg = sum_j G D (in f64) and q = rg / rs (where P's product cannot).
__global__ void renorm_grad_kernel(float* __restrict__ p, const float* __restrict__ attn,
                                   const float* __restrict__ dots, const float* __restrict__ rs,
                                   long long rows, int n, float* __restrict__ rg,
                                   float* __restrict__ q) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  double acc = 0.0;
  for (int j = lane; j < n; j += 32) {
    const long long i = r * n + j;
    const float gv = p[i] * attn[i] * (1.0f - attn[i]);
    p[i] = gv;
    acc += (double)gv * dots[i];
  }
  acc = warp_sum_f64(acc);
  if (lane == 0) {
    rg[r] = (float)acc;
    q[r] = (float)(acc / rs[r]);
  }
}

// dD = (T G / rs - T rg / rs^2 + sum_i q_i) * scale in place of G over
// element blockIdx.y's (S, N), T the sum of its row sums
__global__ void ddots_kernel(float* __restrict__ p, const float* __restrict__ rs,
                             const float* __restrict__ rg, const float* __restrict__ q, int s,
                             int n, float scale) {
  __shared__ float sums[2][kThreads / 32 + 1];
  const int z = blockIdx.y, sn = s * n;
  const float t = block_slot_total(rs + (size_t)z * s, s, sums[0]);
  const float qsum = block_slot_total(q + (size_t)z * s, s, sums[1]);
  float* p_z = p + (size_t)z * sn;
  const float* r_z = rs + (size_t)z * s;
  const float* g_z = rg + (size_t)z * s;
  const int step = gridDim.x * blockDim.x;
  for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < sn; i0 += kBatch * step) {
    float x[kBatch], r[kBatch], g[kBatch];  // a batch's loads in flight together
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * step, row = (i < sn ? i : 0) / n;
      x[k] = i < sn ? p_z[i] : 0.0f;
      r[k] = r_z[row];
      g[k] = g_z[row];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * step;
      if (i < sn) p_z[i] = (t * x[k] / r[k] - t * g[k] / (r[k] * r[k]) + qsum) * scale;
    }
  }
}

// The sums that end the tiled route, each in a fixed order, written in the
// outputs' type T: the (piece, element) partials of dW and db and the
// elements' rows of d_slots0 as sum_partials adds them, then, where dv and
// dk went to the scratch (split, or bf16 outputs), their `pieces` pieces
// (dv's, then dk's, each (pieces, bnd) floats).
template <typename T>
__global__ void tiled_sum_kernel(const float* __restrict__ partials, int nparts,
                                 const float* __restrict__ dslots0, int batch, int sd, int d,
                                 T* __restrict__ dw_ih, T* __restrict__ dw_hh,
                                 T* __restrict__ db_ih, T* __restrict__ db_hh,
                                 T* __restrict__ d_init, const float* __restrict__ kv,
                                 int pieces, long long bnd, T* __restrict__ dv,
                                 T* __restrict__ dk) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long head = (long long)partial_floats(d) + sd;
  if (e < head) {
    sum_partials((int)e, partials, nparts, dslots0, batch, sd, d, dw_ih, dw_hh, db_ih, db_hh,
                 d_init);
  } else if (kv != nullptr && e < head + 2 * bnd) {
    const long long f = e - head, grp = f >= bnd, r = f - grp * bnd;
    const float* src = kv + grp * pieces * bnd + r;
    float acc = 0.0f;
    for (int p = 0; p < pieces; ++p) acc += src[p * bnd];
    (grp ? dk : dv)[r] = from_f32<T>(acc);
  }
}

enum { kDots, kX, kGates, kDGates, kDW, kP, kDH, kDKV, kProducts };

// The tiled route's plan at (batch, N, S, d) on a card of `sms` SMs: its
// products (in the order of the enum above), whether the row passes ride in
// the products' epilogues and the scratch in floats (with bf16 residuals
// also their f32 copies and dv's and dk's f32 sums).
struct TiledPlan {
  ProductPlan prod[kProducts];
  bool fused;
  size_t scratch;
};

inline TiledPlan tiled_plan(int batch, int n, int s, int d, int sms, bool bf16) {
  TiledPlan t;
  const int bs = batch * s;
  t.prod[kDots] = plan_product(s, n, d, batch, 1, false, sms);
  t.prod[kX] = plan_product(s, d, n, batch, 1, false, sms);
  t.prod[kGates] = plan_product(bs, 3 * d, d, 1, 2, false, sms);
  t.prod[kDGates] = plan_product(bs, d, 3 * d, 1, 2, false, sms);
  t.prod[kDW] = plan_product(3 * d, d, s, batch, 2, true, sms);
  t.prod[kP] = plan_product(s, n, d, batch, 1, false, sms);
  t.prod[kDH] = plan_product(s, d, n, batch, 1, false, sms);
  t.prod[kDKV] = plan_product(n, d, s, batch, 2, true, sms);
  t.fused = n <= t.prod[kDots].bn;
  const int kv = t.prod[kDKV].pieces;
  // the (piece, element) dW and db partials; g, dh, x, dx (B, S, d); gi, gh
  // (B, S, 3d); dots, attn, P (B, S, N); rs, rg, q (B, S); dv's and dk's
  // pieces; with bf16 residuals their f32 copies (k, v, W_ih, W_hh, b_ih, b_hh)
  // from the next multiple of 4 floats
  const size_t bnd = (size_t)batch * n * d;
  t.scratch = (size_t)t.prod[kDW].pieces * batch * partial_floats(d) +
              (size_t)bs * (10 * d + 3 * n + 3) + (kv > 1 || bf16 ? 2 * (size_t)kv * bnd : 0) +
              (bf16 ? 2 * bnd + 6 * (size_t)d * d + 6 * (size_t)d + 3 : 0);
  return t;
}

// The tiled route: the same gradient as xslot_bwd_kernel + cluster_sum_kernel,
// for residuals and gradients of type T (f32 or bf16).
template <typename T>
int tiled_bwd(const T* k_in, const T* v_in, const T* w_ih_in, const T* w_hh_in,
              const T* b_ih_in, const T* b_hh_in, const float* hist, const float* du,
              const float* dattn, T* dk, T* dv, T* d_init, T* dw_ih, T* dw_hh, T* db_ih,
              T* db_hh, float* scratch, int batch, int n, int s, int d, int iters, float scale,
              float div, cudaStream_t stream) {
  constexpr bool bf16 = !std::is_same<T, float>::value;
  int sms = 0;
  XSLOT_TRY(device_sms(&sms));
  const TiledPlan plan = tiled_plan(batch, n, s, d, sms, bf16);
  const long long sd = (long long)s * d, sn = (long long)s * n, s3 = 3 * sd;
  const long long nd = (long long)n * d, rows = (long long)batch * s, bnd = batch * nd;
  const size_t per_z = partial_floats(d);
  const int pw = plan.prod[kDW].pieces, pkv = plan.prod[kDKV].pieces;
  float* partials = scratch;
  float* g = partials + (size_t)pw * batch * per_z;
  float* dh = g + rows * d;
  float* x = dh + rows * d;
  float* dx = x + rows * d;
  float* gi = dx + rows * d;
  float* gh = gi + rows * 3 * d;
  float* dots = gh + rows * 3 * d;
  float* attn = dots + rows * n;
  float* p = attn + rows * n;
  float* rs = p + rows * n;
  float* rg = rs + rows;
  float* q = rg + rows;
  // dv's and dk's pieces, where they are split or rounded to bf16 at the end
  float* kv = pkv > 1 || bf16 ? q + rows : nullptr;
  const float *k, *v, *w_ih, *w_hh, *b_ih, *b_hh;
  if constexpr (bf16) {
    // the residuals' f32 copies, after dv's and dk's pieces, from a 16-byte
    // boundary (the products' operands copy 16 bytes at a time where aligned)
    const int dd = 3 * d * d;
    const size_t at = (size_t)(kv + 2 * (long long)pkv * bnd - scratch);
    float* f = scratch + ((at + 3) & ~(size_t)3);
    k = f;
    v = k + bnd;
    w_ih = v + bnd;
    w_hh = w_ih + dd;
    b_ih = w_hh + dd;
    b_hh = b_ih + 3 * d;
    const __nv_bfloat16* src[6] = {k_in, v_in, w_ih_in, w_hh_in, b_ih_in, b_hh_in};
    const long long sizes[6] = {bnd, bnd, dd, dd, 3LL * d, 3LL * d};
    launch_to_f32(src, sizes, 6, f, stream);
  } else {
    k = k_in;
    v = v_in;
    w_ih = w_ih_in;
    w_hh = w_hh_in;
    b_ih = b_ih_in;
    b_hh = b_hh_in;
  }
  if (iters == 1) {
    XSLOT_TRY((int)cudaMemsetAsync(partials, 0, (size_t)pw * batch * per_z * sizeof(float),
                                   stream));
  }

  const View none{nullptr, 0, 0, 0};
  const Renorm no_renorm{nullptr, nullptr, nullptr, nullptr, nullptr};
  const Renorm renorm{attn, dots, rs, rg, q};
  const int row_blocks = (int)((rows * 32 + kThreads - 1) / kThreads);
  const dim3 pass_grid(ceil_div(sn, (long long)kThreads * kBatch), batch);
  for (int it = iters - 1; it >= 0; --it) {
    const bool last = it == iters - 1;
    const View hv{hist + it * sd, iters * sd, d, 1};
    // rebuild the iteration's forward from hist[:, it]: dots (and rs), attn, x
    Prod dots_p = prod(hv, View{k, nd, 1, d}, dots, sn, n, scale);
    dots_p.rowout = rs;
    dots_p.rz = s;
    XSLOT_TRY(gemm(plan.prod[kDots], dots_p, nullptr, n, d, s, batch,
                   plan.fused ? kRowSum : kStore, no_renorm, stream));
    if (!plan.fused) row_sum_kernel<<<row_blocks, kThreads, 0, stream>>>(dots, rows, n, rs);
    attn_kernel<<<pass_grid, kThreads, 0, stream>>>(dots, rs, s, n, attn);
    XSLOT_TRY(gemm(plan.prod[kX], prod(View{attn, sn, n, 1}, View{v, nd, d, 1}, x, sd, d, 1.0f,
                                       div),
                   nullptr, d, n, s, batch, kStore, no_renorm, stream));
    const float* dupd = du;
    if (!last) {
      // the GRU's gates again over all B*S rows, and its backward for cotangent g
      Prod gi_p = prod(View{x, sd, d, 1}, View{w_ih, 0, 1, d}, gi, s3, 3 * d);
      Prod gh_p = prod(hv, View{w_hh, 0, 1, d}, gh, s3, 3 * d);
      gi_p.add = View{b_ih, 0, 0, 1};
      gh_p.add = View{b_hh, 0, 0, 1};
      XSLOT_TRY(gemm(plan.prod[kGates], gi_p, &gh_p, 3 * d, d, s, 1, kStore, no_renorm, stream));
      gru_bwd_kernel<<<blocks(rows * d), kThreads, 0, stream>>>(
          gi, gh, g, hist + it * sd, iters * sd, s, d, (int)(rows * d), dh);
      Prod dx_p = prod(View{gi, s3, 3 * d, 1}, View{w_ih, 0, d, 1}, dx, sd, d);
      Prod dh_p = prod(View{gh, s3, 3 * d, 1}, View{w_hh, 0, d, 1}, dh, sd, d);
      dh_p.accumulate = 1;
      XSLOT_TRY(gemm(plan.prod[kDGates], dx_p, &dh_p, d, 3 * d, s, 1, kStore, no_renorm, stream));
      // dW_ih, dW_hh and db into the (piece, element) partials
      const int first = it == iters - 2;
      Prod wi_p = prod(View{gi, s3, 1, 3 * d}, View{x, sd, d, 1}, partials, per_z, d);
      Prod wh_p = prod(View{gh, s3, 1, 3 * d}, hv, partials + 3 * d * d, per_z, d);
      wi_p.rowout = partials + 6 * d * d;
      wh_p.rowout = partials + 6 * d * d + 3 * d;
      for (Prod* w : {&wi_p, &wh_p}) {
        w->pc = (long long)batch * per_z;
        w->rz = per_z;
        w->accumulate = !first;
      }
      XSLOT_TRY(gemm(plan.prod[kDW], wi_p, &wh_p, d, s, 3 * d, batch, kSumA, no_renorm, stream));
      dupd = dx;
    }
    // attention: P = dattn_tot with the renorm's gradient, dD, dh, dv and dk
    Prod p_p = prod(View{dupd, sd, d, 1}, View{v, nd, 1, d}, p, sn, n, 1.0f, div);
    if (last) p_p.add = View{dattn, sn, n, 1};
    p_p.rz = s;
    XSLOT_TRY(gemm(plan.prod[kP], p_p, nullptr, n, d, s, batch, plan.fused ? kRenorm : kStore,
                   renorm, stream));
    if (!plan.fused) {
      renorm_grad_kernel<<<row_blocks, kThreads, 0, stream>>>(p, attn, dots, rs, rows, n, rg, q);
    }
    ddots_kernel<<<pass_grid, kThreads, 0, stream>>>(p, rs, rg, q, s, n, scale);
    Prod dh_att = prod(View{p, sn, n, 1}, View{k, nd, d, 1}, dh, sd, d);
    dh_att.accumulate = !last;
    XSLOT_TRY(gemm(plan.prod[kDH], dh_att, nullptr, d, n, s, batch, kStore, no_renorm, stream));
    // (f32 outputs only where kv is null)
    Prod dv_p = prod(View{attn, sn, 1, n}, View{dupd, sd, d, 1},
                     kv ? kv : reinterpret_cast<float*>(dv), nd, d, 1.0f, div);
    Prod dk_p = prod(View{p, sn, 1, n}, hv, kv ? kv + pkv * bnd : reinterpret_cast<float*>(dk),
                     nd, d);
    for (Prod* w : {&dv_p, &dk_p}) {
      w->pc = bnd;
      w->accumulate = !last;
    }
    XSLOT_TRY(gemm(plan.prod[kDKV], dv_p, &dk_p, d, s, n, batch, kStore, no_renorm, stream));
    float* t = g;
    g = dh;
    dh = t;
  }
  const long long sums = (long long)per_z + sd + (kv ? 2 * bnd : 0);
  tiled_sum_kernel<T><<<blocks(sums), kThreads, 0, stream>>>(
      partials, pw * batch, g, batch, (int)sd, d, dw_ih, dw_hh, db_ih, db_hh, d_init, kv, pkv,
      bnd, dv, dk);
  return (int)cudaGetLastError();
}

// The cluster route on `stream`: the gradient kernel (`cluster` CTAs per
// batch element) for residuals and gradients of type T, then the
// fixed-order sum.
template <typename T>
int cluster_bwd(const void* k, const void* v, const void* w_ih, const void* w_hh,
                const void* b_ih, const void* b_hh, const void* hist, const void* du,
                const void* dattn, void* dk, void* dv, void* d_init, void* dw_ih, void* dw_hh,
                void* db_ih, void* db_hh, void* scratch, int batch, int n, int s, int d,
                int iters, float scale, float div, int cluster, void* stream) {
  const auto fn = bwd_kernel<T>(n, d);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;  // the plan takes the tiled route
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(
      attr, batch, cluster, bwd_smem_bytes(n, share_max(s, cluster), d), stream);
  const int nparts = (int)cluster_parts(batch, cluster, iters);
  float* partials = (float*)scratch;
  float* dslots0 = partials + (size_t)nparts * partial_floats(d);
  int err = ensure_smem((const void*)fn, config.dynamicSmemBytes);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&config, fn, (const T*)k, (const T*)v, (const T*)w_ih,
                                (const T*)w_hh, (const T*)b_ih, (const T*)b_hh,
                                (const float*)hist, (const float*)du, (const float*)dattn,
                                (T*)dk, (T*)dv, partials, dslots0, n, s, d, iters, scale, div);
  if (err != 0) return err;
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int total = (int)partial_floats(d) + s * d;
  cluster_sum_kernel<T><<<(total + 31) / 32, kThreads, 0, (cudaStream_t)stream>>>(
      partials, nparts, dslots0, batch, s * d, d, (T*)dw_ih, (T*)dw_hh, (T*)db_ih, (T*)db_hh,
      (T*)d_init);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA owning `s_cta` slots, in bytes (the same
// for f32 and bf16 residuals: both are staged in f32).
size_t xslot_bwd_smem_bytes(int n, int s_cta, int d) {
  return bwd_smem_bytes(n, s_cta, d);
}

// How many clusters of `cluster` CTAs owning `s_cta` slots each the current
// device holds at once (cudaOccupancyMaxActiveClusters) for the instance of
// f32 (bf16 == 0) or bf16 residuals, or a negative CUDA error.
int xslot_bwd_max_clusters(int n, int s_cta, int d, int bf16, int cluster) {
  const void* fn = bf16 ? (const void*)bwd_kernel<__nv_bfloat16>(n, d)
                        : (const void*)bwd_kernel<float>(n, d);
  if (fn == nullptr) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(attr, 1, cluster, bwd_smem_bytes(n, s_cta, d), nullptr);
  return max_active_clusters(fn, &config);
}

// Floats of the scratch buffer xslot_bwd needs: for a cluster of `cluster`
// CTAs per element the partials of each CTA and GRU iteration (iters - 1 of
// them), then the elements' d_slots0 rows; for the tiled route (cluster ==
// 0) its plan's on the current device, for f32 or bf16 residuals (0 if the
// device cannot be read, where the route itself fails).
size_t xslot_bwd_scratch_floats(int batch, int n, int s, int d, int iters, int cluster,
                                int bf16) {
  if (cluster == 0) {
    int sms = 0;
    return device_sms(&sms) == 0 ? tiled_plan(batch, n, s, d, sms, bf16 != 0).scratch : 0;
  }
  return cluster_parts(batch, cluster, iters) * partial_floats(d) + (size_t)batch * s * d;
}

// The tiled route's plan at (batch, N, S, d) on the current device: for each
// product (dots, x, gi|gh, dx|dh, dW_ih|dW_hh, P, dh, dv|dk) its rows, CTA
// tile width and inner pieces at out[3p], out[3p+1], out[3p+2]; returns 0 or
// a negative CUDA error.
int xslot_tiled_plan(int batch, int n, int s, int d, int* out) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return -err;
  const TiledPlan t = tiled_plan(batch, n, s, d, sms, false);
  for (int i = 0; i < kProducts; ++i) {
    out[3 * i] = t.prod[i].rows;
    out[3 * i + 1] = t.prod[i].bn;
    out[3 * i + 2] = t.prod[i].pieces;
  }
  return 0;
}

// Launches the gradient kernel (`cluster` CTAs per batch element) and the
// fixed-order sum on `stream`, or with cluster == 0 the tiled route; returns
// 0 or the error. Pointers are contiguous device arrays: k, v (B,N,d);
// w_ih, w_hh (3d,d); b_ih, b_hh (3d), all f32 (bf16 == 0) or all bf16
// (bf16 == 1); hist (B,iters,S,d), du (B,S,d) and dattn (B,S,N), f32;
// outputs dk, dv (B,N,d), d_init (S,d), dw_ih, dw_hh (3d,d), db_ih, db_hh
// (3d) in the residuals' type; scratch of xslot_bwd_scratch_floats floats.
// `div` is the update's divisor (the true slot width, where the wrapper
// zero-padded d to a multiple of 4; `scale` is its d^-1/2).
int xslot_bwd(const void* k, const void* v, const void* w_ih, const void* w_hh,
              const void* b_ih, const void* b_hh, const void* hist, const void* du,
              const void* dattn, void* dk, void* dv, void* d_init, void* dw_ih, void* dw_hh,
              void* db_ih, void* db_hh, void* scratch, int batch, int n, int s, int d, int iters,
              float scale, float div, int bf16, int cluster, void* stream) {
  using bf = __nv_bfloat16;
  if (cluster == 0 && bf16) {
    return tiled_bwd((const bf*)k, (const bf*)v, (const bf*)w_ih, (const bf*)w_hh,
                     (const bf*)b_ih, (const bf*)b_hh, (const float*)hist, (const float*)du,
                     (const float*)dattn, (bf*)dk, (bf*)dv, (bf*)d_init, (bf*)dw_ih,
                     (bf*)dw_hh, (bf*)db_ih, (bf*)db_hh, (float*)scratch, batch, n, s, d, iters,
                     scale, div, (cudaStream_t)stream);
  }
  if (cluster == 0) {
    return tiled_bwd((const float*)k, (const float*)v, (const float*)w_ih, (const float*)w_hh,
                     (const float*)b_ih, (const float*)b_hh, (const float*)hist,
                     (const float*)du, (const float*)dattn, (float*)dk, (float*)dv,
                     (float*)d_init, (float*)dw_ih, (float*)dw_hh, (float*)db_ih,
                     (float*)db_hh, (float*)scratch, batch, n, s, d, iters, scale, div,
                     (cudaStream_t)stream);
  }
  return (bf16 ? cluster_bwd<bf> : cluster_bwd<float>)(
      k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn, dk, dv, d_init, dw_ih, dw_hh, db_ih, db_hh,
      scratch, batch, n, s, d, iters, scale, div, cluster, stream);
}

#ifdef XSLOT_STAMPS
// Copies `count` of g_stamps to `out` (kStampCtas x kStampSlots) and zeroes
// them; returns 0 or the CUDA error.
int xslot_bwd_stamps(long long* out, int count) {
  void* addr = nullptr;
  XSLOT_TRY((int)cudaMemcpyFromSymbol(out, g_stamps, (size_t)count * sizeof(long long)));
  XSLOT_TRY((int)cudaGetSymbolAddress(&addr, g_stamps));
  return (int)cudaMemset(addr, 0, sizeof(g_stamps));
}

// The fixed-order sum of an f32 cluster call's scratch alone (xslot_bwd's
// second launch), on `stream`.
int xslot_bwd_sum_only(const void* scratch, int batch, int s, int d, int iters, int cluster,
                       void* d_init, void* dw_ih, void* dw_hh, void* db_ih, void* db_hh,
                       void* stream) {
  const int nparts = (int)cluster_parts(batch, cluster, iters);
  const float* partials = (const float*)scratch;
  const int total = (int)partial_floats(d) + s * d;
  cluster_sum_kernel<float><<<(total + 31) / 32, kThreads, 0, (cudaStream_t)stream>>>(
      partials, nparts, partials + (size_t)nparts * partial_floats(d), batch, s * d, d,
      (float*)dw_ih, (float*)dw_hh, (float*)db_ih, (float*)db_hh, (float*)d_init);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
