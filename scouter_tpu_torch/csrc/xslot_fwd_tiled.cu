// Forward of the fused xSlot loop past a cluster's reach, for Hopper
// (sm_90a): one launch a call, f32 arithmetic, inputs in f32 or bf16
// (converted on load, exactly), outputs in f32.
//
// Replaces the Pallas TPU kernel scouter_tpu/ops/slot_pallas.py::_fused_forward
// (pallas_call :107, body _kernel :42-81) at the shapes where xslot_fwd.cu's
// cluster kernel cannot run: each of its CTAs keeps all of k and v and a
// share of the slots in shared memory, so no cluster of 8 holds an element
// at N=784 (output stride 8 at 224 px, S=30), at N=196 with S=1000 (the CUB
// recipe at 448 px) or past d=1024. The wrapper (ops/slot_kernel.py::_plan)
// takes this route only there, by shape; it never stands in for a cluster
// launch that failed.
//
// It computes what xslot_fwd.cu computes, in _kernel's order: for each
// iteration
//     dots  = slots . k^T * d^-1/2
//     attn  = sigmoid(dots / rowsum(dots) * sum(dots))   (no epsilon)
//     upd   = attn . v / d
//     slots = GRU(upd, slots)                             (skipped at the last)
// and writes the last iteration's upd (B,S,d) and attn (B,S,N), and with a
// non-null hist the slots entering each iteration (B,iters,S,d), its first
// row included. `div` is the true slot width where the wrapper zero-padded d
// to a multiple of 4 (`scale` is its d^-1/2); the padded columns stay zero.
//
// What bounds it: per element 3 x two (S,N,d) products and 2 x two
// (S,d)x(d,3d) products, all f32: 1.47 GFLOP at (70, 784, 30), 0.022 ms at
// the card's f32 rate; 0.34 GFLOP at (16, 784, 30), 0.005 ms; 3.98 GFLOP at
// (16, 196, 1000), 0.059 ms. k and v (28 MB at (70, 784, 30)) take 0.008 ms
// to read. The chain of launches it replaces (16-18 a call, every
// intermediate through device memory) took 0.25-0.36 ms on an H100. Within
// a CTA the products are bound by shared memory's delivery to registers (a
// 4 x 4 outer product reads 8 floats for 16 FMAs; the SM moves 32 floats a
// cycle and does 128 FMAs), so a CTA runs at 40-55 FMAs a cycle; what the
// design can still win is in how many CTAs work at once.
// What the design does about it:
// - One cluster of c = cs x cn CTAs (up to 16, non-portable past 8) per
//   element. CTA (gs, gn) owns slot group gs (S/cs slots, all of them where
//   cs = 1) and position share gn (N/cn positions). Its share of k and v is
//   loaded into shared memory once and kept across the iterations, and its
//   dots stay there between the two passes of an iteration; nothing but upd,
//   the last attn and hist reaches device memory. Where no cluster holds the
//   shares, k and v stream through a two-stage cp.async ring of `tn`
//   positions and the dots are recomputed in the second pass; where even a
//   cluster of 16 cannot hold its slot buffers (S in the thousands, or d past
//   ~1000 with many slots), those buffers live in device scratch instead
//   (`spill`), read by the same code through generic pointers.
// - Cross-CTA sums go through distributed shared memory in rank order, the
//   same bits on every CTA and every call: each slot row's sum over the
//   position shares and the element's total, in f64, once an iteration (row
//   sums double-buffered by iteration parity); the update's partial products
//   over the position shares, in f32.
// - The GRU is split over a slot group's cn CTAs by output columns: each
//   reads its 6 x d/cn rows of W_ih and W_hh from L2 (not all of them, as a
//   split by slot rows would) for all of the group's slots, and the next
//   slots are gathered column by column from their owners' shared memory.
//   Consecutive threads take consecutive slots of one column, so a weight
//   load is one address a warp.
// - The dots take four slots x one position a thread, the update two slots x
//   four columns (xslot_common.cuh); rows are padded to d+4 floats.
// - f32 FMAs only: no tensor cores, no TF32, no float atomics.
// - A grid where clusters would take waves: a cluster lies within one GPC,
//   so on an H100 clusters of 10 to 16 CTAs fit only 7 at once, and at
//   (16, 196, 1000) the 16 CTAs an element of a cluster launch took 3 waves
//   (0.43 ms). Where the slots are split only (cn = 1) the groups of an
//   element share nothing but each iteration's group totals, so a grid
//   launch (`grid`: cooperative, no clusters) puts all B x cs CTAs on the
//   card at once (8 slot groups an element there, k and v streamed: one
//   wave, 0.26 ms) and exchanges the totals through the scratch and a grid
//   barrier, added in the same group order: the bits of the cluster launch
//   of that split.
// A plan (ops/slot_kernel.py::split_fwd_plan) picks cs, cn and the mode
// from the card's occupancy of each cluster shape and of a grid.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include "xslot_common.cuh"

using namespace xslot;

namespace {

// 512 threads a CTA, one CTA an SM: the phases are short and latency-bound,
// so every warp that can hide a load's latency counts
constexpr int kBlock = 512, kWarps = kBlock / 32;

// How a launch splits an element: cs slot groups x cn position shares,
// walked in tiles of tn positions; k and v resident (a whole share) or
// streamed (a ring of two tiles); where the slot buffers live.
struct Geometry {
  int cs, cn, tn, streamed, spill, grid;
};

__host__ __device__ inline int slot_rows(int s, int cs) { return round4(share_max(s, cs)); }

// Columns of W_ih and W_hh a GRU chunk stages: 8 where d is small, fewer
// (at least 1) so that a chunk stays near 13 KB.
__host__ __device__ inline int gru_chunk(int d) {
  const int c = 3264 / (6 * row_ld(d));
  return c < 1 ? 1 : (c > 8 ? 8 : c);
}

// the slot buffers of one CTA, slp rows of d + 4 each: slots, the update's
// partial sums, the summed update (the partial sums themselves where cn ==
// 1), the next slots, and the slots transposed (d rows of slp)
__host__ __device__ inline size_t region_floats(int s, int d, const Geometry& g) {
  return (size_t)(g.cn > 1 ? 5 : 4) * slot_rows(s, g.cs) * row_ld(d);
}

// the row sums of two iterations, the block sum's scratch, the group's
// total of two iterations, k's column sums (by stripe, then summed), this
// iteration's row sums (f32) and the GRU's biases b_ih, b_hh; f64 first
__host__ __device__ inline size_t header_floats(int slp, int d) {
  return 5 * (size_t)slp + 2 * kWarps + 4 + 2 * (size_t)(d > kBlock ? d : kBlock) +
         2 * (size_t)d + 6 * (size_t)d;
}

// k transposed: a share's positions (resident) or a tile's, rounded up to 4
__host__ __device__ inline int k_cols(int n, const Geometry& g) {
  return round4(g.streamed ? g.tn : share_max(n, g.cn));
}

// One CTA's dynamic shared memory in floats: the header, the slot buffers
// (unless they spill), k transposed and v (a share, or two ring stages of
// tn positions each), the dots of a tile (tn rows of slp + 4) and the GRU's
// two weight chunks.
__host__ __device__ inline size_t smem_floats(int n, int s, int d, const Geometry& g) {
  const size_t slp = slot_rows(s, g.cs), stages = g.streamed ? 2 : 1;
  const size_t vrows = g.streamed ? 2 * (size_t)g.tn : share_max(n, g.cn);
  return header_floats((int)slp, d) + (g.spill ? 0 : region_floats(s, d, g)) +
         stages * d * k_cols(n, g) + vrows * row_ld(d) + (size_t)g.tn * (slp + 4) +
         12 * (size_t)gru_chunk(d) * row_ld(d);
}

// The rank of the share that holds item i when `total` items go to `parts`
// shares [r*total/parts, (r+1)*total/parts) (slot_range's split).
__device__ __forceinline__ int owner_of(int i, int total, int parts) {
  return (int)(((long long)(i + 1) * parts + total - 1) / total) - 1;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The same slot buffer of the element's CTA `r`: through distributed shared
// memory, or in the scratch (regions `region` floats apart in rank order)
// where the buffers spill; a spilled peer's floats are read past L1.
struct Peer {
  cg::cluster_group& cluster;
  int rank, spill;
  size_t region;
  __device__ const float* at(float* p, int r) const {
    if (r == rank) return p;
    return spill ? p + ((long long)r - rank) * (long long)region : cluster.map_shared_rank(p, r);
  }
  __device__ float4 load4(const float* p) const {
    return spill ? __ldcg(reinterpret_cast<const float4*>(p)) : *reinterpret_cast<const float4*>(p);
  }
};

// The sum of every thread's v, in a fixed order (lanes by a butterfly, then
// the warps in order); every thread gets the same bits.
__device__ inline double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// out[c] = the sum over rows i < rows of src[i * stride + c], c < d, in
// f64 and a fixed order: stripes of rows (thread t takes column t % d of
// stripe t / d), then the stripes in order; `part` holds max(kBlock, d)
// doubles.
template <typename T>
__device__ inline void column_sums(double* out, double* part, const T* src, size_t stride,
                                   int rows, int d) {
  const int stripes = max(1, (int)blockDim.x / d);
  for (int t = threadIdx.x; t < stripes * d; t += blockDim.x) {
    const int cc = t % d, st = t / d;
    double a = 0.0;
#pragma unroll 4
    for (int i = st; i < rows; i += stripes) a += (double)to_f32(src[(size_t)i * stride + cc]);
    part[t] = a;
  }
  __syncthreads();
  for (int cc = threadIdx.x; cc < d; cc += blockDim.x) {
    double a = 0.0;
    for (int st = 0; st < stripes; ++st) a += part[st * d + cc];
    out[cc] = a;
  }
}

// rowacc[r] = scale * (slots[r] . ksum) in f64 for r < sl, one warp a row:
// the sum of row r of the dots over all N positions, from k's column sums,
// without the rounding of each dot.
__device__ inline void slot_row_sums(double* rowacc, const float* slots, int ld,
                                     const double* ksum, int sl, int d, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < sl; r += kWarps) {
    double a = 0.0;
    for (int cc = lane; cc < d; cc += 32) a += (double)slots[(size_t)r * ld + cc] * ksum[cc];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) rowacc[r] = a * (double)scale;
  }
}

// dst[c][i] = src[i][c] for i < rows, c < d: rows of d values (f32 or
// bf16, converted) into d rows of stride ldt; consecutive threads take
// consecutive i of one column quad.
template <typename T>
__device__ inline void load_transposed(float* dst, int ldt, const T* __restrict__ src, int rows,
                                       int d) {
  for (int e = threadIdx.x; e < rows * (d >> 2); e += blockDim.x) {
    const int c = 4 * (e / rows), i = e - (c >> 2) * rows;
    const float4 f = load4(src + (size_t)i * d + c);
    dst[(size_t)c * ldt + i] = f.x;
    dst[(size_t)(c + 1) * ldt + i] = f.y;
    dst[(size_t)(c + 2) * ldt + i] = f.z;
    dst[(size_t)(c + 3) * ldt + i] = f.w;
  }
}

// dT[p][s] = (slots[s] . k[p]) * scale for s < sl, p < rows: slotsT (d rows
// of slp) and kT (d rows of kcols) hold slots and k transposed, dT has rows
// of dld. A thread takes 4 slots x 4 positions, an outer product of two
// float4 an inner term, adding over d in order; consecutive threads take
// consecutive positions. Slots past sl are zero, so their dots are too;
// kT's columns past the share are zero or a past tile's. (Four warps of
// 4 x 8 tiles ran slower than eight of 4 x 4 on the H100: more warps hide
// more of shared memory's latency.)
__device__ inline void tile_dots(float* dT, int dld, const float* slotsT, int slp,
                                 const float* kT, int kcols, int sl, int rows, int d,
                                 float scale) {
  const int sb = (sl + 3) >> 2, pb = (rows + 3) >> 2;
  for (int task = threadIdx.x; task < sb * pb; task += blockDim.x) {
    const int si = task / pb, pi = task - si * pb;
    const float* a = slotsT + 4 * si;
    const float* b = kT + 4 * pi;
    float acc[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[e][f] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(a + (size_t)c * slp);
      const float4 bv = *reinterpret_cast<const float4*>(b + (size_t)c * kcols);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(comp(av, e), comp(bv, f), acc[e][f]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int p = 4 * pi + f;
      if (p < rows) {
        *reinterpret_cast<float4*>(dT + (size_t)p * dld + 4 * si) =
            make_float4(acc[0][f] * scale, acc[1][f] * scale, acc[2][f] * scale,
                        acc[3][f] * scale);
      }
    }
  }
}

// acc[s][4q + f] (+)= sum_{p < rows} aT[p][s] v[p][4q + f] for s < sl, q <
// d/4: aT with rows of dld, v and acc with rows of ld. A thread takes 4 slots
// x 4 columns, an outer product of two float4 a position, adding the
// positions in order; consecutive threads take consecutive column quads.
__device__ inline void tile_update(float* acc, int ld, const float* aT, int dld,
                                   const float* v, int sl, int rows, int d, bool accumulate) {
  const int sb = (sl + 3) >> 2, nq = d >> 2;
  for (int task = threadIdx.x; task < sb * nq; task += blockDim.x) {
    const int si = task / nq, q = task - si * nq;
    const float* a = aT + 4 * si;
    const float* b = v + 4 * q;
    float u[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) u[e][f] = 0.0f;
#pragma unroll 4
    for (int p = 0; p < rows; ++p) {
      const float4 av = *reinterpret_cast<const float4*>(a + (size_t)p * dld);
      const float4 bv = *reinterpret_cast<const float4*>(b + (size_t)p * ld);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) u[e][f] = fmaf(comp(av, e), comp(bv, f), u[e][f]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * si + e >= sl) break;
      float4* o = reinterpret_cast<float4*>(acc + (size_t)(4 * si + e) * ld + 4 * q);
      const float4 w = make_float4(u[e][0], u[e][1], u[e][2], u[e][3]);
      *o = accumulate ? add4(*o, w) : w;
    }
  }
}

// Ring stage t & 1: positions [t*tn, t*tn + tn) of the share (nl positions
// of d values at kb, vb), k transposed into d rows of kcols, v as rows of
// ld; the caller commits v's copies.
template <typename T>
__device__ inline void stage(float* kT, int kcols, float* vs, int ld, int tn,
                             const T* __restrict__ kb, const T* __restrict__ vb, int t, int nl,
                             int d) {
  const int p = t * tn, rows = min(tn, nl - p);
  load_transposed(kT + (size_t)(t & 1) * d * kcols, kcols, kb + (size_t)p * d, rows, d);
  load_rows(vs + (size_t)(t & 1) * tn * ld, ld, vb + (size_t)p * d, rows, d);
}

#ifdef XSLOT_STAMPS
// Phase stamps for examples/torch_k1_bench.py --stamps: after a CTA
// barrier, thread 0 of each of the first kStampCtas CTAs writes clock64() to
// its slot i (0: start, 1: loaded, 2: k's column sums; then per iteration
// from 3 + 8 it: row sums and total, the first tile's dots, attention and
// update, all tiles, the summed update, the GRU, the exchange).
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

// Chunk `t` of the columns [j0, j0 + dc): rows g*d + j of W_ih and W_hh (g
// = r, z, n; j in the chunk) into buffer t & 1 of `w`, W_ih's gate g at row
// g*jc + (j - jt) and W_hh's at (3 + g)*jc + ..., row stride ld; the caller
// commits.
template <typename T>
__device__ inline void stage_gru(float* w, int ld, int jc, const T* __restrict__ w_ih,
                                 const T* __restrict__ w_hh, int j0, int dc, int t, int d) {
  const int jt = j0 + t * jc, cols = min(jc, j0 + dc - jt), q4 = d >> 2;
  float* buf = w + (size_t)(t & 1) * 6 * jc * ld;
  for (int i = threadIdx.x; i < 6 * cols * q4; i += blockDim.x) {
    const int row = i / q4, c = 4 * (i - row * q4), m = row / (3 * cols);
    const int g = (row - m * 3 * cols) / cols, j = jt + row - m * 3 * cols - g * cols;
    copy4(buf + (size_t)((3 * m + g) * jc + j - jt) * ld + c,
          (m ? w_hh : w_ih) + (size_t)(g * d + j) * d + c);
  }
}

// next[r][j] = GRU(x[r], h[r])[j] for the rows r < sl and the columns j0 <=
// j < j0 + dc, torch gate order r, z, n, with xslot_fwd.cu's formula and
// order. x, h, next have row stride ld. The weights' rows for the columns
// go through `w` (wfloats of shared memory: the dots' tile and the GRU's own
// room, both free here) in as few equal chunks as fit. A thread takes one
// column and four rows: its six weight rows are read once a step for all
// four, and consecutive threads take consecutive columns (weight rows d + 4
// floats apart: distinct banks; the rows' reads are one address a warp).
template <typename T>
__device__ inline void gru_columns(float* next, const float* x, const float* h, int ld, int sl,
                                   int j0, int dc, float* w, int wfloats,
                                   const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                                   const float* bias, int d, int stamp) {
  if (dc <= 0) return;
  const int most = max(1, wfloats / (6 * ld)), chunks = (dc + most - 1) / most;
  const int jc = (dc + chunks - 1) / chunks, groups = (sl + 3) >> 2;
  for (int jt = j0, t = 0; jt < j0 + dc; jt += jc, ++t) {
    const int cols = min(jc, j0 + dc - jt);
    stage_gru(w, ld, cols, w_ih, w_hh, jt, cols, 0, d);
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    if (stamp >= 0 && t < 2) XSLOT_STAMP(stamp + 2 * t);
    for (int task = threadIdx.x; task < groups * cols; task += blockDim.x) {
      const int rg = task / cols, jj = task - rg * cols, r0 = 4 * rg, j = jt + jj;
      const float* wr = w + (size_t)jj * ld;
      const size_t gate = (size_t)cols * ld;
      float a[4][6];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 6; ++m) a[i][m] = 0.0f;
      const float* xr[4];
      const float* hr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = min(r0 + i, sl - 1);  // rows past sl: discarded
        xr[i] = x + (size_t)r * ld;
        hr[i] = h + (size_t)r * ld;
      }
      for (int c = 0; c < d; c += 4) {
        float4 wv[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) wv[m] = *reinterpret_cast<const float4*>(wr + m * gate + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(xr[i] + c);
          const float4 hv = *reinterpret_cast<const float4*>(hr[i] + c);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            a[i][g] = dot4(xv, wv[g], a[i][g]);
            a[i][3 + g] = dot4(hv, wv[3 + g], a[i][3 + g]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
        if (r >= sl) break;
        const float ir = a[i][0] + bias[j];
        const float iz = a[i][1] + bias[d + j];
        const float in = a[i][2] + bias[2 * d + j];
        const float hr_ = a[i][3] + bias[3 * d + j];
        const float hz = a[i][4] + bias[4 * d + j];
        const float hn = a[i][5] + bias[5 * d + j];
        const float rg_ = sigmoid_f32(ir + hr_);
        const float zg = sigmoid_f32(iz + hz);
        const float ng = tanhf(in + rg_ * hn);
        next[(size_t)r * ld + j] = (1.0f - zg) * ng + zg * h[(size_t)r * ld + j];
      }
    }
    __syncthreads();
    if (stamp >= 0 && t < 2) XSLOT_STAMP(stamp + 2 * t + 1);
  }
}

// kSpill: the slot buffers in scratch; a separate instance, so that where
// they are in shared memory the compiler knows it (shared-memory loads, not
// generic ones).
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kBlock, 1)
xslot_fwd_tiled_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ slots0, const T* __restrict__ w_ih,
                       const T* __restrict__ w_hh, const T* __restrict__ b_ih,
                       const T* __restrict__ b_hh, float* __restrict__ upd_out,
                       float* __restrict__ attn_out, float* __restrict__ hist_out,
                       float* __restrict__ scratch, int n, int s, int d, int iters, float scale,
                       float div, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = g.cs * g.cn;
  const int rank = g.grid ? (int)(blockIdx.x % c) : (int)cluster.block_rank();
  const int gs = rank / g.cn, gn = rank - gs * g.cn, first = gs * g.cn;
  const size_t b = blockIdx.x / c;
  int s0, sl, p0, nl, q0, nq;
  slot_range(s, g.cs, gs, &s0, &sl);
  slot_range(n, g.cn, gn, &p0, &nl);
  const int q4 = d >> 2;
  slot_range(q4, g.cn, gn, &q0, &nq);  // the GRU's, hist's and upd's columns
  const int j0 = 4 * q0, dc = 4 * nq;
  const int slp = slot_rows(s, g.cs), ld = row_ld(d), tn = g.tn;
  const size_t region = region_floats(s, d, g), sz = (size_t)slp * ld;
  const Peer peer{cluster, rank, kSpill, region};

  double* rowacc2 = reinterpret_cast<double*>(smem);  // 2 x slp, by iteration parity
  double* red = rowacc2 + 2 * slp;
  double* gtot2 = red + kWarps;  // the group's total of two iterations
  double* part = gtot2 + 2;
  double* ksum = part + (d > kBlock ? d : kBlock);
  float* rs = reinterpret_cast<float*>(ksum + d);
  float* bias = rs + slp;  // b_ih, then b_hh
  float* const base = smem + header_floats(slp, d);
  float* slots = kSpill ? scratch + blockIdx.x * region : base;
  float* acc = slots + sz;
  float* x = g.cn > 1 ? acc + sz : acc;
  float* next = x + sz;
  float* slotsT = next + sz;  // d rows of slp
  const int kcols = k_cols(n, g), dld = slp + 4;
  float* kT = base + (kSpill ? 0 : region);  // d rows of kcols, a stage or the share
  float* vs = kT + (size_t)(g.streamed ? 2 : 1) * d * kcols;
  float* dT = vs + (size_t)(g.streamed ? 2 * tn : share_max(n, g.cn)) * ld;  // tn rows of dld
  const T* kb = k + (b * n + p0) * (size_t)d;
  const T* vb = v + (b * n + p0) * (size_t)d;
  XSLOT_STAMP(0);

  zero(slots, region);
  zero(kT, (size_t)(g.streamed ? 2 : 1) * d * kcols);
  zero(dT, (size_t)tn * dld);
  __syncthreads();
  if (!g.streamed) load_rows(vs, ld, vb, nl, d);
  copy_commit();
  if (!g.streamed) load_transposed(kT, kcols, kb, nl, d);
  for (int i = threadIdx.x; i < 6 * d; i += blockDim.x) {
    bias[i] = to_f32(i < 3 * d ? b_ih[i] : b_hh[i - 3 * d]);
  }
  for (int i = threadIdx.x; i < sl * q4; i += blockDim.x) {
    const int q = i / sl, r = i - q * sl;  // consecutive threads: consecutive slots
    const float4 f = load4(slots0 + (size_t)(s0 + r) * d + 4 * q);
    *reinterpret_cast<float4*>(slots + (size_t)r * ld + 4 * q) = f;
    slotsT[(size_t)(4 * q) * slp + r] = f.x;
    slotsT[(size_t)(4 * q + 1) * slp + r] = f.y;
    slotsT[(size_t)(4 * q + 2) * slp + r] = f.z;
    slotsT[(size_t)(4 * q + 3) * slp + r] = f.w;
  }
  copy_wait<0>();
  __syncthreads();
  XSLOT_STAMP(1);
  // k's column sums over the element's positions, in f64: this CTA's
  // share, then the position shares' in rank order
  double* kpart = ksum;  // this share's, until the cluster has read them
  column_sums(kpart, part, kb, (size_t)d, nl, d);
  if (g.cn > 1) {
    element_sync(cluster);
    for (int cc = threadIdx.x; cc < d; cc += blockDim.x) {
      double a = 0.0;
      for (int q = 0; q < g.cn; ++q) a += cluster.map_shared_rank(kpart, first + q)[cc];
      part[cc] = a;
    }
    element_sync(cluster);  // every peer has read kpart
    for (int cc = threadIdx.x; cc < d; cc += blockDim.x) ksum[cc] = part[cc];
  }
  __syncthreads();
  XSLOT_STAMP(2);

  const int tiles = (nl + tn - 1) / tn;
  for (int it = 0; it < iters; ++it) {
    const bool last = it + 1 == iters;
    if (hist_out != nullptr) {
      float* out = hist_out + ((b * iters + it) * s + s0) * (size_t)d + j0;
      for (int i = threadIdx.x; i < sl * dc; i += blockDim.x) {
        const int r = i / dc, j = i - r * dc;
        out[(size_t)r * d + j] = slots[(size_t)r * ld + j0 + j];
      }
    }

    // the row sums of the group's slots, and the element's total from every
    // group's, in f64 and slot order
    double* rowacc = rowacc2 + (it & 1) * slp;
    slot_row_sums(rowacc, slots, ld, ksum, sl, d, scale);
    __syncthreads();
    double mine = 0.0;
    for (int r = threadIdx.x; r < slp; r += blockDim.x) {
      if (r < sl) mine += rowacc[r];
      rs[r] = r < sl ? (float)rowacc[r] : 1.0f;
    }
    const double gsum = block_sum(mine, red);  // its barrier publishes rs
    double total_d = gsum;
    if (g.cs > 1) {
      // the element's groups' totals of two iterations: in shared memory
      // (read through the cluster), or in the scratch (grid)
      double* tot = g.grid ? reinterpret_cast<double*>(scratch) + 2 * b * g.cs : gtot2;
      if (threadIdx.x == 0) tot[g.grid ? 2 * gs + (it & 1) : (it & 1)] = gsum;
      if (g.grid) {
        cg::this_grid().sync();
      } else {
        element_sync(cluster);
      }
      if (threadIdx.x < 32) {  // group l's total in lane l, added by a butterfly
        double t = 0.0;
        if (threadIdx.x < g.cs) {
          t = g.grid ? __ldcg(tot + 2 * threadIdx.x + (it & 1))
                     : cluster.map_shared_rank(gtot2, threadIdx.x * g.cn)[it & 1];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (threadIdx.x == 0) red[0] = t;
      }
      __syncthreads();
      total_d = red[0];
    }
    const float total = (float)total_d;
    XSLOT_STAMP(3 + 8 * it);

    // the dots, attention (the last iteration's to attn_out) and the
    // update's partial sums over the CTA's positions, a tile at a time
    if (g.streamed) {
      stage(kT, kcols, vs, ld, tn, kb, vb, 0, nl, d);
      copy_commit();
    }
    for (int t = 0; t < tiles; ++t) {
      const int pt = t * tn, rows = min(tn, nl - pt);
      const float* kt = g.streamed ? kT + (size_t)(t & 1) * d * kcols : kT + pt;
      const float* vt = vs + (size_t)(g.streamed ? (t & 1) * tn : pt) * ld;
      if (g.streamed) {
        if (t + 1 < tiles) {
          stage(kT, kcols, vs, ld, tn, kb, vb, t + 1, nl, d);
          copy_commit();
          copy_wait<1>();
        } else {
          copy_wait<0>();
        }
        __syncthreads();
      }
      tile_dots(dT, dld, slotsT, slp, kt, kcols, sl, rows, d, scale);
      __syncthreads();
      if (t == 0) XSLOT_STAMP(4 + 8 * it);
      const int sb = (sl + 3) >> 2;
      for (int i = threadIdx.x; i < rows * sb; i += blockDim.x) {
        const int si = i / rows, pp = i - si * rows;  // consecutive threads: positions
        float4* e4 = reinterpret_cast<float4*>(dT + (size_t)pp * dld + 4 * si);
        const float4 dv = *e4, rv = *reinterpret_cast<const float4*>(rs + 4 * si);
        const float4 a = make_float4(sigmoid_f32(dv.x / rv.x * total),
                                     sigmoid_f32(dv.y / rv.y * total),
                                     sigmoid_f32(dv.z / rv.z * total),
                                     sigmoid_f32(dv.w / rv.w * total));
        *e4 = a;
        if (last) {
          float* out = attn_out + (b * s + s0 + 4 * si) * (size_t)n + p0 + pt + pp;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * si + e < sl) out[(size_t)e * n] = comp(a, e);
          }
        }
      }
      __syncthreads();
      if (t == 0) XSLOT_STAMP(5 + 8 * it);
      tile_update(acc, ld, dT, dld, vt, sl, rows, d, t > 0);
      __syncthreads();
      if (t == 0) XSLOT_STAMP(6 + 8 * it);
    }
    XSLOT_STAMP(7 + 8 * it);

    // the update: the group's partial sums in rank order, then / d
    if (g.cn > 1) element_sync(cluster);
    for (int i = threadIdx.x; i < sl * q4; i += blockDim.x) {
      const int r = i / q4;
      const size_t o = (size_t)r * ld + 4 * (i - r * q4);
      float4 u = peer.load4(peer.at(acc, first) + o);
      for (int q0 = 1; q0 < g.cn; q0 += 4) {  // four shares' loads in flight together
        float4 part4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q0 + q < g.cn) part4[q] = peer.load4(peer.at(acc, first + q0 + q) + o);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q0 + q < g.cn) u = add4(u, part4[q]);
        }
      }
      *reinterpret_cast<float4*>(x + o) = make_float4(u.x / div, u.y / div, u.z / div, u.w / div);
    }
    __syncthreads();
    XSLOT_STAMP(8 + 8 * it);
    if (last) {
      float* out = upd_out + (b * s + s0) * (size_t)d + j0;
      for (int i = threadIdx.x; i < sl * dc; i += blockDim.x) {
        const int r = i / dc, j = i - r * dc;
        out[(size_t)r * d + j] = x[(size_t)r * ld + j0 + j];
      }
      break;
    }

    // the GRU on the CTA's columns, then every column from its owner
    gru_columns(next, x, slots, ld, sl, j0, dc, dT, (int)((size_t)tn * dld + 12 * gru_chunk(d) * ld),
                w_ih, w_hh, bias, d, it == 0 ? 27 : -1);
    XSLOT_STAMP(9 + 8 * it);
    if (g.cn > 1) {
      element_sync(cluster);
    } else {
      __syncthreads();
    }
    for (int i = threadIdx.x; i < sl * q4; i += blockDim.x) {
      const int q = i / sl, r = i - q * sl;  // consecutive threads: consecutive slots
      const size_t o = (size_t)r * ld + 4 * q;
      const float4 f = peer.load4(peer.at(next, first + owner_of(q, q4, g.cn)) + o);
      *reinterpret_cast<float4*>(slots + o) = f;
      slotsT[(size_t)(4 * q) * slp + r] = f.x;
      slotsT[(size_t)(4 * q + 1) * slp + r] = f.y;
      slotsT[(size_t)(4 * q + 2) * slp + r] = f.z;
      slotsT[(size_t)(4 * q + 3) * slp + r] = f.w;
    }
    __syncthreads();
    XSLOT_STAMP(10 + 8 * it);
  }
  // a peer may still read this CTA's row sums or partial sums: leave together
  if (c > 1 && !g.grid) cluster.sync();
}

template <typename T>
const void* kernel_of(int spill) {
  return spill ? (const void*)xslot_fwd_tiled_kernel<T, true>
               : (const void*)xslot_fwd_tiled_kernel<T, false>;
}

// Clusters past the portable 8 need the function's leave, once per device.
inline int allow_large_clusters(const void* fn) {
  static std::mutex mutex;
  static struct {
    const void* fn;
    int device;
  } done[64];
  static int count = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < count; ++i) {
    if (done[i].fn == fn && done[i].device == device) return 0;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  if (count < 64) done[count++] = {fn, device};
  return 0;
}

// `batch` elements of `ctas` CTAs each with this kernel's kBlock threads a
// CTA: one cluster an element, or (grid) one cooperative launch of them all
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int batch, int ctas,
                                        int grid, size_t smem, void* stream) {
  cudaLaunchConfig_t config = cluster_config(attr, batch, ctas, smem, stream);
  config.blockDim = dim3(kBlock);
  if (grid) {
    attr->id = cudaLaunchAttributeCooperative;
    attr->val.cooperative = 1;
  }
  return config;
}

inline Geometry geometry(int cs, int cn, int tn, int streamed, int spill, int grid) {
  return Geometry{cs, cn, tn, streamed != 0, spill != 0, grid != 0};
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes, for cs slot groups x cn
// position shares, tiles of tn positions, k and v resident (streamed == 0)
// or in a ring of two tiles, the slot buffers in shared memory (spill == 0)
// or in scratch.
size_t xslot_fwd_tiled_smem_bytes(int n, int s, int d, int cs, int cn, int tn, int streamed,
                                  int spill) {
  return smem_floats(n, s, d, geometry(cs, cn, tn, streamed, spill, 0)) * sizeof(float);
}

// Floats of the scratch the launch needs: every CTA's slot buffers where
// they spill; on a grid, each CTA's group total of two iterations (f64);
// else 0.
size_t xslot_fwd_tiled_scratch_floats(int batch, int s, int d, int cs, int cn, int spill,
                                      int grid) {
  if (grid) return (size_t)4 * batch * cs * cn;
  if (!spill) return 0;
  return (size_t)batch * cs * cn * region_floats(s, d, geometry(cs, cn, 1, 0, 1, 0));
}

// How many clusters of that geometry the current device holds at once
// (cudaOccupancyMaxActiveClusters) for f32 (bf16 == 0) or bf16 inputs, or a
// negative CUDA error.
int xslot_fwd_tiled_max_clusters(int n, int s, int d, int cs, int cn, int tn, int streamed,
                                 int spill, int bf16) {
  const void* fn = bf16 ? kernel_of<__nv_bfloat16>(spill) : kernel_of<float>(spill);
  const int err = allow_large_clusters(fn);
  if (err != 0) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = launch_config(
      attr, 1, cs * cn, 0, xslot_fwd_tiled_smem_bytes(n, s, d, cs, cn, tn, streamed, spill),
      nullptr);
  return max_active_clusters(fn, &config);
}

// How many CTAs of that geometry the current device holds at once outside
// clusters (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor), the most a
// grid launch may have, or a negative CUDA error.
int xslot_fwd_tiled_max_ctas(int n, int s, int d, int cs, int cn, int tn, int streamed,
                             int spill, int bf16) {
  const void* fn = bf16 ? kernel_of<__nv_bfloat16>(spill) : kernel_of<float>(spill);
  const size_t smem = xslot_fwd_tiled_smem_bytes(n, s, d, cs, cn, tn, streamed, spill);
  int err = ensure_smem(fn, smem);
  if (err != 0) return -err;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock, smem);
  return e == cudaSuccess ? sms * per_sm : -(int)e;
}

// Launches the kernel on `stream`, cs x cn CTAs per batch element: one
// cluster an element, or (grid, cn == 1, the slot buffers in shared memory)
// one cooperative launch whose CTAs exchange the groups' totals through the
// scratch and a grid barrier; returns 0 or the error. Pointers are contiguous device arrays: k,
// v (B,N,d); slots0 (S,d); w_ih, w_hh (3d,d); b_ih, b_hh (3d), all f32
// (bf16 == 0) or all bf16 (bf16 == 1); upd (B,S,d), attn (B,S,N) and hist
// (B,iters,S,d) or nullptr, f32; scratch of xslot_fwd_tiled_scratch_floats
// floats (or nullptr), 16-byte aligned. d % 4 == 0; `div` is the update's
// divisor (the true slot width).
int xslot_fwd_tiled(const void* k, const void* v, const void* slots0, const void* w_ih,
                    const void* w_hh, const void* b_ih, const void* b_hh, void* upd, void* attn,
                    void* hist, void* scratch, int batch, int n, int s, int d, int iters,
                    float scale, float div, int bf16, int cs, int cn, int tn, int streamed,
                    int spill, int grid, void* stream) {
  if (grid && (cn != 1 || spill)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(cs, cn, tn, streamed, spill, grid);
  const void* fn = bf16 ? kernel_of<__nv_bfloat16>(spill) : kernel_of<float>(spill);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = launch_config(attr, batch, cs * cn, grid,
                                                  smem_floats(n, s, d, g) * sizeof(float), stream);
  int err = allow_large_clusters(fn);
  if (err == 0) err = ensure_smem(fn, config.dynamicSmemBytes);
  if (err != 0) {
    (void)cudaGetLastError();  // a refused call leaves no error behind for the next
    return err;
  }
  using bf = __nv_bfloat16;
  if (bf16) {
    err = (int)cudaLaunchKernelEx(&config, spill ? xslot_fwd_tiled_kernel<bf, true>
                                                 : xslot_fwd_tiled_kernel<bf, false>,
                                  (const bf*)k, (const bf*)v, (const bf*)slots0, (const bf*)w_ih,
                                  (const bf*)w_hh, (const bf*)b_ih, (const bf*)b_hh, (float*)upd,
                                  (float*)attn, (float*)hist, (float*)scratch, n, s, d, iters,
                                  scale, div, g);
  } else {
    err = (int)cudaLaunchKernelEx(&config, spill ? xslot_fwd_tiled_kernel<float, true>
                                                 : xslot_fwd_tiled_kernel<float, false>,
                                  (const float*)k, (const float*)v, (const float*)slots0,
                                  (const float*)w_ih, (const float*)w_hh, (const float*)b_ih,
                                  (const float*)b_hh, (float*)upd, (float*)attn, (float*)hist,
                                  (float*)scratch, n, s, d, iters, scale, div, g);
  }
  if (err != 0) {
    (void)cudaGetLastError();
    return err;
  }
  return (int)cudaGetLastError();
}

#ifdef XSLOT_STAMPS
// Copies `count` of g_stamps to `out` (kStampCtas x kStampSlots) and zeroes
// them; returns 0 or the CUDA error.
int xslot_fwd_tiled_stamps(long long* out, int count) {
  void* addr = nullptr;
  int err = (int)cudaMemcpyFromSymbol(out, g_stamps, (size_t)count * sizeof(long long));
  if (err == 0) err = (int)cudaGetSymbolAddress(&addr, g_stamps);
  return err != 0 ? err : (int)cudaMemset(addr, 0, sizeof(g_stamps));
}
#endif

}  // extern "C"
