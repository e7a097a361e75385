// Checkpointed backward of the fused xSlot loop for Hopper (sm_90a), f32.
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
// What bounds it: per element 3 attention recomputes and backwards and 2 GRU
// recomputes and backwards, ~12.2 MFLOP at the flagship (S=30, N=49, d=64):
// 0.013 ms at B=70 over the card's f32 rate, ~24 us on one SM.
// What the design does about it: one cluster per element with the slots split
// as in the forward (xslot_common.cuh; the wrapper plans c the same way); only
// T and sum_i rg_i / rs_i cross CTAs, each added from all of the element's
// per-slot values through distributed shared memory in the slots' order once
// per iteration. The GRU recompute streams the weights through shared memory
// in tiles, as the forward does where they do not fit whole; dx and dh read
// W_ih and W_hh by rows, coalesced, from L2. The partial dk and dv of each CTA are
// summed across the cluster in rank order at the end. The sums over the
// batch (dW, db, d_initial_slots) use no float atomics: each CTA writes its
// dW and db partials to `partials` and its rows of d_slots0 to `dslots0`, and
// a second launch sums them in a fixed order, so the gradient is the same
// bits from run to run. Where no cluster of 8 CTAs holds an element's share
// of the backward's state (S=1000 at N=81, N=196 at S=30), the wrapper
// plans the tiled route below instead: the same formulas as a chain of
// launches over the batch, with the intermediates in device memory.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include <algorithm>

#include "xslot_common.cuh"

using namespace xslot;

namespace {

// Layout of one CTA's dynamic shared memory, in floats (ld = d + 4): k, v
// (n, ld); the CTA's partial dk, dv (n, d); h, upd, incoming and outgoing
// dslots, dupd (5 x slp x ld); dots, attn, their gradient (3 x slp x n); row
// sums, rg and rg / row sums (3 x slp); dgi, dgh (2 x slp x 3d); two weight
// tiles.
__host__ __device__ inline size_t bwd_smem_floats(int n, int s_cta, int d) {
  const size_t slp = round4(s_cta), ld = row_ld(d);
  return 2 * (size_t)n * ld + 2 * (size_t)n * d + 5 * slp * ld + 3 * slp * n + 3 * slp +
         6 * slp * d + tile_floats(d, false);
}

// floats of one CTA's partial: dW_ih, dW_hh (3d, d), db_ih, db_hh (3d)
__host__ __device__ inline size_t partial_floats(int d) { return 6 * (size_t)d * d + 6 * d; }

// part[m] (+)= dg_m^T X_m over the CTA's slots, for m = 0 (dgi, upd) and 1
// (dgh, h), and part's biases (+)= the column sums of dg_m. One thread per
// (matrix, four rows, four columns); each writes its own words, so the
// accumulation across iterations needs no synchronisation.
__device__ void weight_grads(float* __restrict__ part, const float* dgi, const float* dgh,
                             const float* x, const float* h, int ld, int sl, int d, bool first) {
  const int nq = d >> 2, rq = (3 * d) >> 2, dg_ld = 3 * d;
  for (int task = threadIdx.x; task < 2 * rq * nq; task += blockDim.x) {
    const int q = task % nq, rest = task / nq, m = rest / rq, r4 = 4 * (rest - m * rq);
    const float* dg = m ? dgh : dgi;
    const float* xm = m ? h : x;
    float acc[4][4] = {};
    for (int s = 0; s < sl; ++s) {
      const float4 gv = *reinterpret_cast<const float4*>(dg + s * dg_ld + r4);
      const float4 xv = *reinterpret_cast<const float4*>(xm + s * ld + 4 * q);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(comp(gv, a), comp(xv, e), acc[a][e]);
    }
    float* out = part + (size_t)m * 3 * d * d + (size_t)r4 * d + 4 * q;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4* o = reinterpret_cast<float4*>(out + a * d);
      float4 val = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      if (!first) {
        const float4 old = *o;
        val = make_float4(old.x + val.x, old.y + val.y, old.z + val.z, old.w + val.w);
      }
      *o = val;
    }
  }
  for (int i = threadIdx.x; i < 6 * d; i += blockDim.x) {
    const int m = i >= 3 * d, row = i - m * 3 * d;
    const float* dg = m ? dgh : dgi;
    float acc = 0.0f;
    for (int s = 0; s < sl; ++s) acc += dg[s * dg_ld + row];
    float* o = part + 6 * (size_t)d * d + i;
    *o = first ? acc : *o + acc;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
xslot_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                 const float* __restrict__ b_ih, const float* __restrict__ b_hh,
                 const float* __restrict__ hist, const float* __restrict__ du,
                 const float* __restrict__ dattn, float* __restrict__ dk_out,
                 float* __restrict__ dv_out, float* __restrict__ partials,
                 float* __restrict__ dslots0, int n, int s, int d, int iters, float scale) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / c;
  int s0, sl;
  slot_range(s, c, rank, &s0, &sl);
  const int slp = round4(share_max(s, c)), ld = row_ld(d), d3 = 3 * d;

  float* ks = smem;
  float* vs = ks + n * ld;
  float* dk_s = vs + n * ld;
  float* dv_s = dk_s + n * d;
  float* h = dv_s + n * d;
  float* x = h + slp * ld;
  float* g = x + slp * ld;    // cotangent of the slots leaving the iteration
  float* dh = g + slp * ld;   // cotangent of the slots entering it
  float* dx = dh + slp * ld;  // dupd
  float* dots = dx + slp * ld;
  float* attn = dots + slp * n;
  float* p = attn + slp * n;  // dattn_tot, then G, then d dots
  float* rs = p + slp * n;
  float* rg = rs + slp;
  float* qv = rg + slp;
  float* dgi = qv + slp;
  float* dgh = dgi + slp * d3;
  float* tiles = dgh + slp * d3;
  float* part = partials + blockIdx.x * partial_floats(d);

  zero(dk_s, (size_t)(tiles - dk_s));
  __syncthreads();
  load_rows(ks, ld, k + b * n * d, n, d);
  load_rows(vs, ld, v + b * n * d, n, d);

  const GruTile tile(d);
  for (int it = iters - 1; it >= 0; --it) {
    const bool last = it == iters - 1;
    // rebuild the iteration's forward from hist[:, it]
    load_rows(h, ld, hist + ((b * iters + it) * s + s0) * d, sl, d);
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    rows_dot_rows(dots, h, ks, ld, sl, n, d, scale, 1.0f, nullptr, 0);
    __syncthreads();
    row_sums(rs, dots, nullptr, sl, n);
    const float total = cluster_slot_sum(cluster, rs, s);
    for (int i = threadIdx.x; i < sl * n; i += blockDim.x) {
      attn[i] = sigmoid_f32(dots[i] / rs[i / n] * total);
    }
    __syncthreads();
    rows_times(x, ld, attn, n, vs, ld, sl, n, d, (float)d, false);
    __syncthreads();

    if (last) {
      load_rows(dx, ld, du + (b * s + s0) * d, sl, d);
      copy_commit();
      copy_wait<0>();
    } else {
      // the GRU's gates again, and its backward for cotangent g
      for (int base = 0; base < sl; base += tile.chunk()) {
        const int sa = tile.first(base, sl);
        GruAcc acc;
        gru_products(acc, x, h, sa, tile.q, sa >= 0, tiles, w_ih, w_hh, d, false);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int si = sa + r;
          if (sa < 0 || si >= sl) break;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = gru_col(tile.q, u, d);
            const float ir = acc.gi[r][0][u] + b_ih[j];
            const float iz = acc.gi[r][1][u] + b_ih[d + j];
            const float in = acc.gi[r][2][u] + b_ih[2 * d + j];
            const float hr = acc.gh[r][0][u] + b_hh[j];
            const float hz = acc.gh[r][1][u] + b_hh[d + j];
            const float hn = acc.gh[r][2][u] + b_hh[2 * d + j];
            const float rg_ = sigmoid_f32(ir + hr);
            const float zg = sigmoid_f32(iz + hz);
            const float ng = tanhf(in + rg_ * hn);
            const float gv = g[si * ld + j], hv = h[si * ld + j];
            const float dn = gv * (1.0f - zg), dz = gv * (hv - ng);
            const float a_n = dn * (1.0f - ng * ng);
            const float a_r = a_n * hn * rg_ * (1.0f - rg_);
            const float a_z = dz * zg * (1.0f - zg);
            float* gi_row = dgi + si * d3;
            float* gh_row = dgh + si * d3;
            gi_row[j] = a_r;
            gi_row[d + j] = a_z;
            gi_row[2 * d + j] = a_n;
            gh_row[j] = a_r;
            gh_row[d + j] = a_z;
            gh_row[2 * d + j] = a_n * rg_;
            dh[si * ld + j] = gv * zg;
          }
        }
      }
      __syncthreads();
      rows_times(dx, ld, dgi, d3, w_ih, d, sl, d3, d, 1.0f, false);
      rows_times(dh, ld, dgh, d3, w_hh, d, sl, d3, d, 1.0f, true);
      weight_grads(part, dgi, dgh, x, h, ld, sl, d, it == iters - 2);
    }
    __syncthreads();

    // attention: dattn_tot, dv, G, the renorm's gradient, dh and dk
    rows_dot_rows(p, dx, vs, ld, sl, n, d, 1.0f, (float)d,
                  last ? dattn + (b * s + s0) * n : nullptr, n);
    cols_times(dv_s, attn, n, dx, ld, sl, d, (float)d);
    __syncthreads();
    for (int i = threadIdx.x; i < sl * n; i += blockDim.x) {
      p[i] = p[i] * attn[i] * (1.0f - attn[i]);
    }
    __syncthreads();
    row_sums(rg, p, dots, sl, n);
    __syncthreads();
    for (int i = threadIdx.x; i < sl; i += blockDim.x) qv[i] = rg[i] / rs[i];
    const float qsum = cluster_slot_sum(cluster, qv, s);
    for (int i = threadIdx.x; i < sl * n; i += blockDim.x) {
      const int si = i / n;
      p[i] = (total * p[i] / rs[si] - total * rg[si] / (rs[si] * rs[si]) + qsum) * scale;
    }
    __syncthreads();
    rows_times(dh, ld, p, n, ks, ld, sl, n, d, 1.0f, !last);
    cols_times(dk_s, p, n, h, ld, sl, d, 1.0f);
    __syncthreads();
    float* t = g;
    g = dh;
    dh = t;
  }

  store_rows(dslots0 + (b * s + s0) * d, g, ld, sl, d);
  if (iters == 1) {
    for (size_t i = threadIdx.x; i < partial_floats(d); i += blockDim.x) part[i] = 0.0f;
  }
  // dk and dv: the CTAs' partials summed in rank order, each CTA writing its
  // share of the rows; the second sync keeps this CTA's partials alive while
  // its peers read them
  element_sync(cluster);
  int n0, nl;
  slot_range(n, c, rank, &n0, &nl);
  for (int i = threadIdx.x; i < nl * d; i += blockDim.x) {
    const int idx = n0 * d + i;
    float sk = 0.0f, sv = 0.0f;
    for (int r = 0; r < c; ++r) {
      sk += cluster.map_shared_rank(dk_s, r)[idx];
      sv += cluster.map_shared_rank(dv_s, r)[idx];
    }
    dk_out[b * n * d + idx] = sk;
    dv_out[b * n * d + idx] = sv;
  }
  if (c > 1) cluster.sync();
}

// Output e of the sums over the batch, each added in a fixed order: the CTAs'
// dW and db partials (partial p at partials + p * per_cta) into dw_ih, dw_hh
// (3d x d), db_ih, db_hh (3d), and the elements' rows of dslots0 (B, S*d)
// into d_init.
__device__ __forceinline__ void sum_partials(int e, const float* __restrict__ partials,
                                             int nparts, const float* __restrict__ dslots0,
                                             int batch, int sd, int d, float* __restrict__ dw_ih,
                                             float* __restrict__ dw_hh,
                                             float* __restrict__ db_ih,
                                             float* __restrict__ db_hh,
                                             float* __restrict__ d_init) {
  const int per_cta = (int)partial_floats(d), dd = 3 * d * d;
  if (e < per_cta) {
    float acc = 0.0f;
    for (int i = 0; i < nparts; ++i) acc += partials[(size_t)i * per_cta + e];
    if (e < dd) {
      dw_ih[e] = acc;
    } else if (e < 2 * dd) {
      dw_hh[e - dd] = acc;
    } else if (e < 2 * dd + 3 * d) {
      db_ih[e - 2 * dd] = acc;
    } else {
      db_hh[e - 2 * dd - 3 * d] = acc;
    }
  } else if (e < per_cta + sd) {
    const int f = e - per_cta;
    float acc = 0.0f;
    for (int i = 0; i < batch; ++i) acc += dslots0[(size_t)i * sd + f];
    d_init[f] = acc;
  }
}

// The cluster route's sums over the batch (sum_partials), one thread an output.
__global__ void xslot_bwd_sum_kernel(const float* __restrict__ partials, int nparts,
                                     const float* __restrict__ dslots0, int batch, int sd, int d,
                                     float* __restrict__ dw_ih, float* __restrict__ dw_hh,
                                     float* __restrict__ db_ih, float* __restrict__ db_hh,
                                     float* __restrict__ d_init) {
  sum_partials(blockIdx.x * blockDim.x + threadIdx.x, partials, nparts, dslots0, batch, sd, d,
               dw_ih, dw_hh, db_ih, db_hh, d_init);
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

constexpr int kBM = 128;          // rows of a product's CTA tile
constexpr int kBK = 16;           // inner terms staged per pipeline stage
constexpr int kMaxSplit = 8;      // pieces of a split inner dimension
constexpr int kSplitDepth = 128;  // the least inner length of a piece
constexpr int kBatch = 8;         // elements per thread of the elementwise passes, loaded
                                  // together

// Element (z, r, c) of an operand at p[z * sz + r * sr + c * sc] (z the
// batch element).
struct View {
  const float* p;
  long long sz, sr, sc;
};

// One product of a launch: c(z, m, j) = [c +] [add +] (sum_i a(z, m, i)
// b(z, i, j)) * (mul / div). Piece q of a split product writes at
// c + q * pc + z * zc + m * ldc + j; a row output of the epilogue at
// rowout + q * pc + z * rz + m.
struct Prod {
  View a, b, add;
  float* c;
  long long pc, zc;
  int ldc, accumulate;
  float mul, div;
  float* rowout;
  long long rz;
};

// What tile_gemm's epilogue does beyond the store: the outputs' row sums into
// rowout (the dots' rs); the renorm's gradient in place of P (kRenorm); the
// row sums of the first operand over the piece's inner terms into rowout,
// stored or added as c is (kSumA, dW's db).
enum Epilogue { kStore = 0, kRowSum = 1, kRenorm = 2, kSumA = 3 };

// kRenorm's operands: attn and dots in c's layout, rs, rg and q one per row
// as rowout. G = P attn (1 - attn) replaces P, rg = sum_j G D, q = rg / rs.
struct Renorm {
  const float* attn;
  const float* dots;
  const float* rs;
  float* rg;
  float* q;
};

// The launch's extent: rows x cols outputs over `inner` terms, row m being
// row m % fold of element z + m / fold (fold == rows: one element a grid
// slice, z from the grid); `batch` grid slices, the inner terms in `pieces`
// pieces of `chunk`.
struct Shape {
  int rows, cols, inner, fold, batch, pieces, chunk;
};

__host__ __device__ inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

__device__ __forceinline__ void copy1(float* dst, const float* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}

// How an operand reaches shared memory, as t[i][e] = x(e, i) for the kBK
// inner terms i of a stage and the E rows or columns e of the tile, rows of
// E + 4 floats (zero past the tile's edge or the piece's end):
// - kCopy16: contiguous and 16-byte aligned along e: 16-byte cp.async copies
//   of elements e4..e4+3 (e4 = 4 (tid % (E/4))).
// - kCopy4: contiguous along e but not aligned (or along neither): 4-byte
//   cp.async copies of element e = tid % E, neighbouring threads on
//   neighbouring addresses.
// - kTranspose: contiguous along i: four inner terms i4..i4+3 of rows tid/4
//   (+ 64) loaded into registers (one 16-byte load where `vec_i`), four
//   threads on one 64-byte run of a row, and stored down the tile's column
//   after the stage's compute (the 4-float row padding keeps those stores
//   at two ways per bank).
enum Route { kCopy16 = 0, kCopy4 = 1, kTranspose = 2 };

template <int E>
struct Operand {
  static constexpr int kLd = E + 4;                    // row stride in shared memory
  static constexpr int kGroups = E * kBK / (4 * kThreads);  // 4-float groups a thread
  int route, valid4;  // kCopy16: elements of the thread's group inside the edge
  bool vec_i;
  long long si;       // inner stride
  const float* ptr[kGroups];  // kTranspose: each group's row, else ptr[0] (null past the edge)
  float4 reg[kGroups];

  // `elem(e)`: the address of element (e, 0), e inside the tile's `limit`.
  template <typename F>
  __device__ __forceinline__ Operand(int route_, bool vec_i_, long long si_, int limit, F elem)
      : route(route_), valid4(0), vec_i(vec_i_), si(si_) {
    const int tid = threadIdx.x;
    if (route == kCopy16) {
      const int e4 = 4 * (tid % (E / 4));
      valid4 = max(0, min(4, limit - e4));
      ptr[0] = valid4 > 0 ? elem(e4) : nullptr;
    } else if (route == kCopy4) {
      ptr[0] = tid % E < limit ? elem(tid % E) : nullptr;
    } else {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int e = tid / 4 + g * (kThreads / 4);
        ptr[g] = e < limit ? elem(e) : nullptr;
      }
    }
  }

  // Starts the stage of inner terms [i0, i0 + kBK) (below iend) into t: the
  // cp.async copies, or the loads into registers for store().
  __device__ __forceinline__ void issue(float* t, int i0, int iend) {
    const int tid = threadIdx.x;
    if (route == kCopy16) {
      constexpr int q = E / 4;
      const int e4 = 4 * (tid % q);
#pragma unroll
      for (int r = 0; r < kGroups; ++r) {
        const int i = tid / q + r * (kThreads / q);
        float* dst = t + i * kLd + e4;
        const float* src = ptr[0] + (long long)(i0 + i) * si;
        if (i0 + i >= iend || valid4 == 0) {
          *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (valid4 == 4) {
          copy4(dst, src);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) dst[u] = u < valid4 ? src[u] : 0.0f;
        }
      }
    } else if (route == kCopy4) {
      const int e = tid % E;
#pragma unroll
      for (int r = 0; r < 4 * kGroups; ++r) {
        const int i = tid / E + r * (kThreads / E);
        float* dst = t + i * kLd + e;
        if (ptr[0] != nullptr && i0 + i < iend) {
          copy1(dst, ptr[0] + (long long)(i0 + i) * si);
        } else {
          *dst = 0.0f;
        }
      }
    } else {
      const int i = i0 + 4 * (tid % 4);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float* row = ptr[g];
        if (row != nullptr && vec_i && i + 3 < iend) {
          reg[g] = *reinterpret_cast<const float4*>(row + i);
        } else {
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = row != nullptr && i + u < iend ? row[i + u] : 0.0f;
          reg[g] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }

  // kTranspose: the registers of issue() down the tile's columns of t.
  __device__ __forceinline__ void store(float* t) const {
    if (route != kTranspose) return;
    const int tid = threadIdx.x, i4 = 4 * (tid % 4);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float* col = t + i4 * kLd + tid / 4 + g * (kThreads / 4);
      col[0] = reg[g].x;
      col[kLd] = reg[g].y;
      col[2 * kLd] = reg[g].z;
      col[3 * kLd] = reg[g].w;
    }
  }
};

// warp_sum in f64, for the renorm's row sums
__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The product kernel of the tiled route (see Prod and Shape). blockIdx.x,y
// pick the tile's columns and rows, blockIdx.z = (group * pieces + piece) *
// batch + z. Thread (tx, ty) = (tid % 16, tid / 16) accumulates rows
// 4ty..4ty+3 and 64+4ty..64+4ty+3 of the tile and columns 4tx..4tx+3 (and
// 64+4tx.. at BN = 128): the float4 reads of a warp fall on distinct banks
// or broadcast.
// `routes` holds each operand's Route, two bits each in the order a0, b0,
// a1, b1; `vec_i` bit 2g (a) and 2g+1 (b) marks a kTranspose operand whose
// rows are 16-byte aligned.
template <int BN>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 1 : 2)
tile_gemm(Prod p0, Prod p1, Shape sh, int epilogue, Renorm rn, unsigned routes,
          unsigned vec_i) {
  constexpr int TN = BN / 16;
  using OpA = Operand<kBM>;
  using OpB = Operand<BN>;
  // the two stages of a and b; the epilogue reuses them for half a tile
  constexpr int kStageA = kBK * OpA::kLd, kStageB = kBK * OpB::kLd, kOutLd = BN + 4;
  static_assert(64 * kOutLd <= 2 * (kStageA + kStageB), "half a tile fits the stages");
  __shared__ __align__(16) float smem[2 * (kStageA + kStageB)];
  const auto as = [&](int k) { return smem + k * kStageA; };
  const auto bs = [&](int k) { return smem + 2 * kStageA + k * kStageB; };
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int gz = blockIdx.z;
  const int z0 = gz % sh.batch;
  gz /= sh.batch;
  const int piece = gz % sh.pieces, group = gz / sh.pieces;
  const Prod pr = group ? p1 : p0;
  const int i_begin = piece * sh.chunk, i_end = min(sh.inner, i_begin + sh.chunk);
  const int m0 = blockIdx.y * kBM, j0 = blockIdx.x * BN;

  OpA a((routes >> (4 * group)) & 3u, (vec_i >> (2 * group)) & 1u, pr.a.sc, sh.rows - m0,
        [&](int e) {
          const int m = m0 + e;
          return pr.a.p + (long long)(z0 + m / sh.fold) * pr.a.sz +
                 (long long)(m % sh.fold) * pr.a.sr;
        });
  OpB b((routes >> (4 * group + 2)) & 3u, (vec_i >> (2 * group + 1)) & 1u, pr.b.sr,
        sh.cols - j0, [&](int e) {
          return pr.b.p + (long long)z0 * pr.b.sz + (long long)(j0 + e) * pr.b.sc;
        });

  // dW's db: thread tid < kBM adds row tid of a over the piece's inner terms
  const bool sum_a = epilogue == kSumA && blockIdx.x == 0;
  float asum = 0.0f;
  float acc[8][TN];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < TN; ++w) acc[u][w] = 0.0f;

  const int nk = ceil_div(i_end - i_begin, kBK);
  a.issue(as(0), i_begin, i_end);
  b.issue(bs(0), i_begin, i_end);
  copy_commit();
  a.store(as(0));
  b.store(bs(0));
  copy_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    const int next = (kt + 1) & 1;
    if (more) {
      a.issue(as(next), i_begin + (kt + 1) * kBK, i_end);
      b.issue(bs(next), i_begin + (kt + 1) * kBK, i_end);
    }
    copy_commit();
    const float* at = as(kt & 1);
    const float* bt = bs(kt & 1);
#pragma unroll
    for (int i = 0; i < kBK; ++i) {
      const float4 a0 = *reinterpret_cast<const float4*>(at + i * OpA::kLd + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(at + i * OpA::kLd + 64 + 4 * ty);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(bt + i * OpB::kLd + 4 * tx);
      bv[0] = b0.x;
      bv[1] = b0.y;
      bv[2] = b0.z;
      bv[3] = b0.w;
      if (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(bt + i * OpB::kLd + 64 + 4 * tx);
        bv[TN - 4] = b1.x;
        bv[TN - 3] = b1.y;
        bv[TN - 2] = b1.z;
        bv[TN - 1] = b1.w;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < TN; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
    }
    if (sum_a && tid < kBM) {
#pragma unroll
      for (int i = 0; i < kBK; ++i) asum += at[i * OpA::kLd + tid];
    }
    if (more) {
      a.store(as(next));
      b.store(bs(next));
    }
    copy_wait<0>();
    __syncthreads();
  }

  if (sum_a && tid < kBM && m0 + tid < sh.rows) {
    float* o = pr.rowout + piece * pr.pc + (long long)z0 * pr.rz + m0 + tid;
    *o = pr.accumulate ? *o + asum : asum;
  }
  // The outputs go through shared memory half a tile (64 rows) at a time;
  // then each warp finishes whole rows, its lanes on neighbouring columns,
  // so the epilogue's loads and stores are coalesced and a row's sums are
  // one warp's (lane l adds columns l, l+32, ..., then the lanes).
  const int warp = tid / 32, lane = tid % 32;
  const float scale = pr.mul / pr.div;  // exact where div is a power of two (d = 64)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = 4 * half + u;
      float* dst = smem + (4 * ty + u) * kOutLd + 4 * tx;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      if (TN == 8) {
        *reinterpret_cast<float4*>(dst + 64) =
            make_float4(acc[q][TN - 4], acc[q][TN - 3], acc[q][TN - 2], acc[q][TN - 1]);
      }
    }
    __syncthreads();
    for (int rr = warp; rr < 64; rr += kThreads / 32) {
      const int m = m0 + 64 * half + rr;
      if (m >= sh.rows) break;
      const int dz = m / sh.fold;
      const int z = z0 + dz, r = m - dz * sh.fold;
      const long long off = (long long)z * pr.zc + (long long)r * pr.ldc;
      float* crow = pr.c + piece * pr.pc + off;
      const float* add_row =
          pr.add.p ? pr.add.p + (long long)z * pr.add.sz + (long long)r * pr.add.sr : nullptr;
      // the row's loads first, all in flight together, then its stores
      constexpr int kCols = BN / 32;
      float old[kCols], extra[kCols], at[kCols], dt[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = j0 + lane + 32 * k;
        const bool ok = j < sh.cols, renorm = ok && epilogue == kRenorm;
        old[k] = ok && pr.accumulate ? crow[j] : 0.0f;
        extra[k] = ok && add_row ? add_row[j * pr.add.sc] : 0.0f;
        at[k] = renorm ? rn.attn[off + j] : 0.0f;
        dt[k] = renorm ? rn.dots[off + j] : 0.0f;
      }
      double rsum = 0.0;  // the renorm divides by rs, and by rs^2 in its gradient
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j >= sh.cols) continue;
        float v = smem[rr * kOutLd + lane + 32 * k] * scale;
        if (add_row) v = extra[k] + v;
        if (epilogue == kRenorm) {
          v = v * at[k] * (1.0f - at[k]);
          rsum += (double)v * dt[k];
        } else if (epilogue == kRowSum) {
          rsum += v;
        }
        crow[j] = pr.accumulate ? old[k] + v : v;
      }
      if (epilogue != kRowSum && epilogue != kRenorm) continue;
      const double total = warp_sum_f64(rsum);
      if (lane != 0) continue;
      const long long ro = (long long)z * pr.rz + r;
      if (epilogue == kRowSum) {
        pr.rowout[ro] = (float)total;
      } else {
        rn.rg[ro] = (float)total;
        rn.q[ro] = (float)(total / rn.rs[ro]);
      }
    }
    __syncthreads();
  }
}

// out[r] = sum_j x[r][j] for r < rows (rows of n), one warp a row, added in
// f64 as tile_gemm's epilogue adds it (where the dots' product cannot)
__global__ void row_sum_kernel(const float* __restrict__ x, long long rows, int n,
                               float* __restrict__ out) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  double acc = 0.0;
  for (int j = lane; j < n; j += 32) acc += x[r * n + j];
  acc = warp_sum_f64(acc);
  if (lane == 0) out[r] = (float)acc;
}

// The sum of one element's `s` values, taken by the whole block in a fixed
// order (thread t adds t, t + kThreads, ..., each warp its lanes, then thread
// 0 the warps in order) into `shared` (kThreads / 32 + 1 floats) and returned
// to every thread.
__device__ inline float block_slot_total(const float* __restrict__ vals, int s, float* shared) {
  constexpr int kWarps = kThreads / 32;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < s; i += kThreads) acc += vals[i];
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) shared[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += shared[w];
    shared[kWarps] = t;
  }
  __syncthreads();
  return shared[kWarps];
}

// attn = sigmoid(dots / rs * T) over element blockIdx.y's (S, N), T the sum
// of its row sums
__global__ void attn_kernel(const float* __restrict__ dots, const float* __restrict__ rs, int s,
                            int n, float* __restrict__ attn) {
  __shared__ float total[kThreads / 32 + 1];
  const int z = blockIdx.y, sn = s * n;
  const float t = block_slot_total(rs + (size_t)z * s, s, total);
  const float* d = dots + (size_t)z * sn;
  const float* r_z = rs + (size_t)z * s;
  float* a = attn + (size_t)z * sn;
  const int step = gridDim.x * blockDim.x;
  for (int i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < sn; i0 += kBatch * step) {
    float x[kBatch], r[kBatch];  // a batch's loads in flight together
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * step;
      x[k] = i < sn ? d[i] : 0.0f;
      r[k] = i < sn ? r_z[i / n] : 1.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * step;
      if (i < sn) a[i] = sigmoid_f32(x[k] / r[k] * t);
    }
  }
}

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

// The sums that end the tiled route, each in a fixed order: the (piece,
// element) partials of dW and db and the elements' rows of d_slots0 as
// xslot_bwd_sum_kernel adds them, then, where dv and dk were split, their
// `pieces` pieces (dv's, then dk's, each (pieces, bnd) floats).
__global__ void tiled_sum_kernel(const float* __restrict__ partials, int nparts,
                                 const float* __restrict__ dslots0, int batch, int sd, int d,
                                 float* __restrict__ dw_ih, float* __restrict__ dw_hh,
                                 float* __restrict__ db_ih, float* __restrict__ db_hh,
                                 float* __restrict__ d_init, const float* __restrict__ kv,
                                 int pieces, long long bnd, float* __restrict__ dv,
                                 float* __restrict__ dk) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long head = (long long)partial_floats(d) + sd;
  if (e < head) {
    sum_partials((int)e, partials, nparts, dslots0, batch, sd, d, dw_ih, dw_hh, db_ih, db_hh,
                 d_init);
  } else if (kv != nullptr && e < head + 2 * bnd) {
    const long long f = e - head, grp = f / bnd, r = f - grp * bnd;
    const float* src = kv + grp * pieces * bnd + r;
    float acc = 0.0f;
    for (int p = 0; p < pieces; ++p) acc += src[p * bnd];
    (grp ? dk : dv)[r] = acc;
  }
}

enum { kDots, kX, kGates, kDGates, kDW, kP, kDH, kDKV, kProducts };

// One product's tile width, inner pieces (of `chunk` terms) and rows.
struct ProductPlan {
  int rows, bn, pieces, chunk;
};

// The CTA tile's width for `cols` output columns: 128 unless 64 pads fewer.
inline int tile_cols(int cols) {
  return ceil_div(cols, 128) * 128 <= ceil_div(cols, 64) * 64 ? 128 : 64;
}

// A product of rows x cols over `inner` terms on `batch` grid slices and
// `groups` operand pairs. With `split`, where its tiles leave some of the
// CTAs that `sms` SMs hold at once idle (tile_gemm's launch bounds: two a SM
// at BN = 64, one at 128), the inner terms go into as many pieces as those
// CTAs take in one wave, at most kMaxSplit, each at least kSplitDepth long.
inline ProductPlan plan_product(int rows, int cols, int inner, int batch, int groups,
                                bool split, int sms) {
  ProductPlan p{rows, tile_cols(cols), 1, 0};
  const int tiles = ceil_div(rows, kBM) * ceil_div(cols, p.bn) * batch * groups;
  const int resident = sms * (p.bn == 128 ? 1 : 2);
  int pieces = 1;
  if (split && tiles < resident) {
    pieces = std::max(1, std::min({kMaxSplit, inner / kSplitDepth, resident / tiles}));
  }
  p.chunk = ceil_div(ceil_div(inner, pieces), kBK) * kBK;
  p.pieces = ceil_div(inner, p.chunk);
  return p;
}

// The tiled route's plan at (batch, N, S, d) on a card of `sms` SMs: its
// products (in the order of the enum above), whether the row passes ride in
// the products' epilogues and the scratch in floats.
struct TiledPlan {
  ProductPlan prod[kProducts];
  bool fused;
  size_t scratch;
};

inline TiledPlan tiled_plan(int batch, int n, int s, int d, int sms) {
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
  // (B, S, 3d); dots, attn, P (B, S, N); rs, rg, q (B, S); dv's and dk's pieces
  t.scratch = (size_t)t.prod[kDW].pieces * batch * partial_floats(d) +
              (size_t)bs * (10 * d + 3 * n + 3) +
              (kv > 1 ? 2 * (size_t)kv * batch * n * d : 0);
  return t;
}

inline unsigned blocks(long long count) { return (unsigned)((count + kThreads - 1) / kThreads); }

inline bool aligned4(const float* p, long long stride_a, long long stride_b) {
  return ((size_t)p % 16 == 0) && stride_a % 4 == 0 && stride_b % 4 == 0;
}

// An operand's Route: contiguous along the tile's rows or columns (16-byte
// aligned or not), else along the inner terms, else neither.
inline unsigned route(bool along_e, bool aligned, bool along_i) {
  return along_e ? (aligned ? kCopy16 : kCopy4) : along_i ? kTranspose : kCopy4;
}

// Launches one product, or two of one shape (`p1`), on `stream`.
int gemm(const ProductPlan& plan, const Prod& p0, const Prod* p1, int cols, int inner, int fold,
         int batch, int epilogue, const Renorm& rn, cudaStream_t stream) {
  const Shape sh{plan.rows, cols, inner, fold, batch, plan.pieces, plan.chunk};
  const int groups = p1 ? 2 : 1;
  unsigned routes = 0, vec_i = 0;
  for (int g = 0; g < groups; ++g) {
    const Prod& p = g ? *p1 : p0;
    // a: e is the row (contiguous along it only where unfolded), i the column
    const bool a_rows = p.a.sr == 1 && fold == plan.rows;
    routes |= route(a_rows, a_rows && aligned4(p.a.p, p.a.sc, p.a.sz), p.a.sc == 1) << (4 * g);
    vec_i |= (unsigned)(p.a.sc == 1 && aligned4(p.a.p, p.a.sr, p.a.sz)) << (2 * g);
    routes |= route(p.b.sc == 1, p.b.sc == 1 && aligned4(p.b.p, p.b.sr, p.b.sz), p.b.sr == 1)
              << (4 * g + 2);
    vec_i |= (unsigned)(p.b.sr == 1 && aligned4(p.b.p, p.b.sc, p.b.sz)) << (2 * g + 1);
  }
  const dim3 grid(ceil_div(cols, plan.bn), ceil_div(plan.rows, kBM), batch * plan.pieces * groups);
  if (plan.bn == 128) {
    tile_gemm<128><<<grid, kThreads, 0, stream>>>(p0, p1 ? *p1 : p0, sh, epilogue, rn, routes,
                                                  vec_i);
  } else {
    tile_gemm<64><<<grid, kThreads, 0, stream>>>(p0, p1 ? *p1 : p0, sh, epilogue, rn, routes,
                                                 vec_i);
  }
  return (int)cudaGetLastError();
}

// A product writing c (zc, ldc) from a and b, scaled by mul / div, stored.
inline Prod prod(View a, View b, float* c, long long zc, int ldc, float mul = 1.0f,
                 float div = 1.0f) {
  Prod p{};
  p.a = a;
  p.b = b;
  p.c = c;
  p.zc = zc;
  p.ldc = ldc;
  p.mul = mul;
  p.div = div;
  return p;
}

#define XSLOT_TRY(call)          \
  do {                           \
    const int err_ = (call);     \
    if (err_ != 0) return err_;  \
  } while (0)

int device_sms(int* sms) {
  int device = 0;
  XSLOT_TRY((int)cudaGetDevice(&device));
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// The tiled route: the same gradient as xslot_bwd_kernel + xslot_bwd_sum_kernel.
int tiled_bwd(const float* k, const float* v, const float* w_ih, const float* w_hh,
              const float* b_ih, const float* b_hh, const float* hist, const float* du,
              const float* dattn, float* dk, float* dv, float* d_init, float* dw_ih,
              float* dw_hh, float* db_ih, float* db_hh, float* scratch, int batch, int n,
              int s, int d, int iters, float scale, cudaStream_t stream) {
  int sms = 0;
  XSLOT_TRY(device_sms(&sms));
  const TiledPlan plan = tiled_plan(batch, n, s, d, sms);
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
  float* kv = pkv > 1 ? q + rows : nullptr;
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
                                       (float)d),
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
    Prod p_p = prod(View{dupd, sd, d, 1}, View{v, nd, 1, d}, p, sn, n, 1.0f, (float)d);
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
    Prod dv_p = prod(View{attn, sn, 1, n}, View{dupd, sd, d, 1}, kv ? kv : dv, nd, d, 1.0f,
                     (float)d);
    Prod dk_p = prod(View{p, sn, 1, n}, hv, kv ? kv + pkv * bnd : dk, nd, d);
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
  tiled_sum_kernel<<<blocks(sums), kThreads, 0, stream>>>(
      partials, pw * batch, g, batch, (int)sd, d, dw_ih, dw_hh, db_ih, db_hh, d_init, kv, pkv,
      bnd, dv, dk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA owning `s_cta` slots, in bytes.
size_t xslot_bwd_smem_bytes(int n, int s_cta, int d) {
  return bwd_smem_floats(n, s_cta, d) * sizeof(float);
}

// How many clusters of `cluster` CTAs owning `s_cta` slots each the current
// device holds at once (cudaOccupancyMaxActiveClusters), or a negative CUDA
// error.
int xslot_bwd_max_clusters(int n, int s_cta, int d, int cluster) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(attr, 1, cluster, xslot_bwd_smem_bytes(n, s_cta, d), nullptr);
  return max_active_clusters((const void*)xslot_bwd_kernel, &config);
}

// Floats of the scratch buffer xslot_bwd needs: for a cluster of `cluster`
// CTAs per element the per-CTA partials, then the elements' d_slots0 rows;
// for the tiled route (cluster == 0) its plan's on the current device (0 if
// the device cannot be read, where the route itself fails).
size_t xslot_bwd_scratch_floats(int batch, int n, int s, int d, int cluster) {
  if (cluster == 0) {
    int sms = 0;
    return device_sms(&sms) == 0 ? tiled_plan(batch, n, s, d, sms).scratch : 0;
  }
  return (size_t)batch * cluster * partial_floats(d) + (size_t)batch * s * d;
}

// The tiled route's plan at (batch, N, S, d) on the current device: for each
// product (dots, x, gi|gh, dx|dh, dW_ih|dW_hh, P, dh, dv|dk) its rows, CTA
// tile width and inner pieces at out[3p], out[3p+1], out[3p+2]; returns 0 or
// a negative CUDA error.
int xslot_tiled_plan(int batch, int n, int s, int d, int* out) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return -err;
  const TiledPlan t = tiled_plan(batch, n, s, d, sms);
  for (int i = 0; i < kProducts; ++i) {
    out[3 * i] = t.prod[i].rows;
    out[3 * i + 1] = t.prod[i].bn;
    out[3 * i + 2] = t.prod[i].pieces;
  }
  return 0;
}

// Launches the gradient kernel (`cluster` CTAs per batch element) and the
// fixed-order sum on `stream`, or with cluster == 0 the tiled route; returns
// 0 or the error. Pointers are contiguous f32 device arrays: k, v (B,N,d);
// w_ih, w_hh (3d,d); b_ih, b_hh (3d); hist (B,iters,S,d); du (B,S,d); dattn
// (B,S,N); outputs dk, dv (B,N,d), d_init (S,d), dw_ih, dw_hh (3d,d), db_ih,
// db_hh (3d); scratch of xslot_bwd_scratch_floats floats.
int xslot_bwd(const void* k, const void* v, const void* w_ih, const void* w_hh,
              const void* b_ih, const void* b_hh, const void* hist, const void* du,
              const void* dattn, void* dk, void* dv, void* d_init, void* dw_ih, void* dw_hh,
              void* db_ih, void* db_hh, void* scratch, int batch, int n, int s, int d, int iters,
              float scale, int cluster, void* stream) {
  if (cluster == 0) {
    return tiled_bwd((const float*)k, (const float*)v, (const float*)w_ih, (const float*)w_hh,
                     (const float*)b_ih, (const float*)b_hh, (const float*)hist,
                     (const float*)du, (const float*)dattn, (float*)dk, (float*)dv,
                     (float*)d_init, (float*)dw_ih, (float*)dw_hh, (float*)db_ih,
                     (float*)db_hh, (float*)scratch, batch, n, s, d, iters, scale,
                     (cudaStream_t)stream);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(
      attr, batch, cluster, xslot_bwd_smem_bytes(n, share_max(s, cluster), d), stream);
  float* partials = (float*)scratch;
  float* dslots0 = partials + (size_t)batch * cluster * partial_floats(d);
  int err = ensure_smem((const void*)xslot_bwd_kernel, config.dynamicSmemBytes);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&config, xslot_bwd_kernel, (const float*)k, (const float*)v,
                                (const float*)w_ih, (const float*)w_hh, (const float*)b_ih,
                                (const float*)b_hh, (const float*)hist, (const float*)du,
                                (const float*)dattn, (float*)dk, (float*)dv, partials, dslots0,
                                n, s, d, iters, scale);
  if (err != 0) return err;
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int total = (int)partial_floats(d) + s * d;
  xslot_bwd_sum_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(partials, batch * cluster, dslots0, batch, s * d,
                                                 d, (float*)dw_ih, (float*)dw_hh, (float*)db_ih,
                                                 (float*)db_hh, (float*)d_init);
  return (int)cudaGetLastError();
}

}  // extern "C"
