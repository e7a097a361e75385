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

// The sums over the batch, each added in a fixed order: the CTAs' dW and db
// partials (partial p at partials + p * per_cta) into dw_ih, dw_hh (3d x d),
// db_ih, db_hh (3d), and the elements' rows of dslots0 (B, S*d) into d_init.
__global__ void xslot_bwd_sum_kernel(const float* __restrict__ partials, int nparts,
                                     const float* __restrict__ dslots0, int batch, int sd, int d,
                                     float* __restrict__ dw_ih, float* __restrict__ dw_hh,
                                     float* __restrict__ db_ih, float* __restrict__ db_hh,
                                     float* __restrict__ d_init) {
  const int per_cta = (int)partial_floats(d), dd = 3 * d * d;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
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

// ------------------------------------------------------------ tiled route
//
// Where an element's share of the slots does not fit in a cluster of 8 CTAs
// (S=1000 at N=81, N=196 at S=30, at d=64), each iteration's backward runs
// as a chain of launches over the whole batch, its intermediates in device
// memory: tiled products (tiled_gemm) and row-wise passes. Every output
// element adds its terms in a fixed order, so the route is as deterministic
// as the fused kernel; the sums over slots (T, sum_i rg_i / rs_i, dk, dv, dW, db) are
// products or row passes with the slots as their inner dimension. A product
// with a long inner dimension and too few output tiles to fill the card (dk,
// dv and dW over S=1000 slots) splits its inner dimension into up to
// kMaxSplit pieces, each CTA writing its piece's sums, and gemm_reduce adds
// the pieces in order.

constexpr int kGemmTile = 64;   // output rows and columns of one CTA
constexpr int kGemmDepth = 16;  // inner dimension staged per step
constexpr int kMaxSplit = 8;    // pieces of a split inner dimension
constexpr int kSplitDepth = 128;  // the least inner length of a piece

// Element (z, r, c) of an operand at p[z * sz + r * sr + c * sc] (z the
// batch element).
struct View {
  const float* p;
  long long sz, sr, sc;
};

// c(z, m, j) = [c(z, m, j) +] [add(z, m, j) +] acc * mul / div, with c's
// rows ldc floats apart and its elements zc apart
__device__ __forceinline__ void store_out(float* __restrict__ c, long long zc, int ldc, int z,
                                          int m, int j, float acc, float mul, float div,
                                          const View& add, int accumulate) {
  float v = acc * mul / div;
  if (add.p) v = add.p[z * add.sz + m * add.sr + j * add.sc] + v;
  float* o = c + z * zc + (long long)m * ldc + j;
  *o = accumulate ? *o + v : v;
}

// c(z, m, j) = [c +] [add +] (sum_i a(z, m, i) b(z, i, j)) * mul / div
// (store_out) for m < rows, j < cols. Each thread holds 4 x 4 outputs (rows
// ty + 16u, columns tx + 16v) and adds the inner terms in order. blockIdx.z
// = piece * batch + z: with `part`, piece p sums i in [p chunk, (p+1) chunk)
// into part[blockIdx.z][m][j] for gemm_reduce, else chunk >= inner.
__global__ void __launch_bounds__(kThreads)
tiled_gemm(View a, View b, View add, float* __restrict__ c, long long zc, int ldc, int rows,
           int cols, int inner, float mul, float div, int accumulate, int batch, int chunk,
           float* __restrict__ part) {
  __shared__ float as[kGemmDepth][kGemmTile + 1];
  __shared__ float bs[kGemmDepth][kGemmTile + 1];
  const int z = blockIdx.z % batch, m0 = blockIdx.y * kGemmTile, j0 = blockIdx.x * kGemmTile;
  const int i_begin = (blockIdx.z / batch) * chunk, i_end = min(inner, i_begin + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* ap = a.p + z * a.sz;
  const float* bp = b.p + z * b.sz;
  // stage along the operand's contiguous dimension where it has one
  const bool a_rows = a.sc == 1, b_rows = b.sc != 1 && b.sr == 1;
  float acc[4][4] = {};
  for (int i0 = i_begin; i0 < i_end; i0 += kGemmDepth) {
    for (int e = threadIdx.x; e < kGemmDepth * kGemmTile; e += kThreads) {
      int i = a_rows ? e % kGemmDepth : e / kGemmTile;
      int m = a_rows ? e / kGemmDepth : e % kGemmTile;
      as[i][m] = (m0 + m < rows && i0 + i < i_end)
                     ? ap[(m0 + m) * a.sr + (long long)(i0 + i) * a.sc] : 0.0f;
      i = b_rows ? e % kGemmDepth : e / kGemmTile;
      const int j = b_rows ? e / kGemmDepth : e % kGemmTile;
      bs[i][j] = (j0 + j < cols && i0 + i < i_end)
                     ? bp[(long long)(i0 + i) * b.sr + (j0 + j) * b.sc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGemmDepth; ++i) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = as[i][ty + 16 * u];
        bv[u] = bs[i][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + ty + 16 * u;
    if (m >= rows) break;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = j0 + tx + 16 * w;
      if (j >= cols) continue;
      if (part) {
        part[((long long)blockIdx.z * rows + m) * cols + j] = acc[u][w];
      } else {
        store_out(c, zc, ldc, z, m, j, acc[u][w], mul, div, add, accumulate);
      }
    }
  }
}

// The pieces of a split product added in order, then stored as tiled_gemm
// stores: one thread per output element.
__global__ void gemm_reduce(const float* __restrict__ part, int pieces, int batch, int rows,
                            int cols, View add, float* __restrict__ c, long long zc, int ldc,
                            float mul, float div, int accumulate) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long per = (long long)rows * cols;
  if (e >= batch * per) return;
  const int z = (int)(e / per);
  const long long rc = e - z * per;
  float acc = 0.0f;
  for (int p = 0; p < pieces; ++p) acc += part[((long long)p * batch + z) * per + rc];
  store_out(c, zc, ldc, z, (int)(rc / cols), (int)(rc % cols), acc, mul, div, add, accumulate);
}

// out[r] = sum_j x[r][j] for r < rows (rows of n), one warp a row, in the
// order of cluster_slot_sum's warp sums
__global__ void row_sum_kernel(const float* __restrict__ x, long long rows, int n,
                               float* __restrict__ out) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) acc += x[r * n + j];
  acc = warp_sum(acc);
  if (lane == 0) out[r] = acc;
}

// out[z] = sum_s vals[z][s], in the slots' order as cluster_slot_sum adds
// them: lane l adds slots l, l+32, ..., then the lanes; one warp an element
__global__ void slot_total_kernel(const float* __restrict__ vals, int s,
                                  float* __restrict__ out) {
  const float* v = vals + (size_t)blockIdx.x * s;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < s; i += 32) acc += v[i];
  acc = warp_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// attn = sigmoid(dots / rs * T) over (B, S, N)
__global__ void attn_kernel(const float* __restrict__ dots, const float* __restrict__ rs,
                            const float* __restrict__ total, int s, int n, long long count,
                            float* __restrict__ attn) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long row = i / n;
  attn[i] = sigmoid_f32(dots[i] / rs[row] * total[row / s]);
}

// The GRU's backward per (element, slot, j): gi, gh (B, S, 3d) hold the gate
// pre-activations with their biases and are overwritten with dgi and dgh; g
// is the cotangent of the slots leaving the iteration, h (rows hz apart per
// element) the slots entering it; dh = g z.
__global__ void gru_bwd_kernel(float* __restrict__ gi, float* __restrict__ gh,
                               const float* __restrict__ g, const float* __restrict__ h,
                               long long hz, int s, int d, long long count,
                               float* __restrict__ dh) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long row = i / d;
  const int j = (int)(i - row * d);
  float* gi_row = gi + row * 3 * d;
  float* gh_row = gh + row * 3 * d;
  const float rg = sigmoid_f32(gi_row[j] + gh_row[j]);
  const float zg = sigmoid_f32(gi_row[d + j] + gh_row[d + j]);
  const float hn = gh_row[2 * d + j];
  const float ng = tanhf(gi_row[2 * d + j] + rg * hn);
  const float gv = g[i], hv = h[(row / s) * hz + (row % s) * d + j];
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

// The element's db partials (at part + z * per_z + 6 d^2) += the column sums
// of dgi and dgh over its slots, one warp a column in cluster_slot_sum's
// order.
__global__ void bias_grad_kernel(const float* __restrict__ dgi, const float* __restrict__ dgh,
                                 int s, int d, float* __restrict__ part, size_t per_z) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int z = blockIdx.y;
  if (col >= 6 * d) return;
  const int m = col >= 3 * d, r = col - m * 3 * d;
  const float* dg = (m ? dgh : dgi) + (size_t)z * s * 3 * d;
  float acc = 0.0f;
  for (int i = lane; i < s; i += 32) acc += dg[(size_t)i * 3 * d + r];
  acc = warp_sum(acc);
  if (lane == 0) part[z * per_z + 6 * (size_t)d * d + col] += acc;
}

// Per row of P (one warp a row): G = P attn (1 - attn) in place of P,
// rg = sum_j G D and q = rg / rs.
__global__ void renorm_grad_kernel(float* __restrict__ p, const float* __restrict__ attn,
                                   const float* __restrict__ dots, const float* __restrict__ rs,
                                   long long rows, int n, float* __restrict__ rg,
                                   float* __restrict__ q) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const long long i = r * n + j;
    const float gv = p[i] * attn[i] * (1.0f - attn[i]);
    p[i] = gv;
    acc += gv * dots[i];
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    rg[r] = acc;
    q[r] = acc / rs[r];
  }
}

// dD = (T G / rs - T rg / rs^2 + sum_i rg_i / rs_i) * scale, in place of G
__global__ void ddots_kernel(float* __restrict__ p, const float* __restrict__ rs,
                             const float* __restrict__ rg, const float* __restrict__ total,
                             const float* __restrict__ qsum, int s, int n, long long count,
                             float scale) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long row = i / n, z = row / s;
  const float t = total[z], r = rs[row];
  p[i] = (t * p[i] / r - t * rg[row] / (r * r) + qsum[z]) * scale;
}

// The pieces of the split products: up to kMaxSplit of the largest output
// with the slots as its inner dimension, (3d, d) or (N, d), per element.
size_t split_floats(int batch, int n, int d) {
  return (size_t)kMaxSplit * batch * d * (3 * d > n ? 3 * d : n);
}

// The tiled route's scratch, in floats, after the batch's dW and db
// partials: g, dh, x, dx (B, S, d); gi, gh (B, S, 3d); dots, attn, P
// (B, S, N); rs, rg, q (B, S); T, sum q (B); the split products' pieces.
size_t tiled_floats(int batch, int n, int s, int d) {
  const size_t bs = (size_t)batch * s;
  return (size_t)batch * partial_floats(d) + bs * (4 * d + 6 * d + 3 * n + 3) + 2 * batch +
         split_floats(batch, n, d);
}

inline unsigned blocks(long long count) { return (unsigned)((count + kThreads - 1) / kThreads); }

// Launches tiled_gemm over the batch; where its output tiles fill less
// than two waves of `sms` CTAs and its inner dimension is long, it splits
// the inner dimension (into pieces of at least kSplitDepth, as many as fill
// two waves, at most kMaxSplit, that `part` holds) and adds the pieces
// with gemm_reduce.
struct Gemm {
  int batch, sms;
  float* part;
  size_t part_floats;
  cudaStream_t stream;

  int operator()(View a, View b, View add, float* c, long long zc, int ldc, int rows,
                 int cols, int inner, float mul, float div, bool accumulate) const {
    const int tiles =
        ((cols + kGemmTile - 1) / kGemmTile) * ((rows + kGemmTile - 1) / kGemmTile);
    int pieces = 1;
    if (tiles * batch < 2 * sms) {
      pieces = std::min({kMaxSplit, inner / kSplitDepth,
                         (2 * sms + tiles * batch - 1) / (tiles * batch)});
      if (pieces < 2 || (size_t)pieces * batch * rows * cols > part_floats) pieces = 1;
    }
    const int chunk = (inner + pieces - 1) / pieces;
    const dim3 grid((cols + kGemmTile - 1) / kGemmTile, (rows + kGemmTile - 1) / kGemmTile,
                    batch * pieces);
    tiled_gemm<<<grid, kThreads, 0, stream>>>(
        a, b, add, c, zc, ldc, rows, cols, inner, mul, div, (int)accumulate, batch,
        pieces > 1 ? (chunk + kGemmDepth - 1) / kGemmDepth * kGemmDepth : inner,
        pieces > 1 ? part : nullptr);
    if (pieces > 1) {
      gemm_reduce<<<blocks((long long)batch * rows * cols), kThreads, 0, stream>>>(
          part, pieces, batch, rows, cols, add, c, zc, ldc, mul, div, (int)accumulate);
    }
    return (int)cudaGetLastError();
  }
};

#define XSLOT_TRY(call)          \
  do {                           \
    const int err_ = (call);     \
    if (err_ != 0) return err_;  \
  } while (0)

// The tiled route: the same gradient as xslot_bwd_kernel + xslot_bwd_sum_kernel.
int tiled_bwd(const float* k, const float* v, const float* w_ih, const float* w_hh,
              const float* b_ih, const float* b_hh, const float* hist, const float* du,
              const float* dattn, float* dk, float* dv, float* d_init, float* dw_ih,
              float* dw_hh, float* db_ih, float* db_hh, float* scratch, int batch, int n,
              int s, int d, int iters, float scale, cudaStream_t stream) {
  const long long sd = (long long)s * d, sn = (long long)s * n, s3 = 3 * sd;
  const long long nd = (long long)n * d, rows = (long long)batch * s;
  const size_t per_z = partial_floats(d);
  float* partials = scratch;
  float* g = partials + batch * per_z;
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
  float* total = q + rows;
  float* qsum = total + batch;
  float* pieces = qsum + batch;
  int device = 0, sms = 0;
  XSLOT_TRY((int)cudaGetDevice(&device));
  XSLOT_TRY((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  XSLOT_TRY((int)cudaMemsetAsync(partials, 0, batch * per_z * sizeof(float), stream));
  XSLOT_TRY((int)cudaMemsetAsync(dk, 0, batch * nd * sizeof(float), stream));
  XSLOT_TRY((int)cudaMemsetAsync(dv, 0, batch * nd * sizeof(float), stream));

  const Gemm gemm{batch, sms, pieces, split_floats(batch, n, d), stream};
  const View none{nullptr, 0, 0, 0};
  const View kv{k, nd, d, 1}, kt{k, nd, 1, d}, vv{v, nd, d, 1}, vt{v, nd, 1, d};
  const View xv{x, sd, d, 1}, attn_v{attn, sn, n, 1}, attn_t{attn, sn, 1, n};
  const View p_v{p, sn, n, 1}, p_t{p, sn, 1, n};
  const View gi_v{gi, s3, 3 * d, 1}, gh_v{gh, s3, 3 * d, 1};
  const View gi_t{gi, s3, 1, 3 * d}, gh_t{gh, s3, 1, 3 * d};
  const int row_blocks = (int)((rows * 32 + kThreads - 1) / kThreads);
  for (int it = iters - 1; it >= 0; --it) {
    const bool last = it == iters - 1;
    const View hv{hist + it * sd, iters * sd, d, 1};
    // rebuild the iteration's forward from hist[:, it]
    XSLOT_TRY(gemm(hv, kt, none, dots, sn, n, s, n, d, scale, 1.0f, false));
    row_sum_kernel<<<row_blocks, kThreads, 0, stream>>>(dots, rows, n, rs);
    slot_total_kernel<<<batch, 32, 0, stream>>>(rs, s, total);
    attn_kernel<<<blocks(rows * n), kThreads, 0, stream>>>(dots, rs, total, s, n, rows * n,
                                                            attn);
    XSLOT_TRY(gemm(attn_v, vv, none, x, sd, d, s, d, n, 1.0f, (float)d, false));
    const float* dupd = du;
    if (!last) {
      // the GRU's gates again, and its backward for cotangent g
      XSLOT_TRY(gemm(xv, View{w_ih, 0, 1, d}, View{b_ih, 0, 0, 1}, gi, s3, 3 * d, s, 3 * d, d,
                     1.0f, 1.0f, false));
      XSLOT_TRY(gemm(hv, View{w_hh, 0, 1, d}, View{b_hh, 0, 0, 1}, gh, s3, 3 * d, s, 3 * d, d,
                     1.0f, 1.0f, false));
      gru_bwd_kernel<<<blocks(rows * d), kThreads, 0, stream>>>(gi, gh, g, hist + it * sd,
                                                                iters * sd, s, d, rows * d, dh);
      XSLOT_TRY(gemm(gi_v, View{w_ih, 0, d, 1}, none, dx, sd, d, s, d, 3 * d, 1.0f, 1.0f,
                     false));
      XSLOT_TRY(gemm(gh_v, View{w_hh, 0, d, 1}, none, dh, sd, d, s, d, 3 * d, 1.0f, 1.0f,
                     true));
      XSLOT_TRY(gemm(gi_t, xv, none, partials, per_z, d, 3 * d, d, s, 1.0f, 1.0f, true));
      XSLOT_TRY(gemm(gh_t, hv, none, partials + 3 * d * d, per_z, d, 3 * d, d, s, 1.0f, 1.0f,
                     true));
      bias_grad_kernel<<<dim3((6 * d * 32 + kThreads - 1) / kThreads, batch), kThreads, 0,
                         stream>>>(gi, gh, s, d, partials, per_z);
      dupd = dx;
    }
    // attention: dattn_tot, dv, G, the renorm's gradient, dh and dk
    const View dupd_v{dupd, sd, d, 1};
    XSLOT_TRY(gemm(dupd_v, vt, last ? View{dattn, sn, n, 1} : none, p, sn, n, s, n, d, 1.0f,
                   (float)d, false));
    XSLOT_TRY(gemm(attn_t, dupd_v, none, dv, nd, d, n, d, s, 1.0f, (float)d, true));
    renorm_grad_kernel<<<row_blocks, kThreads, 0, stream>>>(p, attn, dots, rs, rows, n, rg, q);
    slot_total_kernel<<<batch, 32, 0, stream>>>(q, s, qsum);
    ddots_kernel<<<blocks(rows * n), kThreads, 0, stream>>>(p, rs, rg, total, qsum, s, n,
                                                             rows * n, scale);
    XSLOT_TRY(gemm(p_v, kv, none, dh, sd, d, s, d, n, 1.0f, 1.0f, !last));
    XSLOT_TRY(gemm(p_t, hv, none, dk, nd, d, n, d, s, 1.0f, 1.0f, true));
    float* t = g;
    g = dh;
    dh = t;
  }
  const int sums = (int)per_z + (int)sd;
  xslot_bwd_sum_kernel<<<(sums + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, batch, g, batch, (int)sd, d, dw_ih, dw_hh, db_ih, db_hh, d_init);
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
// for the tiled route (cluster == 0) tiled_floats.
size_t xslot_bwd_scratch_floats(int batch, int n, int s, int d, int cluster) {
  if (cluster == 0) return tiled_floats(batch, n, s, d);
  return (size_t)batch * cluster * partial_floats(d) + (size_t)batch * s * d;
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
