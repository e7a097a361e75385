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
// bits from run to run.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

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

  const int nq = d >> 2, chunk = 2 * (kThreads / nq);
  const int q = threadIdx.x % nq, pair = threadIdx.x / nq;
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
      for (int base = 0; base < sl; base += chunk) {
        const int sa = base + 2 * pair;
        GruAcc acc;
        gru_products(acc, x, h, sa, q, sa < sl, tiles, w_ih, w_hh, d, false);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int si = sa + r;
          if (si >= sl) break;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = gru_col(q, u, d);
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

// Floats of the scratch buffer xslot_bwd needs: the per-CTA partials, then
// the elements' d_slots0 rows.
size_t xslot_bwd_scratch_floats(int batch, int s, int d, int cluster) {
  return (size_t)batch * cluster * partial_floats(d) + (size_t)batch * s * d;
}

// Launches the gradient kernel (`cluster` CTAs per batch element) and the
// fixed-order sum on `stream`; returns 0 or the error. Pointers are contiguous
// f32 device arrays: k, v (B,N,d); w_ih, w_hh (3d,d); b_ih, b_hh (3d); hist
// (B,iters,S,d); du (B,S,d); dattn (B,S,N); outputs dk, dv (B,N,d), d_init
// (S,d), dw_ih, dw_hh (3d,d), db_ih, db_hh (3d); scratch of
// xslot_bwd_scratch_floats floats.
int xslot_bwd(const void* k, const void* v, const void* w_ih, const void* w_hh,
              const void* b_ih, const void* b_hh, const void* hist, const void* du,
              const void* dattn, void* dk, void* dv, void* d_init, void* dw_ih, void* dw_hh,
              void* db_ih, void* db_hh, void* scratch, int batch, int n, int s, int d, int iters,
              float scale, int cluster, void* stream) {
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
