// The building blocks of K1's backward on its tiled route (xslot_bwd.cu),
// for Hopper (sm_90a), f32 arithmetic throughout.
//
// - tile_gemm, a register-tiled SIMT product over the batch: a CTA of 256
//   threads computes a 128 x BN tile (BN 64 or 128, tile_cols picks per
//   product), each thread 8 x BN/16 outputs, both operands staged k-major in
//   shared memory, 16 inner terms a stage, two stages deep. Its epilogue
//   scales by mul / div, adds an optional broadcast operand, and can add each
//   output row in f64 (the renorm's row sums). Every output element adds its
//   terms in a fixed order in f32 FMA: no float atomics, no TF32.
// - plan_product picks a product's tile width and the pieces its inner
//   dimension splits into; gemm launches one product, or two of one shape.
// - row_sum_kernel and attn_kernel: the renorm's row sums (in f64) and
//   attn = sigmoid(dots / rs * T), T each element's total in a fixed order.
//
// Included after xslot_common.cuh, inside nothing: its definitions live in
// an anonymous namespace, one copy per library.

#pragma once

#include <algorithm>

#include "xslot_common.cuh"

namespace {

using namespace xslot;

// warp_sum in f64, for the renorm's row sums
__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// bf16 inputs to f32 in one pass, four elements a thread: up to
// kMaxSegments arrays (each a multiple of 4 elements, 8-byte aligned) one
// after another into `out` (16-byte aligned); end[q] is where segment q
// ends, count the segments used.
constexpr int kMaxSegments = 7;

struct Segments {
  const __nv_bfloat16* src[kMaxSegments];
  long long end[kMaxSegments];
  int count;
};

__global__ void to_f32_kernel(Segments in, float* __restrict__ out) {
  const long long e = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  long long begin = 0;
#pragma unroll
  for (int q = 0; q < kMaxSegments; ++q) {
    if (q < in.count && e < in.end[q]) {
      *reinterpret_cast<float4*>(out + e) = load4(in.src[q] + (e - begin));
      return;
    }
    begin = in.end[q];
  }
}

// Launches to_f32_kernel over `count` arrays of `sizes[q]` elements each.
inline void launch_to_f32(const __nv_bfloat16* const* src, const long long* sizes, int count,
                          float* out, cudaStream_t stream) {
  Segments in{};
  long long at = 0;
  for (int q = 0; q < count; ++q) {
    in.src[q] = src[q];
    in.end[q] = at += sizes[q];
  }
  in.count = count;
  to_f32_kernel<<<blocks(at / 4), kThreads, 0, stream>>>(in, out);
}

}  // namespace
