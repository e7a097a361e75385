// Forward of the fused xSlot loop past a cluster's reach, for Hopper
// (sm_90a): f32 arithmetic, inputs in f32 or bf16 (converted once, exactly),
// outputs in f32.
//
// Replaces the Pallas TPU kernel scouter_tpu/ops/slot_pallas.py::_fused_forward
// (pallas_call :107, body _kernel :42-81) at the shapes where xslot_fwd.cu's
// cluster kernel cannot run: each of its CTAs keeps all of k and v in shared
// memory, so no cluster of 8 holds an element at N=784 (output stride 8 at
// 224 px, S=30) or at N=196 with S=1000 (the CUB recipe at 448 px). The
// wrapper (ops/slot_kernel.py::_plan) takes this route only there, by shape;
// it never stands in for a cluster launch that failed.
//
// It computes what xslot_fwd.cu computes, in _kernel's order: for each
// iteration
//     dots  = slots . k^T * d^-1/2
//     attn  = sigmoid(dots / rowsum(dots) * sum(dots))   (no epsilon)
//     upd   = attn . v / d
//     slots = GRU(upd, slots)                             (skipped at the last)
// as a chain of launches over the whole batch, each iteration's
// intermediates in device memory: the dots product (its row sums in its
// epilogue where one tile spans a row, N <= 128, else a row pass, in f64),
// the attention pass (each element's total from its row sums in a fixed
// order), the update product (written straight to upd), the GRU's two
// products in one launch (biases added in the epilogue) and a gate pass that
// writes the next slots, into hist[:, it+1] when hist is asked for (hist[:,
// 0] is copied from the initial slots first). attn and upd are overwritten
// each iteration; the last one's stay. No float atomics: the same bits from
// call to call.
//
// What bounds it: the products, per element 3 x two (S,N,d) products and 2 x
// two (S,d)x(d,3d): 3.98 GFLOP at (16, 196, 1000), 0.059 ms at the card's f32
// rate; 1.47 GFLOP at (70, 784, 30), 0.022 ms. The intermediates (dots and
// attn, 12.5 MB an iteration at (16, 196, 1000)) mostly stay in L2.
// What the design does about it: the products run on the backward's
// tile_gemm (xslot_tiled.cuh), whose CTA tiles fold the batch into rows for
// the GRU (its weights are shared) and cover (S, N) per element for the
// attention; the passes are one read and one write each. A first version,
// right before fast: no fusion of the attention pass into the products.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (scouter_tpu_torch/ops/cuda_build.py).

#include <type_traits>

#include "xslot_common.cuh"
#include "xslot_tiled.cuh"

namespace {

enum { kFDots, kFX, kFGates, kFProducts };

// The route's plan at (batch, N, S, d) on a card of `sms` SMs: its products
// (dots, x, gi|gh), whether the row sums ride in the dots' epilogue and the
// scratch in floats.
struct FwdPlan {
  ProductPlan prod[kFProducts];
  bool fused;
  size_t scratch;
};

inline size_t up4(size_t x) { return (x + 3) & ~(size_t)3; }

// scratch: dots (B, S, N); rs (B, S); gi, gh (B, S, 3d); without hist the
// slots of two iterations (B, S, d) each; with bf16 inputs their f32 copies
// (k, v, slots0, W_ih, W_hh, b_ih, b_hh); each buffer from a multiple of 4
// floats
inline FwdPlan fwd_plan(int batch, int n, int s, int d, int sms, bool hist, bool bf16) {
  FwdPlan t;
  const size_t bs = (size_t)batch * s, bnd = (size_t)batch * n * d;
  t.prod[kFDots] = plan_product(s, n, d, batch, 1, false, sms);
  t.prod[kFX] = plan_product(s, d, n, batch, 1, false, sms);
  t.prod[kFGates] = plan_product((int)bs, 3 * d, d, 1, 2, false, sms);
  t.fused = n <= t.prod[kFDots].bn;
  t.scratch = up4(bs * n) + up4(bs) + 2 * bs * 3 * d + (hist ? 0 : 2 * bs * d) +
              (bf16 ? 2 * bnd + (size_t)s * d + 6 * (size_t)d * d + 6 * (size_t)d : 0);
  return t;
}

// hist[z, 0] = slots0 for every element z (hist rows hz floats apart)
__global__ void hist0_kernel(const float* __restrict__ slots0, float* __restrict__ hist,
                             long long hz, int sd, long long count) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long z = i / sd;
  hist[z * hz + (i - z * sd)] = slots0[i - z * sd];
}

// The GRU's gates per (element, slot, j): gi, gh (B*S, 3d) hold x W_ih^T +
// b_ih and h W_hh^T + b_hh; the next slots (1 - z) n + z h go to out (rows
// oz apart per element), h read from rows hz apart (0: the initial slots,
// shared). The cluster kernel's formula and order (xslot_fwd.cu).
__global__ void gru_fwd_kernel(const float* __restrict__ gi, const float* __restrict__ gh,
                               const float* __restrict__ h, long long hz,
                               float* __restrict__ out, long long oz, int s, int d, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int row = i / d, j = i - row * d, zi = row / s, r = row - zi * s;
  const float* gi_row = gi + (size_t)row * 3 * d;
  const float* gh_row = gh + (size_t)row * 3 * d;
  const float rg = sigmoid_f32(gi_row[j] + gh_row[j]);
  const float zg = sigmoid_f32(gi_row[d + j] + gh_row[d + j]);
  const float ng = tanhf(gi_row[2 * d + j] + rg * gh_row[2 * d + j]);
  const float hv = h[zi * hz + (long long)r * d + j];
  out[zi * oz + (long long)r * d + j] = (1.0f - zg) * ng + zg * hv;
}

template <typename T>
int tiled_fwd(const T* k_in, const T* v_in, const T* slots0_in, const T* w_ih_in,
              const T* w_hh_in, const T* b_ih_in, const T* b_hh_in, float* upd, float* attn,
              float* hist, float* scratch, int batch, int n, int s, int d, int iters,
              float scale, cudaStream_t stream) {
  constexpr bool bf16 = !std::is_same<T, float>::value;
  int sms = 0;
  XSLOT_TRY(device_sms(&sms));
  const FwdPlan plan = fwd_plan(batch, n, s, d, sms, hist != nullptr, bf16);
  const long long sd = (long long)s * d, sn = (long long)s * n, s3 = 3 * sd;
  const long long nd = (long long)n * d, rows = (long long)batch * s, bnd = batch * nd;
  float* dots = scratch;
  float* rs = dots + up4(rows * n);
  float* gi = rs + up4(rows);
  float* gh = gi + rows * 3 * d;
  float* ring = gh + rows * 3 * d;  // the slots of two iterations, without hist
  float* f = ring + (hist ? 0 : 2 * rows * d);
  const float *k, *v, *slots0, *w_ih, *w_hh, *b_ih, *b_hh;
  if constexpr (bf16) {
    const long long dd = 3LL * d * d;
    const __nv_bfloat16* src[7] = {k_in, v_in, slots0_in, w_ih_in, w_hh_in, b_ih_in, b_hh_in};
    const long long sizes[7] = {bnd, bnd, sd, dd, dd, 3LL * d, 3LL * d};
    launch_to_f32(src, sizes, 7, f, stream);
    k = f;
    v = k + bnd;
    slots0 = v + bnd;
    w_ih = slots0 + sd;
    w_hh = w_ih + dd;
    b_ih = w_hh + dd;
    b_hh = b_ih + 3 * d;
  } else {
    k = k_in;
    v = v_in;
    slots0 = slots0_in;
    w_ih = w_ih_in;
    w_hh = w_hh_in;
    b_ih = b_ih_in;
    b_hh = b_hh_in;
  }
  if (hist != nullptr) {
    hist0_kernel<<<blocks(rows * d), kThreads, 0, stream>>>(slots0, hist, iters * sd, (int)sd,
                                                             rows * d);
  }

  const Renorm no_renorm{nullptr, nullptr, nullptr, nullptr, nullptr};
  const int row_blocks = (int)((rows * 32 + kThreads - 1) / kThreads);
  const dim3 pass_grid(ceil_div(sn, (long long)kThreads * kBatch), batch);
  const float* h = slots0;  // the slots entering the iteration, rows hz apart an element
  long long hz = 0;
  for (int it = 0; it < iters; ++it) {
    const View hv{h, hz, d, 1};
    Prod dots_p = prod(hv, View{k, nd, 1, d}, dots, sn, n, scale);
    dots_p.rowout = rs;
    dots_p.rz = s;
    XSLOT_TRY(gemm(plan.prod[kFDots], dots_p, nullptr, n, d, s, batch,
                   plan.fused ? kRowSum : kStore, no_renorm, stream));
    if (!plan.fused) row_sum_kernel<<<row_blocks, kThreads, 0, stream>>>(dots, rows, n, rs);
    attn_kernel<<<pass_grid, kThreads, 0, stream>>>(dots, rs, s, n, attn);
    XSLOT_TRY(gemm(plan.prod[kFX], prod(View{attn, sn, n, 1}, View{v, nd, d, 1}, upd, sd, d,
                                        1.0f, (float)d),
                   nullptr, d, n, s, batch, kStore, no_renorm, stream));
    if (it + 1 == iters) break;
    Prod gi_p = prod(View{upd, sd, d, 1}, View{w_ih, 0, 1, d}, gi, s3, 3 * d);
    Prod gh_p = prod(hv, View{w_hh, 0, 1, d}, gh, s3, 3 * d);
    gi_p.add = View{b_ih, 0, 0, 1};
    gh_p.add = View{b_hh, 0, 0, 1};
    XSLOT_TRY(gemm(plan.prod[kFGates], gi_p, &gh_p, 3 * d, d, s, 1, kStore, no_renorm, stream));
    float* next = hist ? hist + (it + 1) * sd : ring + (it & 1) * rows * d;
    const long long nz = hist ? iters * sd : sd;
    gru_fwd_kernel<<<blocks(rows * d), kThreads, 0, stream>>>(gi, gh, h, hz, next, nz, s, d,
                                                              (int)(rows * d));
    h = next;
    hz = nz;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the scratch buffer xslot_fwd_tiled needs at (batch, N, S, d) on
// the current device, with or without hist, for f32 or bf16 inputs (0 if
// the device cannot be read, where the route itself fails).
size_t xslot_fwd_tiled_scratch_floats(int batch, int n, int s, int d, int hist, int bf16) {
  int sms = 0;
  return device_sms(&sms) == 0 ? fwd_plan(batch, n, s, d, sms, hist != 0, bf16 != 0).scratch
                               : 0;
}

// The route's plan at (batch, N, S, d) on the current device: for each
// product (dots, x, gi|gh) its rows, CTA tile width and inner pieces at
// out[3p], out[3p+1], out[3p+2]; returns 0 or a negative CUDA error.
int xslot_fwd_tiled_plan(int batch, int n, int s, int d, int* out) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return -err;
  const FwdPlan t = fwd_plan(batch, n, s, d, sms, false, false);
  for (int i = 0; i < kFProducts; ++i) {
    out[3 * i] = t.prod[i].rows;
    out[3 * i + 1] = t.prod[i].bn;
    out[3 * i + 2] = t.prod[i].pieces;
  }
  return 0;
}

// Launches the route on `stream`; returns 0 or the error. Pointers are
// contiguous device arrays: k, v (B,N,d); slots0 (S,d); w_ih, w_hh (3d,d);
// b_ih, b_hh (3d), all f32 (bf16 == 0) or all bf16 (bf16 == 1); upd
// (B,S,d), attn (B,S,N) and hist (B,iters,S,d) or nullptr, f32; scratch of
// xslot_fwd_tiled_scratch_floats floats, 16-byte aligned. d % 4 == 0.
int xslot_fwd_tiled(const void* k, const void* v, const void* slots0, const void* w_ih,
                    const void* w_hh, const void* b_ih, const void* b_hh, void* upd, void* attn,
                    void* hist, void* scratch, int batch, int n, int s, int d, int iters,
                    float scale, int bf16, void* stream) {
  using bf = __nv_bfloat16;
  if (bf16) {
    return tiled_fwd((const bf*)k, (const bf*)v, (const bf*)slots0, (const bf*)w_ih,
                     (const bf*)w_hh, (const bf*)b_ih, (const bf*)b_hh, (float*)upd,
                     (float*)attn, (float*)hist, (float*)scratch, batch, n, s, d, iters, scale,
                     (cudaStream_t)stream);
  }
  return tiled_fwd((const float*)k, (const float*)v, (const float*)slots0, (const float*)w_ih,
                   (const float*)w_hh, (const float*)b_ih, (const float*)b_hh, (float*)upd,
                   (float*)attn, (float*)hist, (float*)scratch, batch, n, s, d, iters, scale,
                   (cudaStream_t)stream);
}

}  // extern "C"
